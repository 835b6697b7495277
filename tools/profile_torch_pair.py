"""Device-time breakdown of one octane_tpu_torch pair solve on a CUDA card.

    python3 tools/profile_torch_pair.py [--size 5424] [--kiters 4] [--solver pcg|sor]
                                        [--route graph|eager] [--hybrid] [--mesh RxC]
                                        [--cards N] [--replays N] [--host-first]

Runs the bench.py synthetic pair through ``variational_flow``, which
replays the pair's captured CUDA graph (``--route eager``: the eager
kernel route, ``flow.variational._coarse_to_fine``; the profiler sees the
kernels of a replay one by one, so the breakdown holds for both) (with
``--mesh RxC``: on R*C row bands of cuda:0 through
``parallel.sharded.sharded_variational_flow``, which replays the banded
program's graph, or the eager banded route with ``--route eager``; with
``--cards N``: on a (1, N) mesh with band i on cuda:i, the banded program
captured across the cards, and every card's busy time, idle share and
waits apart) (with ``--hybrid``: ``patch_match_flow``, then ``variational_flow`` from its flow,
as compute_flow's "hybrid" does; patch-match is also profiled alone) once
to warm up, once timed without the profiler (wall clock, CUDA events around
it) and once under ``torch.profiler``.  Prints both wall times, the peak device
memory, the summed device time and the device's idle share, 1 - device
busy / unprofiled wall (the profiler's own host cost would inflate a wall
taken under it), and the device time by kernel grouped into the port's
layers (warp, PCG passes, the fused assembly in its SOR and PCG layouts,
SOR passes, the scalar glue and other elementwise work, shifts/gathers,
reductions, matmuls, the graph's IF-node conditions).  Writes the summary and (on
one card) the chrome trace to chiprun_out/profile_pair_<solver>_<route>.{txt,json}.
With ``--mesh`` the files are named profile_mesh<R>x<C>_<solver>_<route>,
with ``--cards`` profile_cards<N>_<solver>_<route>.
"""

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from octane_tpu_torch import ops  # noqa: E402
from octane_tpu_torch.config import OFConfig  # noqa: E402
from octane_tpu_torch.flow.patch_match import patch_match_flow  # noqa: E402
from octane_tpu_torch.flow.variational import _coarse_to_fine, variational_flow  # noqa: E402
from octane_tpu_torch.parallel import (LocalExchange, make_mesh,  # noqa: E402
                                       sharded_variational_flow)
from octane_tpu_torch.parallel import sharded  # noqa: E402
from octane_tpu_torch.parallel.sharded import _coarse_to_fine_banded  # noqa: E402
from chip_smoke import load_tests_module  # noqa: E402

GROUPS = (("warp_bilinear", "warp kernel"), ("warp_band", "warp kernel (band form)"),
          ("pcg_pass_a", "PCG pass A"),
          ("pcg_pass_b", "PCG pass B"), ("assemble_cf", "fused assembly kernel"),
          ("assemble_pcg", "PCG assembly kernel"),
          ("sor_pass", "SOR pass kernel"), ("gemm", "matmul (zoom)"),
          ("index", "index_select (shifts, subsample)"),
          ("reduce", "reductions (sums)"), ("elementwise", "elementwise"),
          ("copy", "copies / cat / stack"), ("fill", "fills"),
          ("set_if", "graph IF-node conditions"))


def group(name):
    low = name.lower()
    for key, label in GROUPS:
        if key in low:
            return label
    if "cat" in low or "memcpy" in low:
        return "copies / cat / stack"
    return "other"


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def wait_group(name):
    """What a card starts when a wait on it ends: a copy between cards, a
    copy on the card, or a kernel's layer (``group``)."""
    low = name.lower()
    if "ptop" in low:
        return "a copy between cards"
    if "memcpy" in low or "memset" in low:
        return "a copy on the card"
    return group(name)


def card_waits(events):
    """Per card {index: (span ms, busy ms, {what ends a wait: ms})} from the
    profiler's device events of one run: the span runs from the first
    launch on any card to the last end on any; busy is the union of the
    card's event intervals; each gap in it is put down to what the card
    starts when the gap ends (before its first event: "start", after its
    last: "end, the other cards still running")."""
    by_card = defaultdict(list)
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_card[ev.device_index].append((ev.time_range.start, ev.time_range.end, ev.name))
    if not by_card:
        return {}
    t0 = min(s for evs in by_card.values() for s, _, _ in evs)
    t1 = max(e for evs in by_card.values() for _, e, _ in evs)
    out = {}
    for i, evs in sorted(by_card.items()):
        evs.sort()
        waits, busy, reach = defaultdict(float), 0.0, t0
        for s, e, name in evs:
            if s > reach:
                waits["start" if reach == t0 else wait_group(name)] += (s - reach) / 1e3
            busy += max(0.0, e - max(s, reach)) / 1e3
            reach = max(reach, e)
        if t1 > reach:
            waits["end, the other cards still running"] += (t1 - reach) / 1e3
        out[i] = ((t1 - t0) / 1e3, busy, dict(waits))
    return out


def profile(run, label, trace, replays=0, host_first=False):
    """Two warm-ups (a flow program's first call runs eagerly, its second
    captures), a run timed without the profiler, ``replays`` more runs
    each held torch.equal to it, with ``host_first`` a run under the
    profiler tracing the host only, then a run under it tracing the
    devices too; prints each step as it ends, the breakdown (and, where
    the device time lies on several cards, each card's busy time, idle
    share and waits by what ends them: ``card_waits``) and writes the
    chrome trace."""
    run()
    run()
    sync_all()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    first = run()
    end.record()
    sync_all()
    wall = (time.perf_counter() - t0) * 1e3
    event_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: timed run {wall:.1f} ms", flush=True)
    for k in range(replays):
        again = run()
        sync_all()
        equal = all(torch.equal(a, b) for a, b in zip(first, again))
        print(f"{label}: run {k + 1} of {replays} after it, torch.equal to it {equal}",
              flush=True)
    if host_first:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            run()
            sync_all()
        print(f"{label}: a run under the profiler tracing the host only ended", flush=True)
    ops.reset_counters()
    sharded.guard_reads.reads = 0
    print(f"{label}: a run under the profiler tracing the devices too begins", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        sync_all()
        wall_prof = (time.perf_counter() - t0) * 1e3
    by_card = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_card[ev.device_index] += ev.time_range.elapsed_us() / 1e3
    by_group = defaultdict(float)
    counts = defaultdict(int)
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            by_group[group(ev.key)] += dt / 1e3
            counts[group(ev.key)] += ev.count
    busy = sum(by_group.values())
    share = (f"idle share {1 - busy / wall:.4f} of the unprofiled wall" if len(by_card) <= 1
             else f"summed over {len(by_card)} cards (each card's below)")
    lines = [f"{label}: wall {wall:.1f} ms without "
             f"the profiler (CUDA events {event_ms:.1f} ms, peak {peak:.2f} GiB), "
             f"{wall_prof:.1f} ms under it; device "
             f"busy {busy:.1f} ms, {share}; counters {ops.counters()}, banded reach reads "
             f"{sharded.guard_reads.reads}"]
    if len(by_card) > 1:
        lines.append("  per card: " + ", ".join(
            f"cuda:{i} busy {ms:.1f} ms, idle share {1 - ms / wall:.4f}"
            for i, ms in sorted(by_card.items())))
        for i, (span, busy_i, waits) in card_waits(prof.events()).items():
            lines.append(f"  cuda:{i} under the profiler: span {span:.1f} ms, busy {busy_i:.1f} "
                         f"ms, waits ending in: " + ", ".join(
                             f"{k} {ms:.1f} ms" for k, ms in
                             sorted(waits.items(), key=lambda kv: -kv[1])))
    for name, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:36s} {ms:9.2f} ms  {ms / wall:6.1%} of wall  "
                     f"({counts[name]} launches)")
    print("\n".join(lines))
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"profile_{trace}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if len(by_card) <= 1:         # a trace of every card's launches outgrows the copy back
        prof.export_chrome_trace(os.path.join(out, f"profile_{trace}.json"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=5424)
    ap.add_argument("--kiters", type=int, default=4)
    ap.add_argument("--solver", choices=("pcg", "sor"), default="pcg")
    ap.add_argument("--route", choices=("graph", "eager"), default="graph",
                    help="the captured pair (variational_flow) or the eager kernel route")
    ap.add_argument("--hybrid", action="store_true",
                    help="patch-match initialization, then the variational refinement")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="the banded pair on R*C row bands of cuda:0 (-mesh RxC)")
    ap.add_argument("--cards", type=int, default=None, metavar="N",
                    help="the banded pair on a (1, N) mesh, band i on cuda:i")
    ap.add_argument("--replays", type=int, default=0, metavar="N",
                    help="N more runs after the timed one, each held torch.equal to it")
    ap.add_argument("--host-first", action="store_true",
                    help="a run under the profiler tracing the host only, before the full one")
    a = ap.parse_args()
    if (a.mesh or a.cards) and a.hybrid:
        ap.error("--mesh and --cards profile the variational pair only")
    if a.mesh and a.cards:
        ap.error("--mesh or --cards, not both")
    if not torch.cuda.is_available():
        print("profile_torch_pair: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    h = w = a.size
    im1, im2 = load_tests_module("torch_fixtures").bench_pair(h, w)
    g1 = torch.from_numpy(im1[None]).to(dev)
    g2 = torch.from_numpy(im2[None]).to(dev)
    z = torch.zeros((h, w), device=dev)
    cfg = OFConfig(kiters=a.kiters, solver=a.solver)
    flow = variational_flow if a.route == "graph" else _coarse_to_fine
    trace = f"pair_{a.solver}_{a.route}"
    label = f"{h}x{w} kiters={a.kiters} solver={a.solver} route={a.route}"
    if a.mesh or a.cards:
        if a.mesh:
            ry, rx = (int(k) for k in a.mesh.lower().split("x"))
            mesh = make_mesh((ry, rx), [dev] * (ry * rx))
        else:
            ry, rx = 1, a.cards
            mesh = make_mesh((1, a.cards), [torch.device("cuda", i) for i in range(a.cards)])
        if a.route == "graph":
            flow = lambda *args: sharded_variational_flow(*args, mesh)     # noqa: E731
        else:
            flow = lambda *args: _coarse_to_fine_banded(*args, mesh,       # noqa: E731
                                                        LocalExchange())
        trace = (f"cards{a.cards}" if a.cards else f"mesh{ry}x{rx}") + f"_{a.solver}_{a.route}"
        label += (f" mesh=(1, {a.cards}), band i on cuda:i" if a.cards
                  else f" mesh=({ry}, {rx}) of {dev}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if not a.hybrid:
        profile(lambda: flow(g1, g2, z, z, cfg), label, trace, a.replays, a.host_first)
        return 0

    def patch_match():
        return patch_match_flow(g1[0], g2[0], None, None, cfg.rad, cfg.srad)

    profile(patch_match, f"{h}x{w} patch_match_flow rad={cfg.rad} srad={cfg.srad}",
            "patch_match")
    profile(lambda: flow(g1, g2, *patch_match(), cfg), label + " hybrid",
            f"hybrid_{a.solver}_{a.route}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
