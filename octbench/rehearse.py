"""Rehearsals of configurations with no cell in BENCHMARK.json: the band-2
full disk on four cards, the draft configuration ``rehearsal/goes-fd-b2.json``
(21696 x 21696 at 0.5 km, ``mesh_shape`` [4, 1]) under the draft traffic
``rehearsal/fd-b2-stream.json``; and the hybrid full disk on one card, the
draft configuration ``rehearsal/goes-fd-b13-hybrid.json`` under fd-pcg's
traffic.

    python3 -m octbench.rehearse --part <part> --seed <n> [--seconds <s>] [--control 1]

One part a process (run each under ``timeout``; SIGTERM prints every
thread's stack on standard error):

* ``stream``: the draft's scans made on one card (seconds, the card's
  peak, host bytes), then the plain reference of the stream's first pair
  on the same card (ingest, solve and winds: seconds and peak, counted
  from a reset after the stream);
* ``mesh``: a traced run (``run.run``, ``--trace 1``) of fd-pcg's
  configuration with ``mesh_shape`` [4, 1], one band a card;
* ``b2``: an untraced run of the draft on four cards;
* ``hybrid``: a traced run (``run.run``, ``--trace 1``) of the hybrid
  draft under ``fd-stream-pcg``, judged against fd-pcg's limits (with
  ``--control 1`` the control's numbers too), where the largest flow gaps
  lie, then the port's ``patch_match_flow`` on the stream's first pair
  under the profiler inside a range of its own: its device ms a call, read
  by ``trace.device_us_in``, against ``roofline.patch_match_bound_s``.

Each prints one JSON line; a part that raises prints its error and the
last frames of its traceback in that line (the whole traceback on
standard error), and exits 1.  Exits 2 without
the cards the part needs.
"""

import faulthandler
import json
import os
import signal
import sys
import time
import traceback

T0 = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
PARTS = {"stream": 1, "mesh": 4, "b2": 4, "hybrid": 1}
PM_RANGE = "octbench.rehearse.patch_match"     # the range around the port's patch-match


def draft_cell(chips: int = 4):
    """The draft band-2 cell, its limits fd-pcg's (no limit of its own yet)."""
    from octbench import spec

    fd = spec.cell("fd-pcg")
    return spec.Cell(name="fd-b2-mesh4", chips=chips,
                     config=spec.load_json(os.path.join(HERE, "rehearsal", "goes-fd-b2.json")),
                     traffic=spec.load_json(os.path.join(HERE, "rehearsal", "fd-b2-stream.json")),
                     limits=fd.limits, end_to_end=fd.end_to_end, per_layer=fd.per_layer)


def _stream(seed: int) -> dict:
    import torch

    from octbench import grid, reference, traffic

    dev = torch.device("cuda", 0)
    cell = draft_cell(1)
    cfg = cell.config
    t0 = time.perf_counter()
    st = traffic.make_stream(cfg, cell.traffic, seed, dev)
    torch.cuda.synchronize(dev)
    out = {"stream_s": time.perf_counter() - t0,
           "stream_peak_bytes": torch.cuda.max_memory_allocated(dev),
           "host_bytes": sum(f.nbytes for loop in st.frames for f in loop),
           "max_px": st.max_px}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    nav = grid.nav_constants(cfg)
    t0 = time.perf_counter()
    s, i = st.pairs[0]
    d1 = reference.normalised(st.frames[s][i], nav, cfg["norm_min"], cfg["norm_max"], dev)
    d2 = reference.normalised(st.frames[s][i + 1], nav, cfg["norm_min"], cfg["norm_max"], dev)
    zero = torch.zeros_like(d1)
    u, v, work = reference.solve(d1[None], d2[None], zero, zero, cfg["settings"],
                                 cell.traffic["solver"], acc=reference.REFERENCE.accumulate)
    products = reference.winds(u, v, nav, st.times[s][i + 1] - st.times[s][i])
    torch.cuda.synchronize(dev)
    out.update(reference_s=time.perf_counter() - t0,
               reference_peak_bytes=torch.cuda.max_memory_allocated(dev),
               reference_work=work, flow_max_px=float(torch.sqrt(u * u + v * v).max()),
               nonzero_winds=int((products[0] != 0).sum()))
    return out


def _traced_run(cell, seed: int, seconds: float, control=None):
    """``run.run`` with ``--trace 1``: its result, numbers and control's
    numbers, and the run record that its metric readers read."""
    from octbench import run, spec

    runs, reader = [], spec.metric_reader

    def keep(name):
        read = reader(name)

        def wrapped(r):
            runs.append(r)
            return read(r)
        return wrapped
    spec.metric_reader = keep
    try:
        out, numbers, control_numbers = run.run(cell, seed, seconds, True, "cuda", t_start=T0,
                                                control=control)
    finally:
        spec.metric_reader = reader
    return out, numbers, control_numbers, runs[0]


def _mesh(seed: int, seconds: float) -> dict:
    from octbench import spec, trace

    cell = spec.cell("fd-pcg")
    cell.name, cell.chips = "fd-pcg-mesh4", 4
    cell.config["settings"]["mesh_shape"] = [4, 1]
    out, _, _, rec = _traced_run(cell, seed, seconds)
    tr = rec.trace
    busy = trace.busy_by_card(tr)
    out["idle_share_per_card"] = [1.0 - busy.get(c, 0.0) / (tr.t1 - tr.t0)
                                  for c in range(cell.chips)]
    out["slice_counters"] = rec.slice_counters
    return out


def _b2(seed: int, seconds: float) -> dict:
    from octbench import run

    out, numbers, _ = run.run(draft_cell(), seed, seconds, False, "cuda", t_start=T0)
    return out


def hybrid_cell():
    """The draft hybrid full-disk cell: fd-pcg's traffic and limits (no
    limit of its own yet) under the draft configuration."""
    from octbench import spec

    fd = spec.cell("fd-pcg")
    return spec.Cell(name="fd-hybrid-pcg", chips=1,
                     config=spec.load_json(os.path.join(HERE, "rehearsal",
                                                        "goes-fd-b13-hybrid.json")),
                     traffic=fd.traffic, limits=fd.limits, end_to_end=fd.end_to_end,
                     per_layer=fd.per_layer)


def _where(got, ref) -> dict:
    """The largest gap |got - ref| of a flow component: its size, pixel and
    distance from the image centre in half-widths, and the share of the
    largest 0.1 % beyond 0.9 half-widths (the limb's ring)."""
    import torch

    d = (got.to(ref.device) - ref).abs()
    h, w = d.shape
    r, c = divmod(int(torch.nan_to_num(d, nan=float("inf")).argmax()), w)
    top = torch.topk(torch.nan_to_num(d, nan=float("inf")).flatten(),
                     max(1, d.numel() // 1000)).indices
    radius = torch.hypot((top // w).double() - h / 2, (top % w).double() - w / 2) / (h / 2)
    return {"largest": float(d[r, c]), "at": [r, c],
            "radius": ((r - h / 2) ** 2 + (c - w / 2) ** 2) ** 0.5 / (h / 2),
            "top_beyond_0.9": float((radius > 0.9).double().mean())}


def _patch_match_alone(cell, seed: int, reps: int = 2) -> dict:
    """The port's zero-guess patch-match of the stream's first pair, once
    to warm up, then ``reps`` times under the profiler, each in the range
    PM_RANGE: its device ms a call by ``trace.device_us_in``, by CUDA
    events around the same calls, and its share of the bound."""
    import torch

    from octane_tpu_torch.flow.patch_match import patch_match_flow

    from octbench import grid, reference, roofline, trace, traffic

    cfg, s = cell.config, cell.config["settings"]
    dev = torch.device("cuda", torch.cuda.current_device())
    nav = grid.nav_constants(cfg)
    stream = traffic.make_stream(cfg, cell.traffic, seed, dev)
    loop, i = stream.pairs[0]
    g1, g2 = (reference.normalised(stream.frames[loop][j], nav, cfg["norm_min"],
                                   cfg["norm_max"], dev) for j in (i, i + 1))

    def call():
        return patch_match_flow(g1, g2, None, None, s["rad"], s["srad"])
    call()
    torch.cuda.synchronize(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof, torch.profiler.record_function(trace.SLICE):
        ev[0].record()
        for _ in range(reps):
            with torch.profiler.record_function(PM_RANGE):
                call()
        ev[1].record()
        torch.cuda.synchronize(dev)
    tr = trace.from_profiler(prof)
    ms = trace.device_us_in(tr, PM_RANGE) / reps / 1e3
    bound_ms = roofline.patch_match_bound_s(s, cfg["rows"], cfg["cols"], 1) * 1e3
    return {"patch_match_device_ms": ms, "patch_match_event_ms": ev[0].elapsed_time(ev[1]) / reps,
            "patch_match_bound_ms": bound_ms, "patch_match_bound_share": 100.0 * bound_ms / ms,
            "slice_device_ms": sum(e - b for b, e, *_ in tr.device) / reps / 1e3,
            "device_ops": len(tr.device),
            "device_ops_linked": sum(1 for names in tr.launched_in if names)}


def _hybrid(seed: int, seconds: float, control: bool) -> dict:
    from octbench import reference, run, spec

    cell = hybrid_cell()
    located, add = [], run._Gaps.add

    def add_located(gaps, got1, got2, ref1, ref2, u, v, ru, rv, products, ref_products):
        located.append({"u": _where(u, ru), "v": _where(v, rv)})
        add(gaps, got1, got2, ref1, ref2, u, v, ru, rv, products, ref_products)
    run._Gaps.add = add_located
    try:
        out, numbers, control_numbers, rec = _traced_run(
            cell, seed, seconds, reference.CONTROL if control else None)
    finally:
        run._Gaps.add = add
    line = {"pair_ms": spec.metric_reader("pair_ms")(rec), "pairs": out["attempted"],
            "metrics": out["metrics"], "breakdown": out.get("breakdown"),
            "device": out["device"], "correct": out["correct"], "program": numbers,
            "limits": cell.limits,
            # in the judge's order: the program's gaps, then the control's, a compared pair
            "located": located}
    if control:
        line["control"] = control_numbers
        line["control_refused_by"] = [k for k, lim in cell.limits.items()
                                      if not control_numbers[k] <= lim]
    line.update(_patch_match_alone(cell, seed))
    return line


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=sorted(PARTS), required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    faulthandler.register(signal.SIGTERM, all_threads=True)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < PARTS[a.part]:
        print(f"octbench.rehearse: {a.part} needs {PARTS[a.part]} CUDA device(s)", file=sys.stderr)
        return 2
    line = {"part": a.part, "seed": a.seed}
    try:
        line.update(_stream(a.seed) if a.part == "stream" else
                    _mesh(a.seed, a.seconds) if a.part == "mesh" else
                    _hybrid(a.seed, a.seconds, bool(a.control)) if a.part == "hybrid" else
                    _b2(a.seed, a.seconds))
        rc = 0
    except Exception as e:      # the rehearsal's finding: report where it stopped
        traceback.print_exc()
        line.update(error=f"{type(e).__name__}: {e}"[:2000],
                    where=traceback.format_exc().splitlines()[-14:])
        rc = 1
    line["seconds"] = time.perf_counter() - T0
    line["peaks_bytes"] = [torch.cuda.max_memory_allocated(i)
                           for i in range(torch.cuda.device_count())]
    print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
