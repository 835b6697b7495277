"""Run one cell of the benchmark of octane_tpu_torch.

    python3 -m octbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Set-up (``setup_s``, from this module's import to the window): load the
   port and its kernels (built on first use into the checkout's
   ``octane_tpu_torch/_build/``), make the cell's scans from the seed on
   the card (``traffic.make_stream``), and run the stream's first two pairs:
   the program key's eager pair and its capture and first replay.  The
   phases' seconds are printed on standard error.
2. The window: pairs in stream order, one in flight, for ``--seconds``.
   Each pair is the port's own path without the file codec:
   ``scene_from_goes_arrays`` of both scans from host int16 counts (the
   first navigated), ``compute_flow`` (warm-started from the previous pair
   inside a loop where the traffic says so), and U, V, U_raw and V_raw
   copied to host memory.  A pair's latency runs from its counts on the
   host to its winds on the host.
3. With ``--trace 1`` the traffic's ``trace_pairs`` pairs run under
   ``torch.profiler`` ahead of the window (the profiled slice), and in the
   window each layer is timed by a span that ends in a sync of every card
   the cell uses; the cell's per-layer metrics are read from those
   (``metrics/<name>.py``) in place of the end-to-end ones.
4. Once the window has closed and the memory peak of each card is read,
   the programs are freed, the program's kept outputs go to host memory,
   and the plain reference (``reference.py``) recomputes on the first card
   the compared pairs, drawn from the seed, from the same counts: the
   ingest, the whole solve (the warm-start chain from its loop's first
   pair) and the winds.  ``correct`` holds when every number is within
   the cell's limit (``limits/<cell>.json``).
5. The last line of standard output is the result, in JSON.

It refuses to run (exit 2, no result) without as many CUDA devices as the
cell asks for, and exits 3 without a result if jax, jaxlib, flax or the
JAX package were loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "octane_tpu")


def forbidden_modules(modules=None):
    """The top-level names of ``modules`` (default: sys.modules) that are
    jax, jaxlib, flax or the JAX package, compared whole: octane_tpu_torch
    is not octane_tpu."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def cards(device, chips: int):
    """The devices a cell of ``chips`` cards uses from ``device`` on: the
    mesh puts band i on cuda:i.  The CPU is one device."""
    import torch

    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", device.index + i) for i in range(chips)]


def synchronizer(devices):
    """A function that waits for every device of ``devices``."""
    import torch

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    return sync


def device_record(devices) -> dict:
    """The result's ``device``: the platform, the first card's name, the
    number of cards, and the memory peak of the fullest card beside each
    card's peak, in the order of ``devices``."""
    import torch

    if devices[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": len(devices), "memory_peak_bytes": 0}
    peaks = [int(torch.cuda.max_memory_allocated(d)) for d in devices]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
            "count": len(devices), "memory_peak_bytes": max(peaks),
            "memory_peak_bytes_per_card": peaks}


class Spans:
    """Per-layer host spans of the traced run, each ended by a sync of
    every card and named for the profiler."""

    def __init__(self, on: bool, sync):
        self.on, self.sync = on, sync
        self.ms = {"ingest": [], "flow": [], "output": []}

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(f"octbench.{name}"):
            yield
            self.sync()
        self.ms[name].append((time.perf_counter() - t0) * 1e3)


class Pairs:
    """The cell's stream through the port, pair by pair."""

    def __init__(self, cell, stream, device, spans):
        from octane_tpu_torch.config import OFConfig
        from octane_tpu_torch.io.datamodel import NavConstants
        from octane_tpu_torch.io.readers import set_goes_grid

        from octbench import grid

        cfg = cell.config
        self.cfg, self.stream, self.device, self.spans = cfg, stream, device, spans
        self.warm_start = cell.traffic["warm_start"]
        settings = dict(cfg["settings"])
        if "mesh_shape" in settings:        # a JSON list; the port takes a tuple
            settings["mesh_shape"] = tuple(settings["mesh_shape"])
        self.ocfg = OFConfig(solver=cell.traffic["solver"], **settings)
        self.x, self.y = grid.scan_counts(cfg)
        nav = grid.nav_constants(cfg)

        def make_nav():
            return set_goes_grid(NavConstants(**nav), cfg["rows"], cfg["cols"], cfg["band"])
        self.make_nav = make_nav
        self.prev = None
        self.kept = {}          # stream position -> the program's outputs

    def __call__(self, k: int, keep: bool = False):
        """Pair ``k`` of the stream (positions wrap); with ``keep``, the
        program's outputs of its first occurrence are kept for the
        comparison."""
        from octane_tpu_torch.flow.dispatcher import compute_flow
        from octane_tpu_torch.io.readers import scene_from_goes_arrays

        st = self.stream
        s, i = st.pairs[k % len(st.pairs)]
        fg = self.prev if (self.warm_start and i > 0) else None
        with self.spans("ingest"):
            s1 = scene_from_goes_arrays(st.frames[s][i], self.x, self.y, self.make_nav(),
                                        self.ocfg, self.device, donav=True, t=st.times[s][i],
                                        band=self.cfg["band"])
            s2 = scene_from_goes_arrays(st.frames[s][i + 1], self.x, self.y, self.make_nav(),
                                        self.ocfg, self.device, donav=False,
                                        t=st.times[s][i + 1], band=self.cfg["band"])
        with self.spans("flow"):
            compute_flow(s1, s2, self.ocfg, first_guess=fg)
        with self.spans("output"):
            products = [t.cpu().numpy() for t in (s1.u_wind, s1.v_wind, s1.u_raw, s1.v_raw)]
        self.prev = (s1.u_pix, s1.v_pix)
        if keep and k % len(st.pairs) not in self.kept:
            self.kept[k % len(st.pairs)] = dict(data1=s1.data[0], data2=s2.data[0],
                                                u=s1.u_pix, v=s1.v_pix, products=products)


def compared_positions(cell, seed: int):
    """The stream positions whose outputs are compared, drawn from the seed:
    ``compare_pairs`` consecutive pairs of one loop."""
    import numpy as np

    n = cell.traffic["compare_pairs"]
    per_loop = cell.traffic["frames"] - 1
    rng = np.random.default_rng([seed % (1 << 63), 7])
    loop = int(rng.integers(cell.traffic["sequences"]))
    first = int(rng.integers(per_loop - n + 1))
    return [loop * per_loop + first + j for j in range(n)]


def judge(cell, stream, kept, positions, device, precision=None):
    """Numbers of the comparison: (numbers of the program, numbers of the
    control or None).  The program's kept planes wait in host memory; the
    reference replays each compared loop from its first pair,
    warm-starting where the traffic does.  Under a hybrid configuration
    (``settings.algorithm`` "hybrid") each compared pair's solve starts
    from the reference's patch-match of its two images, the control's from
    the control's."""
    import torch

    from octbench import grid, reference, spec

    for got in kept.values():
        for name in ("data1", "data2", "u", "v"):
            got[name] = got[name].cpu()
    cfg, s = cell.config, cell.config["settings"]
    nav = grid.nav_constants(cfg)
    vmin, vmax = cfg["norm_min"], cfg["norm_max"]
    solver = cell.traffic["solver"]
    spec.refuse(cell.name, cfg, cell.traffic)
    hybrid = s.get("algorithm", "variational") == "hybrid"
    # OCTANE's patch and search radii (src/main.cc:75-76) where the settings name none
    rad, srad = s.get("rad", 2), s.get("srad", 2)
    acc = {"program": _Gaps(), "control": _Gaps() if precision else None}
    by_loop = {}
    for pos in positions:
        by_loop.setdefault(stream.pairs[pos][0], []).append(pos)
    per_loop = cell.traffic["frames"] - 1
    for loop, poss in by_loop.items():
        start = loop * per_loop if cell.traffic["warm_start"] else min(poss)
        fg = {"ref": None, "ctl": None}
        for pos in range(start, max(poss) + 1):
            _, i = stream.pairs[pos]
            c1, c2 = stream.frames[loop][i], stream.frames[loop][i + 1]
            dt = stream.times[loop][i + 1] - stream.times[loop][i]
            d1 = reference.normalised(c1, nav, vmin, vmax, device)
            d2 = reference.normalised(c2, nav, vmin, vmax, device)
            zero = torch.zeros_like(d1)
            if hybrid:          # the solve starts from patch-match's flow
                u0, v0 = reference.patch_match(d1, d2, rad, srad)
            else:
                u0, v0 = fg["ref"] if (cell.traffic["warm_start"] and i > 0) else (zero, zero)
            u, v, _ = reference.solve(d1[None], d2[None], u0, v0, s, solver,
                                      acc=reference.REFERENCE.accumulate)
            fg["ref"] = (u, v)
            ref_products = reference.winds(u, v, nav, dt)
            if pos in poss:
                if pos not in kept:
                    acc["program"].missing += 1
                else:
                    got = kept[pos]
                    acc["program"].add(got["data1"], got["data2"], d1, d2, got["u"], got["v"],
                                       u, v, [torch.as_tensor(p) for p in got["products"]],
                                       ref_products)
            if precision:
                e1 = reference.normalised(c1, nav, vmin, vmax, device, precision)
                e2 = reference.normalised(c2, nav, vmin, vmax, device, precision)
                if hybrid:
                    cu0, cv0 = reference.patch_match(e1, e2, rad, srad, precision)
                else:
                    cu0, cv0 = fg["ctl"] if (cell.traffic["warm_start"] and i > 0) else (zero, zero)
                cu, cv, _ = reference.solve(e1[None], e2[None], cu0, cv0, s, solver,
                                            precision.solve, precision.accumulate)
                fg["ctl"] = (cu, cv)
                if pos in poss:
                    acc["control"].add(e1, e2, d1, d2, cu, cv, u, v,
                                       reference.winds(cu, cv, nav, dt, precision), ref_products)
    return acc["program"].numbers(), (acc["control"].numbers() if precision else None)


def _nan_max(a: float, b: float) -> float:
    return float("nan") if a != a or b != b else max(a, b)


class _Gaps:
    """The numbers compared, accumulated over the compared pairs."""

    def __init__(self):
        self.mismatch = self.pixels = 0
        self.flow = self.flow_p999 = self.wind = self.raw = 0.0
        self.missing = 0

    def add(self, got1, got2, ref1, ref2, u, v, ru, rv, products, ref_products):
        import torch

        for g, r in ((got1, ref1), (got2, ref2)):
            self.mismatch += int((g.to(r.device) != r).sum())
            self.pixels += r.numel()
        for got, ref in ((u, ru), (v, rv)):
            d = (got.to(ref.device) - ref).abs().flatten()
            self.flow = _nan_max(self.flow, float(d.max()))
            # the 99.9th percentile: the least of the largest 0.1 %
            top = torch.topk(d, max(1, d.numel() // 1000)).values
            self.flow_p999 = _nan_max(self.flow_p999, float(top.min()))
        diffs = [(p.to(q.device).to(torch.int32) - q.to(torch.int32)).abs().max().item()
                 for p, q in zip(products, ref_products)]
        self.wind = max(self.wind, *diffs[:2])
        self.raw = max(self.raw, *diffs[2:])

    def numbers(self):
        return {"ingest_mismatch": self.mismatch / max(self.pixels, 1),
                "flow_gap_px": self.flow, "flow_gap_p999_px": self.flow_p999,
                "wind_gap": float(self.wind),
                "raw_gap": float(self.raw), "missing_pairs": float(self.missing)}


def within(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (NaN is not); no compared pair missing."""
    return numbers["missing_pairs"] == 0 and all(
        numbers[k] <= lim for k, lim in limits.items())


def _launches() -> dict:
    """{wrapper: kernel launches} since the last reset, replayed graphs'
    device tallies included (a host read)."""
    from octane_tpu_torch import ops

    return {name: v[0] for name, v in ops.counters().items() if isinstance(v, tuple)}


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run(cell, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
        control=None):
    """One run of ``cell``: the result's fields, the numbers compared and,
    with ``control`` (a reference.Precision), the control's numbers."""
    import torch

    from octane_tpu_torch import ops
    from octane_tpu_torch.flow.variational import clear_program_cache

    from octbench import spec, traffic
    from octbench import trace as tr

    t_start = T_START if t_start is None else t_start
    phases = {"imports": time.perf_counter() - t_start}
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        ops.build.load_kernels()
    devices = cards(device, cell.chips)
    sync = synchronizer(devices)

    def phase(name):
        sync()
        phases[name] = time.perf_counter() - t_start - sum(phases.values())

    phase("context_and_kernels")
    stream = traffic.make_stream(cell.config, cell.traffic, seed, device)
    phase("stream")
    print(f"stream: {len(stream.pairs)} pairs of {cell.config['rows']}x{cell.config['cols']}, "
          f"largest motion {stream.max_px:.3f} px per {cell.config['cadence_s']:g} s, "
          f"calm share {stream.calm_share:.3f} (a sanity check, not a metric)", flush=True)
    positions = compared_positions(cell, seed)
    spans = Spans(trace, sync)
    pairs = Pairs(cell, stream, device, spans)
    pairs(0)                    # the key's eager pair
    phase("eager_pair")
    pairs(1)                    # its capture and first replay
    phase("capture")
    setup_s = time.perf_counter() - t_start
    print("setup phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr, flush=True)
    for v in spans.ms.values():
        v.clear()

    want = set(positions)
    n_trace = cell.traffic["trace_pairs"] if trace else 0
    prof, slice_counters, k = None, {}, 0
    ops.reset_counters()
    if n_trace:                 # the profiled slice, ahead of the window
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        with prof, torch.profiler.record_function(tr.SLICE):
            for k in range(n_trace):
                pairs(k, keep=k % len(stream.pairs) in want)
            sync()
        k = n_trace
        slice_counters = _launches()
        ops.reset_counters()
        for v in spans.ms.values():
            v.clear()
    latencies = []
    t0 = time.perf_counter()
    while True:
        p0 = time.perf_counter()
        pairs(k, keep=k % len(stream.pairs) in want)
        p1 = time.perf_counter()
        latencies.append(p1 - p0)
        k += 1
        if p1 - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    window_counters = _launches()

    result_device = device_record(devices)
    if device.type == "cuda":
        result_device["power_limit_w"] = _power_limit()

    runrec = types.SimpleNamespace(
        config=cell.config, traffic=cell.traffic, setup_s=setup_s, window_s=window_s,
        latencies=latencies, pairs=len(latencies), spans=spans.ms,
        trace=None, slice_pairs=n_trace, slice_counters=slice_counters,
        window_counters=window_counters)
    breakdown = None
    if prof is not None:
        runrec.trace = tr.from_profiler(prof, len(devices))
        result_device["busy_s"] = tr.busy_us(runrec.trace) / runrec.trace.cards / 1e6
        result_device["window_s"] = (runrec.trace.t1 - runrec.trace.t0) / 1e6
        breakdown = {"device_ops": tr.device_ops(runrec.trace),
                     "idle_gaps": tr.idle_gaps(runrec.trace)}

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(runrec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the comparison, with the programs freed
    del pairs.prev
    kept = pairs.kept
    clear_program_cache()
    t_ref = time.perf_counter()
    numbers, control_numbers = judge(cell, stream, kept, positions, device, control)
    print(f"comparison: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr, flush=True)
    correct = within(numbers, cell.limits)
    out = {"correct": correct, "attempted": len(latencies), "failed": 0, "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": numbers[name], "limit": cell.limits.get(name, 0.0)}
                     for name in numbers}
    return out, numbers, control_numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from octbench import spec

    cell = spec.cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"octbench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out, numbers, _ = run(cell, a.seed, a.seconds, bool(a.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"octbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
