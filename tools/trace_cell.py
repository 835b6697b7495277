"""One run of a benchmark cell (octbench) with the port's tracer on.

    python3 tools/trace_cell.py --workload <cell> --seed <n> --seconds <s>
                                [--trace 0|1] [--tracing 0|1]

Runs ``octbench.run.run`` as the benchmark does (set-up, with ``--trace
1`` the profiled slice and the window of spans ended by syncs, then the
comparison), with ``utils.profiling`` enabled before set-up
(``--tracing 0`` leaves it off, for the same run untraced) and every pair
of the stream in a ``profiling.request`` of its own (0 and 1 are set-up's
pairs, then the slice's, then the window's).  The harness does not turn
the tracer on itself, so this wraps its ``Pairs`` and catches its run
record; it stops with an error where those hooks no longer match.
Prints the benchmark's result line with a ``tracing`` field of what the
tracer read (``profiling.totals``), each a mean a pair over the window
(over the slice too, ``slice``), device times from the stamps:

  solve_ms      first to last stamp of the solve (flow.variational._pair)
  pix2uv_ms     the stamps around nav.winds.pix2uv
  relax_ms      the rounds' relaxer spans summed (octane.pcg or octane.sor)
  navcal_ms     the stamps around both scans' nav.goes.navcal_goes
  capped_rounds profiling.capped_share of the window's counts by round
  setup_s       seconds of the spans octane.kernels.load, octane.program.warm_up
                and octane.program.capture, each summed over the run

and the host spans' means (``host_ms``).  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from octbench import run as bench  # noqa: E402
from octbench import spec  # noqa: E402


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def summary(pairs, solver: str) -> dict:
    """Means a pair of ``pairs``, each ``profiling.totals`` of one request."""
    def device(name):
        return _mean([t[name][1] if name in t else None for t in pairs])

    host = sorted({name for t in pairs for name, (ms, _) in t.items() if ms})
    return {"pairs": len(pairs), "solve_ms": device("octane.solve"),
            "pix2uv_ms": device("octane.flow.pix2uv"),
            "relax_ms": device(f"octane.{solver}"),
            "navcal_ms": device("octane.ingest.navcal"),
            "host_ms": {k: _mean([t.get(k, (None,))[0] for t in pairs]) for k in host}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tracing", type=int, choices=(0, 1), default=1)
    a = ap.parse_args(argv)

    import torch

    from octane_tpu_torch import ops
    from octane_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("trace_cell: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(a.workload)
    solver = cell.traffic["solver"]
    if a.tracing:
        profiling.enable()

    class Pairs(bench.Pairs):
        calls = 0

        def __call__(self, k, keep=False):
            with profiling.request(Pairs.calls):
                Pairs.calls += 1
                return super().__call__(k, keep)

    runs = []
    reader = spec.metric_reader

    def keep_run(name):
        read = reader(name)

        def wrapped(run):
            runs.append(run)
            return read(run)
        return wrapped

    bench.Pairs, spec.metric_reader = Pairs, keep_run
    out, _, _ = bench.run(cell, a.seed, a.seconds, bool(a.trace), "cuda", t_start=T0)
    if not runs or not Pairs.calls:
        print("trace_cell: octbench.run no longer calls run.Pairs or spec.metric_reader",
              file=sys.stderr)
        return 1
    run = runs[0]
    line = {"workload": a.workload, "solver": solver, "seed": a.seed, "trace": a.trace,
            "tracer": a.tracing, "correct": out["correct"], "metrics": out["metrics"],
            "setup_s": run.setup_s, "pair_ms": 1e3 * run.window_s / run.pairs,
            "pairs": run.pairs, "device": out["device"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    if a.tracing:
        n_slice = run.slice_pairs
        recs = profiling.records()
        pairs = {r: profiling.totals(spans) for r, spans in recs.items() if r is not None}
        window = [pairs[r] for r in sorted(pairs) if r >= 2 + n_slice]
        sliced = [pairs[r] for r in sorted(pairs) if 2 <= r < 2 + n_slice]
        c = ops.counters()
        key = "pcg_iterations" if solver == "pcg" else "sor_passes"
        by_round = c[f"{key}_by_round"]
        setup = profiling.totals(s for spans in recs.values() for s in spans
                                 if s.name.startswith(("octane.program.", "octane.kernels.")))
        trace = summary(window, solver)
        trace.update(
            capped_rounds=profiling.capped_share(
                by_round, solver, cell.config["settings"]["cgiters"], run.pairs),
            by_round_per_pair=[n / run.pairs for n in by_round],
            count_per_pair=sum(by_round) / run.pairs if by_round else None,
            counted_per_pair=c["pcg_pass_a" if solver == "pcg" else "sor_pass"][0] / run.pairs,
            setup_s={k: ms / 1e3 for k, (ms, _) in setup.items()},
            slice=summary(sliced, solver))
        if run.trace is not None:
            from octbench import trace as tr

            names = ("pcg_pass_a", "pcg_pass_b") if solver == "pcg" else ("sor_pass",)
            trace["slice"]["passes_kernel_ms"] = tr.kernel_us(run.trace, names) / 1e3 / n_slice
        line["tracing"] = trace
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
