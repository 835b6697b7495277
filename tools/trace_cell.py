"""One run of a benchmark cell (octbench) with the port's tracer on.

    python3 tools/trace_cell.py --workload <cell> --seed <n> --seconds <s>
                                [--trace 0|1] [--tracing 0|1] [--memory 0|1]

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

  solve_ms      first to last stamp of the solve (flow.variational._pair;
                on a mesh, each card's, summed over the cards)
  pix2uv_ms     the stamps around nav.winds.pix2uv
  patch_match_ms  the stamps around flow.patch_match's search
                (octane.flow.patch_match; patch-match and the hybrid only)
  to_host_ms    the stamps around each card's copies of the product planes
                to page-locked host memory (io.host.to_host), summed over
                the cards
  relax_ms      the rounds' relaxer spans summed (octane.pcg or octane.sor)
  exchange_ms   on a mesh, the octane.exchange spans summed over the cards:
                each level's fetch of its sample stack and each round's
                ghost rows (parallel.sharded.banded_flow)
  by_card       on a mesh, solve_ms, relax_ms, exchange_ms and to_host_ms of
                each card
  navcal_ms     the stamps around both scans' nav.goes.navcal_goes
  capped_rounds profiling.capped_share of the window's counts by round
  wide_warp_rounds  ops.counters(): the last pair's rounds whose band warp
                fell back to the whole level (0 on one card)
  pyramid_level  ops.counters(): the pyramid kernel's launches a pair of the
                window and its plain calls (ops.pyramid; a coarse level a
                pair on one card; none on a mesh, nor where the program has
                no such kernel)
  patch_match   ops.counters(): patch-match's kernel launches and plain
                searches a pair of the window (none where the program has
                no such counter)
  host_planes, host_plane_bytes  ops.counters(): the product planes
                delivered into page-locked host memory and their bytes, a
                pair of the window
  setup_s       seconds of the spans octane.kernels.load, octane.program.warm_up
                and octane.program.capture, each summed over the run

and the host spans' means (``host_ms``); with ``--trace 1`` also the
profiled slice's copies by operation name (``copies_ms``: each name that
holds "Memcpy", device ms a pair summed over the cards).  With ``--memory
1`` each pair's memory peak of every card (its peak counters reset as the
pair starts, so the result's ``memory_peak_bytes`` is then the last pair's)
goes to standard error as the run goes, and the line gains ``memory``:
every pair's peaks, and the bytes held, reserved and reserved by the
programs' pools after it, by card; and the largest peak of each card.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from octbench import roofline, spec  # noqa: E402
from octbench import run as bench  # noqa: E402


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def summary(pairs, solver: str, by_card=None) -> dict:
    """Means a pair of ``pairs``, each ``profiling.totals`` of one request;
    ``by_card`` ({card: [totals of its spans, a pair]}) adds each card's."""
    def device(name, of=pairs):
        return _mean([t[name][1] if name in t else None for t in of])

    host = sorted({name for t in pairs for name, (ms, _) in t.items() if ms})
    out = {"pairs": len(pairs), "solve_ms": device("octane.solve"),
           "pix2uv_ms": device("octane.flow.pix2uv"),
           "patch_match_ms": device("octane.flow.patch_match"),
           "to_host_ms": device("octane.flow.to_host"),
           "relax_ms": device(f"octane.{solver}"),
           "exchange_ms": device("octane.exchange"),
           "navcal_ms": device("octane.ingest.navcal"),
           "host_ms": {k: _mean([t.get(k, (None,))[0] for t in pairs]) for k in host}}
    if by_card:
        out["by_card"] = {card: {"solve_ms": device("octane.solve", of),
                                 "relax_ms": device(f"octane.{solver}", of),
                                 "exchange_ms": device("octane.exchange", of),
                                 "to_host_ms": device("octane.flow.to_host", of)}
                          for card, of in sorted(by_card.items())}
    return out


class Memory:
    """Each pair's memory peak and the bytes held after it, on every card."""

    def __init__(self, cards: int):
        self.cards = range(cards)
        self.pairs = []

    def start(self):
        import torch

        for d in self.cards:
            torch.cuda.reset_peak_memory_stats(d)

    def end(self, k: int):
        import torch

        from octane_tpu_torch.flow.program import program_pool_bytes

        rec = {"pair": k, "peak": [torch.cuda.max_memory_allocated(d) for d in self.cards],
               "held": [torch.cuda.memory_allocated(d) for d in self.cards],
               "reserved": [torch.cuda.memory_reserved(d) for d in self.cards],
               "pool_bytes": [program_pool_bytes(d) for d in self.cards]}
        self.pairs.append(rec)
        print(f"trace_cell memory: {json.dumps(rec)}", file=sys.stderr, flush=True)

    def line(self) -> dict:
        return {"pairs": self.pairs,
                "largest_peak": [max(p["peak"][d] for p in self.pairs) for d in self.cards]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tracing", type=int, choices=(0, 1), default=1)
    ap.add_argument("--memory", type=int, choices=(0, 1), default=0)
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

    memory = Memory(cell.chips) if a.memory else None

    class Pairs(bench.Pairs):
        calls = 0

        def __call__(self, k, keep=False):
            with profiling.request(Pairs.calls):
                Pairs.calls += 1
                if memory is None:
                    return super().__call__(k, keep)
                memory.start()
                out = super().__call__(k, keep)
                memory.end(k)
                return out

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
            "pairs": run.pairs, "device": out["device"], "checks": out["checks"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    if memory is not None:
        line["memory"] = memory.line()
    if a.tracing:
        n_slice = run.slice_pairs
        recs = profiling.records()
        pairs = {r: profiling.totals(spans) for r, spans in recs.items() if r is not None}
        window = [pairs[r] for r in sorted(pairs) if r >= 2 + n_slice]
        sliced = [pairs[r] for r in sorted(pairs) if 2 <= r < 2 + n_slice]
        by_card = {}            # the device spans of a mesh's cards, a pair each
        for r in sorted(pairs):
            if r >= 2 + n_slice:
                for card in {s.card for s in recs[r] if s.card is not None}:
                    by_card.setdefault(card, []).append(
                        profiling.totals(s for s in recs[r] if s.card == card))
        c = ops.counters()
        key = "pcg_iterations" if solver == "pcg" else "sor_passes"
        by_round = c[f"{key}_by_round"]
        setup = profiling.totals(s for spans in recs.values() for s in spans
                                 if s.name.startswith(("octane.program.", "octane.kernels.")))
        trace = summary(window, solver, by_card if len(by_card) > 1 else None)
        trace.update(
            capped_rounds=profiling.capped_share(
                by_round, solver, cell.config["settings"]["cgiters"], run.pairs),
            wide_warp_rounds=c["wide_warp_rounds"],
            pyramid_level=({"launches": c["pyramid_level"][0] / run.pairs,
                            "plain_calls": c["pyramid_level"][1]}
                           if "pyramid_level" in c else None),
            patch_match=({"launches": c["patch_match"][0] / run.pairs,
                          "plain_calls": c["patch_match"][1] / run.pairs}
                         if "patch_match" in c else None),
            host_planes=c["host_planes"] / run.pairs,
            host_plane_bytes=c["host_plane_bytes"] / run.pairs,
            by_round_per_pair=[n / run.pairs for n in by_round],
            count_per_pair=sum(by_round) / run.pairs if by_round else None,
            counted_per_pair=roofline.work(cell.config["settings"], {k: v[0] for k, v in c.items()
                                                                    if isinstance(v, tuple)},
                                           solver) / run.pairs,
            setup_s={k: ms / 1e3 for k, (ms, _) in setup.items()},
            slice=summary(sliced, solver))
        if run.trace is not None:
            from octbench import trace as tr

            names = ("pcg_pass_a", "pcg_pass_b") if solver == "pcg" else ("sor_pass",)
            trace["slice"]["passes_kernel_ms"] = tr.kernel_us(run.trace, names) / 1e3 / n_slice
            copies = sorted({n for _, _, n, _ in run.trace.device if "Memcpy" in n})
            trace["slice"]["copies_ms"] = {n: tr.kernel_us(run.trace, (n,)) / 1e3 / n_slice
                                           for n in copies}
        line["tracing"] = trace
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
