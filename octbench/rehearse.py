"""A rehearsal of the band-2 full disk on four cards, with no cell in
BENCHMARK.json: the draft configuration ``rehearsal/goes-fd-b2.json``
(21696 x 21696 at 0.5 km, ``mesh_shape`` [4, 1]) under the draft traffic
``rehearsal/fd-b2-stream.json``.

    python3 -m octbench.rehearse --part <part> --seed <n> [--seconds <s>]

One part a process (run each under ``timeout``; SIGTERM prints every
thread's stack on standard error):

* ``stream``: the draft's scans made on one card (seconds, the card's
  peak, host bytes), then the plain reference of the stream's first pair
  on the same card (ingest, solve and winds: seconds and peak, counted
  from a reset after the stream);
* ``mesh``: a traced run (``run.run``, ``--trace 1``) of fd-pcg's
  configuration with ``mesh_shape`` [4, 1], one band a card;
* ``b2``: an untraced run of the draft on four cards.

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
PARTS = {"stream": 1, "mesh": 4, "b2": 4}


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


def _mesh(seed: int, seconds: float) -> dict:
    from octbench import run, spec, trace

    cell = spec.cell("fd-pcg")
    cell.name, cell.chips = "fd-pcg-mesh4", 4
    cell.config["settings"]["mesh_shape"] = [4, 1]
    runs, reader = [], spec.metric_reader

    def keep(name):                     # the run record, for each card's idle share
        read = reader(name)

        def wrapped(r):
            runs.append(r)
            return read(r)
        return wrapped
    spec.metric_reader = keep
    try:
        out, numbers, _ = run.run(cell, seed, seconds, True, "cuda", t_start=T0)
    finally:
        spec.metric_reader = reader
    tr = runs[0].trace
    busy = trace.busy_by_card(tr)
    out["idle_share_per_card"] = [1.0 - busy.get(c, 0.0) / (tr.t1 - tr.t0)
                                  for c in range(cell.chips)]
    out["slice_counters"] = runs[0].slice_counters
    return out


def _b2(seed: int, seconds: float) -> dict:
    from octbench import run

    out, numbers, _ = run.run(draft_cell(), seed, seconds, False, "cuda", t_start=T0)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=sorted(PARTS), required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    a = ap.parse_args(argv)
    faulthandler.register(signal.SIGTERM, all_threads=True)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < PARTS[a.part]:
        print(f"octbench.rehearse: {a.part} needs {PARTS[a.part]} CUDA device(s)", file=sys.stderr)
        return 2
    line = {"part": a.part, "seed": a.seed}
    try:
        line.update(_stream(a.seed) if a.part == "stream" else
                    _mesh(a.seed, a.seconds) if a.part == "mesh" else _b2(a.seed, a.seconds))
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
