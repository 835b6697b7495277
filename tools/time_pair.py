"""Times the single-device pair on one card, for comparing two checkouts of the port.

    python3 tools/time_pair.py [--repo DIR] [--size 5424] [--kiters 4]
                               [--solver pcg [sor]] [--pairs 3]

Imports ``octane_tpu_torch`` from ``--repo`` (default: this checkout), so
two checkouts run the same measurement; the synthetic bench pair (truth
(2.4, 0) px) comes from this checkout's ``tests/torch_fixtures.bench_pair``.
After the kernels are built and a 256^2 pair per relaxer has warmed the
process up, per relaxer it times, with ``variational_flow``'s program of a
fresh key: the first call (the pair run eagerly) and the second (capture and first
replay) on the host's clock after a device sync; then ``--pairs`` replays
with CUDA events; then ``--pairs`` pairs of the eager kernel route
(``flow.variational._coarse_to_fine``), CUDA events and host wall, with
each wrapper's launches in one eager pair.  Prints the card's name and
power limit, then one JSON line {"repo", solver: {"first_s", "second_s",
"replay_ms", "eager_ms", "eager_wall_ms", "launches", "median"}}.  Run
two checkouts in turns (A, B, B, A) on one card, one after another, to
compare them.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE, help="the checkout whose octane_tpu_torch runs")
    ap.add_argument("--size", type=int, default=5424)
    ap.add_argument("--kiters", type=int, default=4)
    ap.add_argument("--solver", nargs="+", choices=("pcg", "sor"), default=["pcg"])
    ap.add_argument("--pairs", type=int, default=3)
    a = ap.parse_args()
    repo = os.path.abspath(a.repo)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("time_pair: no CUDA device", file=sys.stderr)
        return 1
    from torch_fixtures import bench_pair

    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.variational import (_coarse_to_fine, clear_program_cache,
                                                   variational_flow)
    from octane_tpu_torch.ops.build import load_kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    load_kernels()
    # the process's first pairs pay one-time CUDA and allocator warm-up
    w1, w2 = (torch.from_numpy(im[None]).to(dev) for im in bench_pair(256, 256))
    for solver in a.solver:
        w0 = torch.zeros((256, 256), device=dev)
        _coarse_to_fine(w1, w2, w0, w0, OFConfig(kiters=3, solver=solver))
    n = a.size
    im1, im2 = bench_pair(n, n)
    g1, g2 = (torch.from_numpy(im[None]).to(dev) for im in (im1, im2))
    z = torch.zeros((n, n), device=dev)
    out = {"repo": repo}

    def events(run):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        flow = run()
        ev[1].record()
        torch.cuda.synchronize()
        return flow, ev[0].elapsed_time(ev[1]), (time.perf_counter() - t0) * 1e3

    for solver in a.solver:
        cfg = OFConfig(kiters=a.kiters, solver=solver)
        res = {}
        for key in ("first_s", "second_s"):
            _, _, wall = events(lambda: variational_flow(g1, g2, z, z, cfg))
            res[key] = wall / 1e3
        res["replay_ms"] = [events(lambda: variational_flow(g1, g2, z, z, cfg))[1]
                            for _ in range(a.pairs)]
        clear_program_cache()
        _coarse_to_fine(g1, g2, z, z, cfg)
        res["eager_ms"], res["eager_wall_ms"] = [], []
        for _ in range(a.pairs):
            ops.reset_counters()
            (u, v), ms, wall = events(lambda: _coarse_to_fine(g1, g2, z, z, cfg))
            res["eager_ms"].append(ms)
            res["eager_wall_ms"].append(wall)
        res["launches"] = {k: c[0] for k, c in ops.counters().items()
                           if isinstance(c, tuple) and c[0]}
        m = n // 8
        res["median"] = [float(u[m:-m, m:-m].median()), float(v[m:-m, m:-m].median())]
        out[solver] = res
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
