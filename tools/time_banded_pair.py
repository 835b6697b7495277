"""Times the banded pair on one card, for comparing two checkouts of the port.

    python3 tools/time_banded_pair.py [--repo DIR] [--size 5424] [--kiters 4]
                                      [--pairs 3] [--gloo-pairs 1] [--no-gloo]

Imports ``octane_tpu_torch`` from ``--repo`` (default: this checkout), so
two checkouts run the same measurement; the synthetic bench pair comes
from this checkout's ``tests/torch_fixtures.bench_pair``.  Per relaxer it
times (a) ``sharded_variational_flow`` on a (1, 4) mesh of cuda:0, which
replays the banded program's graph (two untimed calls first: the eager
call and the capture), ``--pairs`` pairs with CUDA events, and (b) the
multi-process path, 2 processes on cuda:0 in a gloo group over a
``file://`` store, each calling ``distributed_variational_flow`` on its
row block (one untimed call: the route is eager, then ``--gloo-pairs``
pairs with CUDA events between barriers).  Prints the card's name and power limit, then one JSON
line {"repo", "mesh_1x4": {solver: [ms...]}, "gloo": {solver: [ms...]}}
with the ms of every timed pair (gloo: process 0's).  Run two checkouts in
turns (A, B, B, A) on one card, one after another, to compare them.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(repo):
    sys.path.insert(0, os.path.join(HERE, "tests"))
    sys.path.insert(0, repo)


def _pair(size):
    from torch_fixtures import bench_pair

    return bench_pair(size, size)


def mesh_times(repo, size, kiters, pairs):
    import torch

    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.parallel import make_mesh, sharded_variational_flow

    dev = torch.device("cuda", 0)
    im1, im2 = _pair(size)
    g1, g2 = (torch.from_numpy(im[None]).to(dev) for im in (im1, im2))
    z = torch.zeros((size, size), device=dev)
    mesh = make_mesh((1, 4), [dev] * 4)
    out = {}
    for solver in ("sor", "pcg"):
        cfg = OFConfig(kiters=kiters, solver=solver)
        for _ in range(2):
            sharded_variational_flow(g1, g2, z, z, cfg, mesh)
        ms = []
        for _ in range(pairs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            sharded_variational_flow(g1, g2, z, z, cfg, mesh)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        out[solver] = ms
    return out


def gloo_worker(rank, repo, url, out, size, kiters, pairs):
    _setup(repo)
    import torch

    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.parallel import distributed as D

    D.initialize_multihost(url, 2, rank, "gloo", "cuda:0")
    try:
        im1, im2 = _pair(size)
        res = {}
        for solver in ("sor", "pcg"):
            cfg = OFConfig(kiters=kiters, solver=solver)
            mesh = D.distributed_mesh(cfg, "cuda:0")
            r0, r1 = D.host_row_block(size, mesh)
            dev = D.own_device(mesh)
            g1, g2 = (torch.from_numpy(im[None, r0:r1].copy()).to(dev) for im in (im1, im2))
            ex = D.distributed_exchange(mesh)
            D.distributed_variational_flow(g1, g2, (size, size), cfg, mesh, exchange=ex)
            ms = []
            for _ in range(pairs):
                ex.barrier()
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                D.distributed_variational_flow(g1, g2, (size, size), cfg, mesh, exchange=ex)
                ev[1].record()
                torch.cuda.synchronize()
                ex.barrier()
                ms.append(ev[0].elapsed_time(ev[1]))
            res[solver] = ms
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        D.shutdown_multihost()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--size", type=int, default=5424)
    ap.add_argument("--kiters", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--gloo-pairs", type=int, default=1)
    ap.add_argument("--no-gloo", action="store_true")
    a = ap.parse_args()
    repo = os.path.abspath(a.repo)
    _setup(repo)
    import torch

    if not torch.cuda.is_available():
        print("time_banded_pair: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    res = {"repo": repo, "mesh_1x4": mesh_times(repo, a.size, a.kiters, a.pairs)}
    if not a.no_gloo:
        import multiprocessing

        torch.cuda.empty_cache()
        ctx = multiprocessing.get_context("spawn")
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "chiprun_out")) as tmp:
            out = os.path.join(tmp, "gloo.json")
            procs = [ctx.Process(target=gloo_worker,
                                 args=(r, repo, f"file://{tmp}/store", out, a.size, a.kiters,
                                       a.gloo_pairs)) for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(600)
            if any(p.is_alive() or p.exitcode for p in procs):
                for p in procs:
                    p.kill()
                raise SystemExit("time_banded_pair: a gloo process failed or hung")
            with open(out) as f:
                res["gloo"] = json.load(f)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
