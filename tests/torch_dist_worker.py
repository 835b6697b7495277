"""Worker processes of the port's multi-process tests on the CPU.

``spawn(target, argss, timeout)`` starts one process per argument tuple
with the ``spawn`` method, joins them all within ``timeout`` seconds,
kills any left and fails unless every one exited with 0.  The targets
here import torch and the port, never jax, so a worker starts in a few
seconds; their results go to files the test reads.  The process group is
gloo over a ``file://`` store in the test's temporary directory, so
parallel test workers never race for a port.
"""

from __future__ import annotations

import multiprocessing
import time


def spawn(target, argss, timeout: float = 60.0) -> None:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=tuple(a)) for a in argss]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    if hung:
        raise AssertionError(f"{len(hung)} of {len(procs)} workers still ran after {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"workers exited with {codes}")


def cli(argv, threads: int) -> None:
    """``octane_tpu_torch.cli.main(argv)`` with ``threads`` CPU threads (the
    sums of the compared runs must use the same count)."""
    import torch

    torch.set_num_threads(threads)
    from octane_tpu_torch import cli as port_cli

    code = port_cli.main(argv)
    if code:
        raise SystemExit(code)


def in_group(fn: str, rank: int, world: int, url: str, threads: int, *args) -> None:
    """``fn`` ("module:function") called as fn(*args) in rank ``rank`` of a
    gloo group of ``world`` processes at ``url``."""
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=url, world_size=world, rank=rank)
    try:
        mod, name = fn.split(":")
        getattr(importlib.import_module(mod), name)(*args)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# probes run inside a group (``in_group``)
# ----------------------------------------------------------------------------

PROBE_SPLIT = (0, 7, 20, 21, 40, 45)     # uneven bands of a 45-row field
PROBE_RANKS = (0, 0, 1, 1, 1)            # bands 0-1 on process 0, 2-4 on process 1
PROBE_WIDTH = 6


def probe_field(seed: int = 3):
    """The probe's (2, 45, W) field and its bands' [(r0, rows)]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    field = torch.from_numpy(rng.normal(0, 1, (2, PROBE_SPLIT[-1], PROBE_WIDTH))
                             .astype(np.float32))
    return field, [(r0, field[:, r0:r1]) for r0, r1 in zip(PROBE_SPLIT[:-1], PROBE_SPLIT[1:])]


def probe_requests(r0: int, r1: int, h: int):
    """Each band's requests: its halo, the rows above it, rows across the
    top and bottom edges and the whole field."""
    return [(r0 - 3, r1 + 3), (r0 - 10, r0), (-5, 3), (h - 2, h + 4), (0, h)]


def exchange_probe(out: str, rank: int) -> None:
    """Every fetch of ``probe_requests`` with every fill, a join of uneven
    pieces along dims 0 and 1, and the band values, through a
    ProcessExchange; saved to ``out``.rank.npz."""
    import numpy as np
    import torch

    from octane_tpu_torch.parallel.halo import FILLS, ProcessExchange, stub

    ex = ProcessExchange(PROBE_RANKS, "cpu")
    field, bands = probe_field()
    h = field.shape[1]
    parts = [(r0, t if PROBE_RANKS[i] == rank else stub(t.shape[-2]))
             for i, (r0, t) in enumerate(bands)]
    res = {}
    for fill in FILLS:
        reqs = []
        for i, (r0, t) in enumerate(bands):
            for k, (a, b) in enumerate(probe_requests(r0, r0 + t.shape[-2], h)):
                buf = (torch.empty((2, b - a, PROBE_WIDTH)) if PROBE_RANKS[i] == rank else None)
                reqs.append((i, a, b, buf))
                if buf is not None:
                    res[f"{fill}/{i}/{k}"] = buf
        ex.fetch_bands(parts, reqs, fill=fill, value=-7.5)
    mine = [i for i, r in enumerate(PROBE_RANKS) if r == rank]
    for dim in (0, 1):
        pieces = [bands[i][1].reshape(-1) if dim == 0 else bands[i][1] for i in mine]
        joined = ex.join(pieces, "cpu", dim, key=("probe", dim))
        res[f"join/{dim}"] = joined
        res[f"sum/{dim}"] = torch.sum(joined)
    res["values"] = ex.band_values(
        [bands[i][1].abs().amax() if PROBE_RANKS[i] == rank else None for i in range(5)])
    np.savez(f"{out}.{rank}.npz", **{k: v.numpy() for k, v in res.items()})


SOLVE_SPLIT = (0, 16, 32, 44)            # 8-row aligned bands of a 44-row system
SOLVE_RANKS = (0, 1, 1)
SOLVE_WIDTH = 40                         # two 32-column reduction blocks


def solve_system(seed: int = 6):
    """A robust (non-quadratic) StencilSystem of SOLVE_SPLIT[-1] x SOLVE_WIDTH."""
    import numpy as np
    import torch

    from octane_tpu_torch.flow.stencil import StencilSystem

    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (SOLVE_SPLIT[-1], SOLVE_WIDTH))
                                .astype(np.float32))

    return StencilSystem(arr(4.5, 9.0), arr(-0.2, 0.2), arr(4.5, 9.0),
                         *(-arr(0.3, 1.0) for _ in range(4)), arr(-100, 100), arr(-100, 100))


def solver_probe(out: str, rank: int) -> None:
    """The banded SOR (||b||^2, then 13 sweeps) and PCG (1 and 4 iterations)
    of ``solve_system`` over SOLVE_RANKS' processes; saves this process's
    rows of each solution, ||b||^2 and the bytes that the SOR's ||b||^2 join
    and the 1-iteration PCG's joins gathered from it to ``out``.rank.npz."""
    import numpy as np
    import torch

    from octane_tpu_torch.ops.pcg import stack_system
    from octane_tpu_torch.ops.sor import build_cf
    from octane_tpu_torch.parallel import cg as band_cg
    from octane_tpu_torch.parallel import sor as band_sor
    from octane_tpu_torch.parallel.halo import ProcessExchange, stub

    ex = ProcessExchange(SOLVE_RANKS, "cpu")
    s = solve_system()
    h = SOLVE_SPLIT[-1]
    spans = list(zip(SOLVE_SPLIT[:-1], SOLVE_SPLIT[1:]))

    def banded(t):
        return [(r0, t[..., r0:r1, :].contiguous() if SOLVE_RANKS[i] == rank else stub(r1 - r0))
                for i, (r0, r1) in enumerate(spans)]

    def own_rows(x):
        return torch.cat([t for t in x if t is not None], dim=1)

    res = {}
    parts = banded(build_cf(s))
    g0 = ex.sent["gathered"]
    res["resid0"] = band_sor.resid0_of(parts, torch.device("cpu"), ex)
    res["resid0_bytes"] = torch.tensor(ex.sent["gathered"] - g0)
    res["sor"] = own_rows(band_sor.solve_bands(parts, h, res["resid0"], 1e-8, 13,
                                               exchange=ex))
    cf, b = stack_system(s)
    systems = [(r0, c, None if c.is_meta else b[:, r0:r0 + c.shape[-2]].contiguous())
               for r0, c in banded(cf)]
    g0 = ex.sent["gathered"]
    band_cg.solve_bands(systems, h, 1e-8, 1, ex)
    res["pcg1_bytes"] = torch.tensor(ex.sent["gathered"] - g0)
    res["pcg"] = own_rows(band_cg.solve_bands(systems, h, 1e-8, 4, ex))
    np.savez(f"{out}.{rank}.npz", **{k: v.numpy() for k, v in res.items()})


def sequence_run(files, outdir: str, checkpoint: str, solver: str) -> None:
    """``run_sequence_distributed`` on the CPU with the test's settings."""
    from octane_tpu_torch.parallel.distributed import run_sequence_distributed

    run_sequence_distributed(list(files), sequence_cfg(solver), outdir=outdir,
                             checkpoint=checkpoint or None, device="cpu")


def sequence_cfg(solver: str):
    from octane_tpu_torch.config import OFConfig

    return OFConfig(kiters=2, liters=2, cgiters=8, lambdac=0.1, solver=solver)


def card_flow(rank: int, url: str, backend: str, out: str, solver: str) -> None:
    """Process ``rank`` of 2 on the card (gloo on cuda:0, or nccl on
    cuda:rank): its row block of the 512^2 product fixture pair through
    ``scene_from_goes_arrays(row_range=)``, then
    ``distributed_variational_flow``; saves its rows, its block and its
    kernel counters to ``out``.rank.npz."""
    import numpy as np

    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.io.readers import scene_from_goes_arrays
    from octane_tpu_torch.parallel import distributed
    from torch_fixtures import FIXTURE_T0, fixture_counts, goes_arrays

    device = "cuda" if backend == "nccl" else "cuda:0"
    distributed.initialize_multihost(url, 2, rank, backend, device)
    try:
        cfg = OFConfig(kiters=3, solver=solver)
        mesh = distributed.distributed_mesh(cfg, device)
        dev = distributed.own_device(mesh)
        rows = distributed.host_row_block(512, mesh)
        s1, s2 = (scene_from_goes_arrays(*goes_arrays(fixture_counts(*shift), t)[:4], cfg, dev,
                                         donav=False, t=t, row_range=rows)
                  for shift, t in (((0, 0), FIXTURE_T0), ((3.0, -1.5), FIXTURE_T0 + 60.0)))
        ops.reset_counters()
        u, v = distributed.distributed_variational_flow(s1.data, s2.data, (512, 512), cfg, mesh)
        c = ops.counters()
        np.savez(f"{out}.{rank}.npz", u=u.cpu().numpy(), v=v.cpu().numpy(), rows=np.array(rows),
                 launches=np.array([c[k][0] for k in ops.PATHS[f"mesh_{solver}"]]),
                 plain=np.array([c[k][1] for k in ops.WRAPPERS]))
    finally:
        distributed.shutdown_multihost()


def collective_probe(out: str, rank: int, sor_tol: float, pcg_tol: float) -> None:
    """The banded SOR and PCG of ``solve_system`` over SOLVE_RANKS'
    processes, each at a tolerance that stops it early and at 0 (every
    pass and iteration), each with a new exchange, on the host route and
    as a capture walks them (``ops.guard``'s IF nodes stood in for by
    bodies run where their predicate holds, on the host); records the
    collectives this process enters as [op, shapes] (a batch of sends and
    receives as its messages' shapes, sorted); saves {"mode/solver/tol":
    [sequence, count]} to ``out``.rank.json."""
    import json

    import torch
    import torch.distributed as dist

    from octane_tpu_torch.ops import guard
    from octane_tpu_torch.ops.pcg import stack_system
    from octane_tpu_torch.ops.sor import build_cf
    from octane_tpu_torch.parallel import cg as band_cg
    from octane_tpu_torch.parallel import sor as band_sor
    from octane_tpu_torch.parallel.halo import ProcessExchange, stub

    seq = []

    def wrap(name, describe):
        fn = getattr(dist, name)

        def recorded(*args, **kwargs):
            seq.append(describe(*args, **kwargs))
            return fn(*args, **kwargs)
        setattr(dist, name, recorded)

    wrap("batch_isend_irecv", lambda ops: ["p2p"] + sorted(str(tuple(op.tensor.shape))
                                                           for op in ops))
    wrap("all_gather", lambda outs, t, *a, **k: ["all_gather", str(tuple(t.shape))])
    wrap("all_reduce", lambda t, *a, **k: ["all_reduce", str(tuple(t.shape)),
                                           str(k.get("op", "sum"))])
    wrap("all_gather_object", lambda *a, **k: ["all_gather_object"])
    s = solve_system()
    h = SOLVE_SPLIT[-1]
    spans = list(zip(SOLVE_SPLIT[:-1], SOLVE_SPLIT[1:]))

    def banded(t):
        return [(r0, t[..., r0:r1, :].contiguous() if SOLVE_RANKS[i] == rank else stub(r1 - r0))
                for i, (r0, r1) in enumerate(spans)]

    def if_node(pred, body, tally, index=0):
        if bool(pred):
            body()

    res = {}
    for mode in ("host", "capture"):
        if mode == "capture":
            guard.capturing = lambda device: True
            guard._if_node = if_node
        for solver, tol in (("sor", sor_tol), ("sor", 0.0), ("pcg", pcg_tol), ("pcg", 0.0)):
            ex = ProcessExchange(SOLVE_RANKS, "cpu")
            count = torch.zeros((), dtype=torch.int32)
            seq.clear()
            if solver == "sor":
                parts = banded(build_cf(s))
                band_sor.solve_bands(parts, h, band_sor.resid0_of(parts, torch.device("cpu"),
                                                                  ex),
                                     tol, 30, exchange=ex, count=count)
            else:
                cf, b = stack_system(s)
                systems = [(r0, c, None if c.is_meta else b[:, r0:r0 + c.shape[-2]].contiguous())
                           for r0, c in banded(cf)]
                band_cg.solve_bands(systems, h, tol, 30, ex, count=count)
            res[f"{mode}/{solver}/{tol}"] = [list(seq), int(count)]
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def reach_max_probe(out: str, rank: int) -> None:
    """The reach test's maximum over PROBE_RANKS' 5 bands: every band's
    max |v| within the reach, then one band of process 1 holding a NaN,
    then one holding +inf; saves each maximum and each process's test."""
    import numpy as np
    import torch

    from octane_tpu_torch.parallel import sharded
    from octane_tpu_torch.parallel.halo import ProcessExchange

    ex = ProcessExchange(PROBE_RANKS, "cpu")
    cpu = torch.device("cpu")
    res = {}
    for case, bad in (("within", None), ("nan", float("nan")), ("inf", float("inf"))):
        vs = [torch.full((3, PROBE_WIDTH), 0.5 * i) if PROBE_RANKS[i] == rank else None
              for i in range(len(PROBE_RANKS))]
        if bad is not None and vs[3] is not None:
            vs[3][1, 2] = bad
        res[f"{case}/max"] = ex.band_max([None if v is None else v.abs().amax() for v in vs],
                                         [cpu])[cpu].reshape(1)
        res[f"{case}/beyond"] = sharded._beyond_reach(vs, ex, 6, [cpu])[cpu].reshape(1)
    np.savez(f"{out}.{rank}.npz", **{k: v.numpy() for k, v in res.items()})


def smooth_pair(h: int, w: int, shift: float = 2.0):
    """A smooth (h, w) pair shifted by ``shift`` px along x (numpy float32)."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def mk(cx):
        return (200 * np.exp(-(((xx - cx) ** 2 + (yy - h / 2) ** 2) / (2 * (w / 10) ** 2)))
                + 30 + 5 * np.sin(xx / 5.0) * np.cos(yy / 7.0)).astype(np.float32)

    return mk(w / 2 - shift / 2), mk(w / 2 + shift / 2)


def pair_probe(out: str, rank: int, solver: str) -> None:
    """``distributed_variational_flow`` of ``smooth_pair(64, 64)`` on a (2, 4)
    mesh over the group's processes, through the process's program (the
    eager route on the CPU); saves this process's rows and the program's
    route to ``out``.rank.npz."""
    import numpy as np

    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.parallel import distributed, sharded

    cfg = OFConfig(kiters=2, cgiters=10, solver=solver, halo_warp=8, mesh_shape=(2, 4))
    im1, im2 = smooth_pair(64, 64)
    mesh = distributed.distributed_mesh(cfg, "cpu")
    r0, r1 = distributed.host_row_block(64, mesh)
    u, v = distributed.distributed_variational_flow(im1[r0:r1], im2[r0:r1], (64, 64), cfg, mesh,
                                                    device="cpu")
    info = sharded.last_program_info
    np.savez(f"{out}.{rank}.npz", u=u.numpy(), v=v.numpy(), rows=np.array([r0, r1]),
             route=np.array(info["route"]), reason=np.array(info["reason"]))


def card_program(rank: int, url: str, out: str, solver: str) -> None:
    """Process ``rank`` of 2 over NCCL, one card each: its row block of the
    512^2 fixture pair through ``distributed_variational_flow`` three times
    (the eager first call, the capture, a replay under sync-debug "error")
    and once through the program's eager route; saves the replay's and the
    eager rows, the route, and each run's launches, iterations and host
    reads to ``out``.rank.npz."""
    import numpy as np
    import torch

    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.io.readers import scene_from_goes_arrays
    from octane_tpu_torch.parallel import distributed, sharded
    from torch_fixtures import FIXTURE_T0, fixture_counts, goes_arrays

    distributed.initialize_multihost(url, 2, rank, "nccl", "cuda")
    try:
        cfg = OFConfig(kiters=3, solver=solver)
        mesh = distributed.distributed_mesh(cfg, "cuda")
        dev = distributed.own_device(mesh)
        rows = distributed.host_row_block(512, mesh)
        s1, s2 = (scene_from_goes_arrays(*goes_arrays(fixture_counts(*shift), t)[:4], cfg, dev,
                                         donav=False, t=t, row_range=rows)
                  for shift, t in (((0, 0), FIXTURE_T0), ((3.0, -1.5), FIXTURE_T0 + 60.0)))
        ex = distributed.distributed_exchange(mesh)
        key = "pcg_iterations" if solver == "pcg" else "sor_passes"

        def counted(run, strict=False):
            ops.reset_counters()
            sharded.guard_reads.reads = 0
            torch.cuda.synchronize()
            if strict:          # no host read between the first launch and the result
                torch.cuda.set_sync_debug_mode("error")
            try:
                u, v = run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            c = ops.counters()
            return u, v, [c[k][0] for k in ops.WRAPPERS] + [
                c[key], c[f"{solver}_host_syncs"] + sharded.guard_reads.reads]

        def flow():
            return distributed.distributed_variational_flow(s1.data, s2.data, (512, 512), cfg,
                                                            mesh, exchange=ex)

        first = flow()
        flow()                                  # the capture
        u, v, replay = counted(flow, strict=True)
        prog = sharded.sharded_flow_program(cfg, (512, 512), 1, mesh, exchange=ex)
        z = torch.zeros((rows[1] - rows[0], 512), device=dev)
        eu, ev, eager = counted(lambda: prog._eager(s1.data, s2.data, z, z))
        np.savez(f"{out}.{rank}.npz", u=u.cpu().numpy(), v=v.cpu().numpy(),
                 eu=eu.cpu().numpy(), ev=ev.cpu().numpy(), fu=first[0].cpu().numpy(),
                 fv=first[1].cpu().numpy(), rows=np.array(rows), replay=np.array(replay),
                 eager=np.array(eager), route=np.array(sharded.last_program_info["route"]))
    finally:
        distributed.shutdown_multihost()
