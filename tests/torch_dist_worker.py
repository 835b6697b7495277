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
    res["values"] = torch.tensor(ex.band_values(
        [bands[i][1].abs().amax() if PROBE_RANKS[i] == rank else None for i in range(5)]))
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
    cf, b = band_cg.system_bands(s, slice(None))
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
