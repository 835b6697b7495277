"""The multi-process path of the port (``parallel.distributed``, ``-nprocs``)
on the CPU: processes of a gloo group over a ``file://`` store in the
test's temporary directory, each spawned (tests/torch_dist_worker.py) and
joined within a time limit.

* ``halo.ProcessExchange`` on 2 processes over 5 uneven bands: every fetch
  (halos, rows across both edges, the whole field) with every fill equals
  ``LocalExchange.fetch`` of the whole field; ``join`` of uneven pieces
  equals the joined tensor of one process, so its sum is one process's
  sum; ``band_values`` gives every band's value on every process;
* the banded warp's reach test over 2 processes: the wide body, which
  fetches the whole level from every band, is entered by both together
  and keeps the single-process banded flow bit for bit;
* ``host_row_block`` and ``distributed_mesh`` (the layout, the default
  one band per process, the refusal of mesh rows that are not a multiple
  of the process count); ``-nprocs 1`` in one process, mirroring
  tests/test_sequence.py:69-82;
* ``-nprocs 2`` through the CLI on the 96 x 128 pair of
  tests/test_distributed.py:30-46: per relaxer the product equals the
  single-process ``-mesh 2x4`` product bit for bit, and octane_tpu's
  single-process product within test_torch_mesh_cli.py's budget (shorts
  within 1 count, 99 % exact); with ``-interp`` on 2 bands of 48 rows
  (the banded frame) the frames and their Occlusion equal the
  single-process frames; on the polar and mercator grids, and with
  channels 2 and 3, the products are equal;
* ``run_sequence_distributed`` on 2 processes, stopped after its first
  pair and resumed, writes what an uninterrupted run writes, and what the
  single-process ``run_sequence`` on the same mesh writes; a resume with
  another process layout, other settings or a reordered frame list is
  refused.

The compared runs use the same number of CPU threads: a CPU sum's order
depends on it.  The slow tests mirror tests/test_distributed.py's
full-featured and sequence runs at its sizes.
"""

import dataclasses
import json
import os

import h5py
import numpy as np
import pytest
import torch

from octane_tpu import cli as jax_cli
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.parallel import distributed
from octane_tpu_torch.parallel.halo import FILLS, LocalExchange
from octane_tpu_torch.parallel.mesh import band_rows
from tests import synth
from tests import torch_dist_worker as worker

torch.set_num_threads(2)
THREADS = 2
LIMIT = 60        # seconds for the processes of one run


def _url(tmp_path, name="store"):
    return f"file://{tmp_path / name}"


# ----------------------------------------------------------------------------
# the exchange over processes
# ----------------------------------------------------------------------------

def test_process_exchange_equals_local_exchange(tmp_path):
    out = str(tmp_path / "probe")
    worker.spawn(worker.in_group, [
        ("tests.torch_dist_worker:exchange_probe", r, 2, _url(tmp_path), THREADS, out, r)
        for r in range(2)], LIMIT)
    got = [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]
    field, bands = worker.probe_field()
    h = field.shape[1]
    local = LocalExchange()
    for fill in FILLS:
        for i, (r0, t) in enumerate(bands):
            for k, (a, b) in enumerate(worker.probe_requests(r0, r0 + t.shape[-2], h)):
                want = local.rows(bands, a, b, "cpu", fill, -7.5)
                np.testing.assert_array_equal(got[worker.PROBE_RANKS[i]][f"{fill}/{i}/{k}"],
                                              want.numpy(), err_msg=f"{fill} band {i} [{a}, {b})")
    for dim in (0, 1):
        want = local.join([t.reshape(-1) if dim == 0 else t for _, t in bands], "cpu", dim)
        for r in range(2):
            np.testing.assert_array_equal(got[r][f"join/{dim}"], want.numpy())
            assert got[r][f"sum/{dim}"] == torch.sum(want).item()
    want = local.band_values([t.abs().amax() for _, t in bands])
    assert torch.is_tensor(want)
    for r in range(2):
        assert got[r]["values"].tolist() == want.tolist()


def test_process_solvers_join_block_partials(tmp_path):
    """The banded SOR and PCG over 2 processes join the bands' 32 x 8 block
    partials, never their planes: ||b||^2 is the whole system's partials'
    sum (the assembly kernel's, as the single-device flow sums them), and
    each process's rows equal one process's banded solve and the
    single-device solve bit for bit."""
    from octane_tpu_torch.ops.pcg import (block_partials, num_partials, pcg_solve_fused,
                                          stack_system)
    from octane_tpu_torch.ops.sor import build_cf, sor_solve_cf
    from octane_tpu_torch.parallel import cg as band_cg
    from octane_tpu_torch.parallel import sor as band_sor

    out = str(tmp_path / "solve")
    worker.spawn(worker.in_group, [
        ("tests.torch_dist_worker:solver_probe", r, 2, _url(tmp_path), THREADS, out, r)
        for r in range(2)], LIMIT)
    got = [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]
    s = worker.solve_system()
    h, w = s.bu.shape
    spans = list(zip(worker.SOLVE_SPLIT[:-1], worker.SOLVE_SPLIT[1:]))
    resid0 = torch.sum(block_partials(s.bu * s.bu + s.bv * s.bv))
    sor = sor_solve_cf(build_cf(s), resid0, 1e-8, 13)
    pcg = pcg_solve_fused(s, 1e-8, 4)
    local = LocalExchange()
    parts = [(r0, build_cf(s)[:, r0:r1]) for r0, r1 in spans]
    assert torch.equal(band_sor.resid0_of(parts, torch.device("cpu"), local), resid0)
    cf, b = stack_system(s)
    one = torch.cat(band_cg.solve_bands([(r0, cf[:, r0:r1].contiguous(),
                                          b[:, r0:r1].contiguous()) for r0, r1 in spans],
                                        h, 1e-8, 4, local), dim=1)
    # the most partials one process holds: process 1's two bands
    n = max(sum(num_partials(r1 - r0, w) for (r0, r1), q in zip(spans, worker.SOLVE_RANKS)
                if q == r) for r in range(2))
    for r in range(2):
        rows = [span for span, q in zip(spans, worker.SOLVE_RANKS) if q == r]
        a, z = rows[0][0], rows[-1][1]
        assert got[r]["resid0"] == resid0.item()
        np.testing.assert_array_equal(got[r]["sor"], torch.stack(sor)[:, a:z].numpy())
        np.testing.assert_array_equal(got[r]["pcg"], one[:, a:z].numpy())
        np.testing.assert_array_equal(got[r]["pcg"], torch.stack(pcg)[:, a:z].numpy())
        assert got[r]["resid0_bytes"] == 4 * n                  # one partial per block
        assert got[r]["pcg1_bytes"] == 4 * (3 + 1 + 2) * n      # first sums, <p, Ap>, rr


REACH_HW = (48, 40)                      # the reach probe's pair


def reach_pair():
    """A smooth pair with a 12-px first guess downwards (beyond the 2-px
    reach of halo_warp 4)."""
    h, w = REACH_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def mk(cx):
        return torch.from_numpy((200 * np.exp(-((xx - cx) ** 2 + (yy - h / 2) ** 2) / 50.0)
                                 + 30 + 5 * np.sin(xx / 5.0) * np.cos(yy / 7.0))
                                .astype(np.float32))

    return mk(w / 2 - 0.5), mk(w / 2 + 0.5), torch.full((h, w), 12.0)


def reach_cfg(solver: str):
    return OFConfig(kiters=2, cgiters=6, solver=solver, halo_warp=4, lambdac=5.0,
                    mesh_shape=(4, 1))


def reach_probe(out: str, rank: int, solver: str) -> None:
    """Run in each process of the group (``worker.in_group``):
    distributed_variational_flow of ``reach_pair`` on 4 bands, the reach
    test's wide body running in every round; saves this process's rows of
    (u, v), the level heights of the wide bodies it ran and the bytes its
    exchange sent to ``out``.rank.npz."""
    from octane_tpu_torch.parallel import sharded

    cfg = reach_cfg(solver)
    g1, g2, v0 = reach_pair()
    mesh = distributed.distributed_mesh(cfg, "cpu")
    ex = distributed.distributed_exchange(mesh)
    r0, r1 = distributed.host_row_block(REACH_HW[0], mesh)
    wide, bodies = sharded._warp_wide, []

    def spy(*args):
        bodies.append(args[2])
        wide(*args)

    sharded._warp_wide = spy
    u, v = distributed.distributed_variational_flow(
        g1[r0:r1], g2[r0:r1], REACH_HW, cfg, mesh, (0 * v0[r0:r1], v0[r0:r1]), ex, "cpu")
    np.savez(f"{out}.{rank}.npz", u=u.numpy(), v=v.numpy(), rows=np.array([r0, r1]),
             bodies=np.array(bodies), sent=np.array(ex.sent["bytes"]))


@pytest.mark.parametrize("solver", ["sor", "pcg"])
def test_process_reach_test_enters_the_wide_body_together(tmp_path, solver):
    """A 12-px first guess beyond the reach of halo_warp 4 on 4 bands over
    2 processes: the reach test is the gathered maximum, the same on both,
    so both enter every wide body (the whole level's sample stack fetched
    from the other's bands) together; each process's rows equal the
    single-process banded flow bit for bit."""
    from octane_tpu_torch.parallel import make_mesh, sharded

    out = str(tmp_path / "reach")
    worker.spawn(worker.in_group, [
        ("tests.test_torch_distributed:reach_probe", r, 2, _url(tmp_path), THREADS, out, r,
         solver) for r in range(2)], LIMIT)
    got = [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]
    cfg = reach_cfg(solver)
    g1, g2, v0 = reach_pair()
    h, w = REACH_HW
    u, v = sharded._coarse_to_fine_banded(g1[None], g2[None], 0 * v0, v0, cfg,
                                          make_mesh((4, 1), [torch.device("cpu")] * 4),
                                          LocalExchange())
    rounds = cfg.kiters * cfg.gnc_steps * cfg.liters
    for r in range(2):
        r0, r1 = got[r]["rows"]
        np.testing.assert_array_equal(got[r]["u"], u[r0:r1].numpy())
        np.testing.assert_array_equal(got[r]["v"], v[r0:r1].numpy())
        assert list(got[r]["bodies"]) == [h // 2] * (rounds // 2) + [h] * (rounds // 2)
    assert got[0]["sent"] > 0 and got[1]["sent"] > 0


# ----------------------------------------------------------------------------
# what a capture over processes needs
# ----------------------------------------------------------------------------

def test_process_collectives_do_not_follow_the_stopping_test(tmp_path):
    """Each of 2 processes records the (op, shapes) sequence of the
    collectives its banded SOR and PCG enter: as a capture walks them, the
    same on both processes, and the same for a solve that stops early (SOR
    before its third pass, PCG after 3 iterations) and one that runs all 30
    iterations, since every transfer runs between the guarded bodies
    whatever the test decides: the property that lets each process capture
    the same collectives.  On the host route the full solve enters the same
    sequence, and the one that stops early enters a shorter prefix of it,
    the same on both processes: no transfer follows the stop."""
    from octane_tpu_torch.ops.pcg import stack_system
    from octane_tpu_torch.ops.sor import build_cf
    from octane_tpu_torch.parallel import sor as band_sor
    from test_torch_sharded_program import pcg_bands_before, sor_bands_before

    s = worker.solve_system()
    h = worker.SOLVE_SPLIT[-1]
    spans = list(zip(worker.SOLVE_SPLIT[:-1], worker.SOLVE_SPLIT[1:]))
    parts = [(r0, build_cf(s)[:, r0:r1].contiguous()) for r0, r1 in spans]
    *_, sor_hist = sor_bands_before(parts, h, band_sor.resid0_of(parts, torch.device("cpu")),
                                    0.0, 30)
    cf, b = stack_system(s)
    *_, pcg_hist = pcg_bands_before([(r0, cf[:, r0:r1].contiguous(), b[:, r0:r1].clone())
                                     for r0, r1 in spans], h, 0.0, 30)
    out = str(tmp_path / "seq")
    worker.spawn(worker.in_group, [
        ("tests.torch_dist_worker:collective_probe", r, 2, _url(tmp_path), THREADS, out, r,
         sor_hist[2], pcg_hist[3]) for r in range(2)], LIMIT)
    got = []
    for r in range(2):
        with open(f"{out}.{r}.json") as f:
            got.append(json.load(f))
    for solver, early, hist in (("sor", 2, sor_hist), ("pcg", 3, pcg_hist)):
        for mode in ("capture", "host"):
            stop, full = f"{mode}/{solver}/{hist[early]}", f"{mode}/{solver}/0.0"
            for r in range(2):
                assert got[r][stop][1] == early
                assert got[r][full][1] == (4 if solver == "sor" else 30)
                assert any(op[0] == "p2p" for op in got[r][full][0])
                if mode == "capture":
                    assert got[r][stop][0] == got[r][full][0]
                else:
                    n = len(got[r][stop][0])
                    assert n < len(got[r][full][0])
                    assert got[r][stop][0] == got[r][full][0][:n]
                    assert got[r][full][0] == got[r][f"capture/{solver}/0.0"][0]
            assert got[0][full][0] == got[1][full][0]
            assert got[0][stop][0] == got[1][stop][0]


def test_process_reach_max_reads_nan_as_beyond(tmp_path):
    """The reach test's maximum over 2 processes is one MAX all-reduce, the
    same on both: a NaN on one band of one process reads as +inf, so every
    process finds the flow beyond reach; within the reach neither does."""
    out = str(tmp_path / "reach")
    worker.spawn(worker.in_group, [
        ("tests.torch_dist_worker:reach_max_probe", r, 2, _url(tmp_path), THREADS, out, r)
        for r in range(2)], LIMIT)
    got = [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]
    for r in range(2):
        assert got[r]["within/max"][0] == 2.0 and not got[r]["within/beyond"][0]
        for case in ("nan", "inf"):
            assert got[r][f"{case}/max"][0] == np.inf and got[r][f"{case}/beyond"][0]


@pytest.mark.parametrize("solver", ["sor", "pcg"])
def test_distributed_flow_matches_jax_sharded_flow(tmp_path, solver):
    """``distributed_variational_flow`` on a (2, 4) mesh over 2 processes
    (through each process's program: eager on the CPU, with its reason)
    against octane_tpu's ``sharded_variational_flow`` on the same mesh of
    the XLA host devices, on the same numpy pair, within 1e-3 px
    (test_torch_mesh_flow.py's budget)."""
    from octane_tpu.config import OFConfig as JaxOFConfig
    from octane_tpu.parallel import sharded as jax_sharded
    from octane_tpu.parallel.mesh import make_mesh as jax_make_mesh

    out = str(tmp_path / "pair")
    worker.spawn(worker.in_group, [
        ("tests.torch_dist_worker:pair_probe", r, 2, _url(tmp_path), THREADS, out, r, solver)
        for r in range(2)], LIMIT)
    im1, im2 = worker.smooth_pair(64, 64)
    z = np.zeros((64, 64), np.float32)
    cfg = OFConfig(kiters=2, cgiters=10, solver=solver, halo_warp=8, mesh_shape=(2, 4))
    jax_sharded._sharded_program_cache.clear()
    ju, jv = (np.asarray(a) for a in jax_sharded.sharded_variational_flow(
        im1, im2, z, z, JaxOFConfig(**dataclasses.asdict(cfg)), jax_make_mesh((2, 4))))
    for r in range(2):
        got = np.load(f"{out}.{r}.npz")
        r0, r1 = got["rows"]
        assert (r0, r1) == ((0, 32) if r == 0 else (32, 64))
        assert str(got["route"]) == "eager" and "cpu" in str(got["reason"])
        np.testing.assert_allclose(got["u"], ju[r0:r1], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got["v"], jv[r0:r1], rtol=0, atol=1e-3)


def test_process_program_routes_and_keys(monkeypatch):
    """The program over processes: "graph" under NCCL on a card, "eager"
    with its reason on the CPU and over gloo (rows staged through host
    memory); keyed on the bands' processes, the backend, the group's size
    and the rank beside the single-process key (whose fields are
    octane_tpu's); it takes this process's row block.  No card is touched,
    no group formed: the exchanges are stand-ins."""
    import types

    from octane_tpu_torch.flow import variational as fv
    from octane_tpu_torch.parallel import sharded

    def exchange(backend, device, rank=1):
        device = torch.device(device)
        return types.SimpleNamespace(ranks=(0, 0, 1, 1), backend=backend, world=2, rank=rank,
                                     device=device, staged=backend == "gloo" and
                                     device.type == "cuda", sent={})

    _as_process(monkeypatch, 1, 2)
    cfg = OFConfig(kiters=2, mesh_shape=(4, 1))
    for backend, device, route, reason in (
            ("nccl", "cuda:1", "graph", "nccl, process 1 of 2 on cuda:1"),
            ("gloo", "cuda:0", "eager", "gloo stages"),
            ("gloo", "cpu", "eager", "cpu")):
        mesh = distributed.distributed_mesh(cfg, device)
        ex = exchange(backend, device)
        prog = sharded.sharded_flow_program(cfg, (40, 24), 1, mesh, exchange=ex)
        info = sharded.last_program_info
        assert info["route"] == route and reason in info["reason"]
        assert prog.captures == (route == "graph") and prog.exchange is ex
        assert prog.shape == (8, 24) and prog.row0 == 32   # bands of 16, 16, 8, 0 rows
        assert info["key"] == sharded.sharded_program_key(cfg, (40, 24), 1, mesh, ex)
        assert info["key"][:-4] == sharded.sharded_program_key(cfg, (40, 24), 1, mesh)
        assert info["key"][-4:] == ((0, 0, 1, 1), backend, 2, 1)
        assert sharded.sharded_flow_program(cfg, (40, 24), 1, mesh,
                                            exchange=exchange(backend, device)) is prog
    assert sharded.sharded_flow_program(cfg, (40, 24), 1, mesh,
                                        exchange=exchange("gloo", "cpu", 0)) is not prog
    assert sharded.sharded_flow_program(cfg, (40, 24), 1, mesh, exchange=LocalExchange()) \
        is sharded.sharded_flow_program(cfg, (40, 24), 1, mesh)
    fv.clear_program_cache()


# ----------------------------------------------------------------------------
# the layout
# ----------------------------------------------------------------------------

def _as_process(monkeypatch, rank, world):
    monkeypatch.setattr(distributed, "process_index", lambda: rank)
    monkeypatch.setattr(distributed, "process_count", lambda: world)


def test_distributed_mesh_and_host_row_block(monkeypatch):
    meta = torch.device("meta")
    _as_process(monkeypatch, 1, 2)
    mesh = distributed.distributed_mesh(OFConfig(mesh_shape=(2, 4)), "cpu")
    assert mesh.shape == (2, 4)
    assert mesh.devices == (meta,) * 4 + (torch.device("cpu"),) * 4
    # bands of 16 rows (ceil(96 / 8) = 12 rounded up to 8): process 1 owns
    # bands 4-7, rows [64, 96) with band 6 the last non-empty one
    assert distributed.host_row_block(96, mesh) == (64, 96)
    assert distributed.host_row_block(100, mesh) == (64, 100)
    assert band_rows(100, 8, 4) == (64, 80)
    mesh = distributed.distributed_mesh(OFConfig(), "cpu")           # one band per process
    assert mesh.shape == (2, 1) and mesh.devices == (meta, torch.device("cpu"))
    # 8-row aligned blocks: 101 rows split 56 / 45, not ceil(101 / 2) = 51
    assert distributed.host_row_block(101, mesh) == (56, 101)
    _as_process(monkeypatch, 0, 2)
    assert distributed.host_row_block(101, distributed.distributed_mesh(OFConfig(), "cpu")) \
        == (0, 56)
    with pytest.raises(ValueError, match="multiple of process count 2"):
        distributed.distributed_mesh(OFConfig(mesh_shape=(3, 2)), "cpu")
    assert distributed.band_ranks(8, 2) == (0, 0, 0, 0, 1, 1, 1, 1)


def test_process_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert distributed.process_device("cuda", 4) == torch.device("cuda", 1)
    assert distributed.process_device("cuda:2", 4) == torch.device("cuda", 2)
    assert distributed.process_device("cpu", 4) == torch.device("cpu")


def test_single_process_roundtrip():
    """tests/test_sequence.py:69-82 with one process (-nprocs 1): no group,
    the process owns every row."""
    h = w = 32
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    im1 = 200 * np.exp(-(((xx - 14) ** 2 + (yy - 16) ** 2) / 16.0)) + 20
    im2 = 200 * np.exp(-(((xx - 16) ** 2 + (yy - 16) ** 2) / 16.0)) + 20
    cfg = OFConfig(kiters=2, cgiters=8, halo_warp=4)
    mesh = distributed.distributed_mesh(cfg, "cpu")
    r0, r1 = distributed.host_row_block(h, mesh)
    assert (r0, r1) == (0, h)
    u, v = distributed.distributed_variational_flow(im1[r0:r1], im2[r0:r1], (h, w), cfg,
                                                    device="cpu")
    assert u.shape == (h, w) and torch.isfinite(u).all()
    assert float(u.max()) > 1.0              # found the eastward motion


# ----------------------------------------------------------------------------
# -nprocs through the CLI
# ----------------------------------------------------------------------------

def _pair(tmp_path):
    """tests/test_distributed.py:30-46's 96 x 128 pair."""
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def scene(s):
        return (3000 + 8000 * np.exp(-(((xx - s - w / 2) ** 2 + (yy - h / 2) ** 2)
                                       / (2 * 14.0 ** 2)))
                + 1500 * np.sin((xx - s) / 7.0) * np.cos(yy / 9.0)).astype(np.int16)

    return (synth.make_goes_file(str(tmp_path / "g1.nc"), scene(0.0), band=13),
            synth.make_goes_file(str(tmp_path / "g2.nc"), scene(2.0), band=13,
                                 t=650000060.0))


def _flat_pair(tmp_path, grid):
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def blob(s):
        return (200 + 55 * np.exp(-(((xx - s - w / 2) ** 2 + (yy - h / 2) ** 2)
                                    / (2 * 14.0 ** 2)))
                + 20 * np.sin((xx - s) / 7.0) * np.cos(yy / 9.0))

    return (synth.make_flat_grid_file(str(tmp_path / "p1.nc"), blob(0.0), grid=grid, lat1=45.0),
            synth.make_flat_grid_file(str(tmp_path / "p2.nc"), blob(2.0), grid=grid,
                                      t=650000060.0, lat1=45.0))


CLI_FLAGS = ["-kiters", "2", "-liters", "2", "-cgiters", "8", "--device", "cpu"]


def _runs(tmp_path, f1, f2, flags):
    """The 2-process product directory and the single-process one (each run
    in spawned processes with the same threads)."""
    argv = ["-i1", f1, "-i2", f2] + CLI_FLAGS + flags
    multi, single = tmp_path / "multi", tmp_path / "single"
    worker.spawn(worker.cli, [
        (argv + ["-o", str(multi), "-interploc", str(tmp_path / "multi_frames"),
                 "-nprocs", "2", "-procid", str(r), "-coordinator", _url(tmp_path)], THREADS)
        for r in range(2)], LIMIT)
    worker.spawn(worker.cli, [
        (argv + ["-o", str(single), "-interploc", str(tmp_path / "single_frames")], THREADS)],
        LIMIT)
    return multi, single


def _same_files(a, b):
    with h5py.File(a) as fa, h5py.File(b) as fb:
        assert sorted(fa) == sorted(fb)
        for k in fb:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k][()], fb[k][()], err_msg=k)
            assert dict(fa[k].attrs).keys() == dict(fb[k].attrs).keys(), k


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_cli_nprocs_equals_the_mesh_product_and_jax(tmp_path, solver):
    f1, f2 = _pair(tmp_path)
    multi, single = _runs(tmp_path, f1, f2, ["-mesh", "2x4", "-solver", solver])
    _same_files(multi / "outfile.nc", single / "outfile.nc")
    assert not os.path.exists(multi / "outfile.nc.tmp")
    jax_out = tmp_path / "jax"
    assert jax_cli.main(["-i1", f1, "-i2", f2, "-o", str(jax_out), "-solver", solver]
                        + CLI_FLAGS[:-2]) == 0
    with h5py.File(multi / "outfile.nc") as fm, h5py.File(jax_out / "outfile.nc") as fj:
        np.testing.assert_array_equal(fm["Rad"][()], fj["Rad"][()])
        for k in ("U", "V", "U_raw", "V_raw"):
            d = np.abs(fm[k][()].astype(np.int64) - fj[k][()].astype(np.int64))
            assert d.max() <= 1, f"{k}: max diff {d.max()}"
            assert (d == 0).mean() >= 0.99, f"{k}: {(d == 0).mean():.4f} exact"


def test_cli_nprocs_interp_frames_equal_the_mesh_frames(tmp_path):
    """2 bands of 48 rows: max_disp 8 gives a splat margin of 40 rows, so
    the frames run banded."""
    f1, f2 = _pair(tmp_path)
    multi, single = _runs(tmp_path, f1, f2, ["-mesh", "2x1", "-solver", "sor", "-pd",
                                             "-interp", "-deltat", "20"])
    _same_files(multi / "outfile.nc", single / "outfile.nc")
    frames = sorted(os.listdir(tmp_path / "single_frames"))
    assert frames == ["outfile_interp1.nc", "outfile_interp2.nc"]
    assert sorted(f for f in os.listdir(tmp_path / "multi_frames") if f.endswith(".nc")) == frames
    for name in frames:
        _same_files(tmp_path / "multi_frames" / name, tmp_path / "single_frames" / name)


@pytest.mark.parametrize("grid,solver", [("polar", "pcg"), ("mercator", "sor")])
def test_cli_nprocs_flat_grids_equal_the_mesh_product(tmp_path, grid, solver):
    f1, f2 = _flat_pair(tmp_path, grid)
    flags = ["-Polar" if grid == "polar" else "-Merc", "-mesh", "2x2", "-solver", solver]
    multi, single = _runs(tmp_path, f1, f2, flags)
    name = "outfile_polar.nc" if grid == "polar" else "outfile_merc.nc"
    _same_files(multi / name, single / name)


def test_cli_nprocs_channels_equal_the_mesh_product(tmp_path):
    """Channels 2 (a band-3-like channel twice as wide, zoomed out) and 3
    (band 8, as wide), each process reading the channel rows its block's
    regrid reads."""
    f1, f2 = _pair(tmp_path)
    h, w = 96, 128
    yy, xx = np.mgrid[0:2 * h, 0:2 * w].astype(np.float32)
    extra = []
    for k, t in enumerate((650000000.0, 650000060.0)):
        wide = (3000 + 1500 * np.sin((xx - 4.0 * k) / 9.0) * np.cos(yy / 11.0)).astype(np.int16)
        extra += ["-ic2" + str(k + 1), synth.make_goes_file(
            str(tmp_path / f"b3_{k}.nc"), wide, band=3, t=t, rad_scale=0.02, rad_offset=-1.0)]
        same = (2000 + 800 * np.cos((xx[::2, ::2] - 2.0 * k) / 7.0)).astype(np.int16)
        extra += ["-ic3" + str(k + 1), synth.make_goes_file(
            str(tmp_path / f"b8_{k}.nc"), same, band=8, t=t, rad_scale=0.0005, rad_offset=3.0)]
    multi, single = _runs(tmp_path, f1, f2, ["-mesh", "2x2", "-solver", "sor"] + extra)
    _same_files(multi / "outfile.nc", single / "outfile.nc")
    with h5py.File(multi / "outfile.nc") as f:
        assert "Rad2" in f and "Rad3" in f


@pytest.mark.slow
def test_cli_nprocs_full_featured(tmp_path):
    """tests/test_distributed.py's full-featured run: CTH, first guess,
    SRSAL and interpolated frames, 2 processes against one, equal."""
    f1, f2 = _pair(tmp_path)
    h, w = 96, 128
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cth = (8000 + 2000 * np.sin(xx / 11.0) * np.cos(yy / 13.0)
           + rng.normal(0, 30, (h, w))).astype(np.float32)
    cthf = synth.make_cth_file(str(tmp_path / "cth.nc"), cth)
    fgf = synth.make_firstguess_file(str(tmp_path / "fg.nc"),
                                     (4.0 + 0.5 * np.sin(yy / 9.0)).astype(np.float32),
                                     (-1.0 + 0.5 * np.cos(xx / 7.0)).astype(np.float32))
    for mesh in ("2x4", "2x1"):
        sub = tmp_path / mesh
        sub.mkdir()
        multi, single = _runs(sub, f1, f2, ["-mesh", mesh, "-i1cth", cthf, "-firstguess", fgf,
                                            "-srsal", "-pd", "-interp", "-deltat", "20"])
        _same_files(multi / "outfile.nc", single / "outfile.nc")
        for name in sorted(os.listdir(sub / "single_frames")):
            _same_files(sub / "multi_frames" / name, sub / "single_frames" / name)


# ----------------------------------------------------------------------------
# sequences
# ----------------------------------------------------------------------------

def _frames(tmp_path, n=3, h=40, w=40):
    """tests/test_sequence.py's blob moving +2 px in x per frame."""
    return [synth.make_goes_file(str(tmp_path / f"f{i}.nc"),
                                 synth.blob_counts(h, w, 16 + 2 * i, 20),
                                 t=650000000.0 + 600.0 * i) for i in range(n)]


def _sequence(tmp_path, files, out, ckpt, solver, nprocs=2, store="store"):
    worker.spawn(worker.in_group, [
        ("tests.torch_dist_worker:sequence_run", r, nprocs, _url(tmp_path, store), THREADS,
         files, str(out), ckpt, solver) for r in range(nprocs)], 2 * LIMIT)


def _check_sequence(tmp_path, files, solver):
    ckpt = str(tmp_path / "seq.ckpt")
    _sequence(tmp_path, files[:2], tmp_path / "resumed", ckpt, solver, store="s1")
    assert os.path.exists(ckpt + ".p0.h5") and os.path.exists(ckpt + ".p1.h5")
    _sequence(tmp_path, files, tmp_path / "resumed", ckpt, solver, store="s2")
    _sequence(tmp_path, files, tmp_path / "straight", "", solver, store="s3")
    from octane_tpu_torch.sequence import run_sequence
    torch.set_num_threads(THREADS)
    run_sequence(files, worker.sequence_cfg(solver).replace(mesh_shape=(2, 1)),
                 outdir=str(tmp_path / "single"), device="cpu")
    for i in range(len(files) - 1):
        name = f"outfile_{i:03d}.nc"
        _same_files(tmp_path / "resumed" / name, tmp_path / "straight" / name)
        _same_files(tmp_path / "resumed" / name, tmp_path / "single" / name)


@pytest.mark.parametrize("solver", ["sor"])
def test_sequence_stopped_and_resumed_equals_uninterrupted(tmp_path, solver):
    _check_sequence(tmp_path, _frames(tmp_path), solver)


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_sequence_mirror_of_the_jax_sequence_run(tmp_path, solver):
    """tests/test_distributed.py's sequence run: 3 frames of 96 x 128."""
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def scene(s):
        return (3000 + 8000 * np.exp(-(((xx - s - w / 2) ** 2 + (yy - h / 2) ** 2)
                                       / (2 * 14.0 ** 2)))
                + 1500 * np.sin((xx - s) / 7.0) * np.cos(yy / 9.0)).astype(np.int16)

    files = [synth.make_goes_file(str(tmp_path / f"g{k}.nc"), scene(2.0 * k), band=13,
                                  t=650000000.0 + 60.0 * k) for k in range(3)]
    _check_sequence(tmp_path, files, solver)


def test_sequence_resume_refusals(tmp_path, monkeypatch):
    """A checkpoint of another process layout, other settings or another
    frame list is refused (octane_tpu's distributed.py:453-479)."""
    files = _frames(tmp_path)
    cfg = worker.sequence_cfg("sor")
    ckpt = str(tmp_path / "seq.ckpt")
    distributed.run_sequence_distributed(files[:2], cfg, outdir=str(tmp_path / "out"),
                                         checkpoint=ckpt, device="cpu")
    assert os.path.exists(ckpt + ".p0.h5")
    with pytest.raises(ValueError, match="different solver settings"):
        distributed.run_sequence_distributed(files, cfg.replace(kiters=3),
                                             outdir=str(tmp_path / "out"), checkpoint=ckpt,
                                             device="cpu")
    with pytest.raises(ValueError, match="different frame list"):
        distributed.run_sequence_distributed([files[1], files[0], files[2]], cfg,
                                             outdir=str(tmp_path / "out"), checkpoint=ckpt,
                                             device="cpu")
    from octane_tpu_torch.sequence import cfg_key
    key = cfg_key(cfg)
    _as_process(monkeypatch, 0, 2)              # rank 0 of 2 reads the same file name
    with pytest.raises(ValueError, match="different process layout"):
        distributed._load_seq_checkpoint(ckpt, key, files, 0, 40)
    _as_process(monkeypatch, 0, 1)
    with pytest.raises(ValueError, match="different process layout"):
        distributed._load_seq_checkpoint(ckpt, key, files, 0, 24)
    idx, u, v = distributed._load_seq_checkpoint(ckpt, key, files, 0, 40)
    assert idx == 0 and u.shape == v.shape == (40, 40)
