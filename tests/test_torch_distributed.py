"""The multi-process path of the port (``parallel.distributed``, ``-nprocs``)
on the CPU: processes of a gloo group over a ``file://`` store in the
test's temporary directory, each spawned (tests/torch_dist_worker.py) and
joined within a time limit.

* ``halo.ProcessExchange`` on 2 processes over 5 uneven bands: every fetch
  (halos, rows across both edges, the whole field) with every fill equals
  ``LocalExchange.fetch`` of the whole field; ``join`` of uneven pieces
  equals the joined tensor of one process, so its sum is one process's
  sum; ``band_values`` gives every band's value on every process;
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
    for r in range(2):
        assert got[r]["values"].tolist() == want


def test_process_solvers_join_block_partials(tmp_path):
    """The banded SOR and PCG over 2 processes join the bands' 32 x 8 block
    partials, never their planes: ||b||^2 is the whole system's partials'
    sum (the assembly kernel's, as the single-device flow sums them), and
    each process's rows equal one process's banded solve and the
    single-device solve bit for bit."""
    from octane_tpu_torch.ops.pcg import block_partials, num_partials, pcg_solve_fused
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
    cf, b = band_cg.system_bands(s, slice(None))
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
    from octane_tpu_torch.sequence import _cfg_key
    key = _cfg_key(cfg)
    _as_process(monkeypatch, 0, 2)              # rank 0 of 2 reads the same file name
    with pytest.raises(ValueError, match="different process layout"):
        distributed._load_seq_checkpoint(ckpt, key, files, 0, 40)
    _as_process(monkeypatch, 0, 1)
    with pytest.raises(ValueError, match="different process layout"):
        distributed._load_seq_checkpoint(ckpt, key, files, 0, 24)
    idx, u, v = distributed._load_seq_checkpoint(ckpt, key, files, 0, 40)
    assert idx == 0 and u.shape == v.shape == (40, 40)
