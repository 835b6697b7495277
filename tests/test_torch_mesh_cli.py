"""``-mesh`` through the port's CLI and dispatcher on the CPU.

* ``-mesh 2x4 --device cpu`` on the 512^2 product fixture pair writes the
  single-device CLI's shorts (within 1 count, torch_fixtures.EXACT_SHARE
  exact), per relaxer, through the band forms (plain versions on the CPU);
* ``-mesh 2x4 -srsal`` runs ``sharded_srsal`` and ``-mesh`` with
  ``-hybrid`` and ``-interp`` writes the single-device products (patch-match
  and interpolation run whole, the refinement on the bands);
* ``-nprocs 1`` runs the multi-process path in one process and writes the
  ``-mesh`` product (tests/test_torch_distributed.py runs 2 processes);
* ``active_mesh`` is None without a mesh, and where too few CUDA devices
  exist (with a warning), and all-CPU bands on ``device="cpu"``.
"""

import os

import h5py
import numpy as np
import pytest
import torch

from octane_tpu_torch import cli, ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow.dispatcher import active_mesh

from tests import torch_fixtures as fx
from tests.synth import make_cth_file, make_goes_file

torch.set_num_threads(2)
T0 = fx.FIXTURE_T0


def _read(path, names=("U", "V", "U_raw", "V_raw")):
    with h5py.File(path) as f:
        return {k: np.asarray(f[k][()]) for k in names if k in f}


def _same_shorts(a, b, exact=None):
    assert a.keys() == b.keys()
    for k in a:
        d = np.abs(a[k].astype(np.int64) - b[k].astype(np.int64))
        assert d.max() <= 1, f"{k}: max diff {d.max()}"
        share = fx.EXACT_SHARE.get(k, 0.999) if exact is None else exact
        assert (d == 0).mean() >= share, f"{k}: {(d == 0).mean():.4f} exact"


def _run(f1, f2, out, *flags):
    os.makedirs(out, exist_ok=True)
    assert cli.main(["-i1", f1, "-i2", f2, "-o", str(out), "--device", "cpu", *flags]) == 0
    return os.path.join(out, "outfile.nc")


@pytest.fixture(scope="module")
def pair512(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh512")
    return (make_goes_file(str(d / "g1.nc"), fx.fixture_counts(0, 0), band=13),
            make_goes_file(str(d / "g2.nc"), fx.fixture_counts(3.0, -1.5), band=13,
                           t=T0 + 60.0))


@pytest.fixture(scope="module")
def pair128(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh128")
    c1 = fx.fixture_counts(0, 0, 128, 128)
    return (make_goes_file(str(d / "a.nc"), c1, band=13),
            make_goes_file(str(d / "b.nc"), fx.fixture_counts(1.5, -0.75, 128, 128),
                           band=13, t=T0 + 60.0),
            make_cth_file(str(d / "cth.nc"), 9000.0 + 10.0 * (c1 - c1.mean()) / c1.std()))


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_cli_mesh_matches_single_device(pair512, tmp_path, solver):
    f1, f2 = pair512
    one = _read(_run(f1, f2, tmp_path / "one", "-solver", solver))
    ops.reset_counters()
    banded = _read(_run(f1, f2, tmp_path / "mesh", "-solver", solver, "-mesh", "2x4"))
    c = ops.counters()
    assert all(c[k][1] > 0 for k in ops.PATHS[f"mesh_{solver}"])
    assert c["warp"] == (0, 0)
    _same_shorts(banded, one, exact=0.99)


def test_cli_mesh_srsal_runs_sharded_srsal(pair128, tmp_path):
    f1, f2, cth = pair128
    flags = ("-i1cth", cth, "-srsal", "-pd", "-solver", "sor")
    one = _read(_run(f1, f2, tmp_path / "one", *flags), ("Upix", "Vpix", "U_raw"))
    ops.reset_counters()
    banded = _read(_run(f1, f2, tmp_path / "mesh", *flags, "-mesh", "1x4"),
                   ("Upix", "Vpix", "U_raw"))
    c = ops.counters()
    assert c["bilateral_band"][1] == 4 and c["bilateral"] == (0, 0)
    for k in one:
        np.testing.assert_allclose(banded[k], one[k], rtol=0, atol=1e-4 if k != "U_raw" else 1)


@pytest.mark.parametrize("flags", [("-hybrid",), ("-interp", "-deltat", "20")])
def test_cli_mesh_hybrid_and_interp_match_single_device(pair128, tmp_path, flags):
    f1, f2, _ = pair128
    extra = ("-interploc", str(tmp_path / "frames_{}")) if "-interp" in flags else ()
    outs = {}
    for name, mesh in (("one", ()), ("mesh", ("-mesh", "2x2"))):
        loc = (extra[0], extra[1].format(name)) if extra else ()
        outs[name] = _read(_run(f1, f2, tmp_path / name, "-solver", "sor", *flags, *loc, *mesh))
        if extra:
            frames = sorted(os.listdir(loc[1]))
            assert len(frames) == 2
            outs[name + "_frame"] = _read(os.path.join(loc[1], frames[0]), ("Rad",))
    _same_shorts(outs["mesh"], outs["one"], exact=0.999)
    if extra:
        np.testing.assert_array_equal(outs["mesh_frame"]["Rad"], outs["one_frame"]["Rad"])


def test_cli_nprocs_still_raises(pair128, tmp_path):
    """-nprocs no longer raises: with one process it writes the -mesh product."""
    f1, f2, _ = pair128
    flags = ("-solver", "sor", "-mesh", "2x2", "-kiters", "2")
    one = _run(f1, f2, tmp_path / "nprocs", *flags, "-nprocs", "1")
    mesh = _run(f1, f2, tmp_path / "mesh", *flags)
    with h5py.File(one) as a, h5py.File(mesh) as b:
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k][()], b[k][()], err_msg=k)
    assert cli.args_to_config(cli.build_parser().parse_args(
        ["-i1", f1, "-i2", f2, "-mesh", "2x4"])).mesh_shape == (2, 4)


def test_active_mesh_rule(monkeypatch):
    assert active_mesh(OFConfig()) is None
    assert active_mesh(OFConfig(mesh_shape=(1, 1)), "cpu") is None
    mesh = active_mesh(OFConfig(mesh_shape=(2, 4)), "cpu")
    assert mesh.shape == (2, 4) and set(mesh.devices) == {torch.device("cpu")}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.warns(RuntimeWarning, match="4 CUDA devices"):
        assert active_mesh(OFConfig(mesh_shape=(2, 2)), "cuda") is None
    mesh = active_mesh(OFConfig(mesh_shape=(1, 2)), "cuda")
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
