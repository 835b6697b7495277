"""The port's pair path end to end on the CPU: ingest, flow, navigation and
the product file, against octane_tpu and the product fixture.

* tests/golden/product_512.npz through ``run_pipeline`` and ``cli.main``:
  shorts within 1 count (test_golden.py:103-136), more than 99.9 % of the
  pixel shorts and 99 % of the wind shorts exact (torch_fixtures.EXACT_SHARE);
* the same 512^2 pair ingested by octane_tpu and carried over with
  ``scene_from_numpy``: the port's flow (u_pix, v_pix) within 1e-4 px of
  octane_tpu's, which is what holds the wind shorts' parity below 99.9 %;
* a 128^2 pair ingested by octane_tpu, carried over with
  ``scene_from_numpy``, through both packages' ``compute_flow``: shorts
  within 1 count;
* the port's reader against octane_tpu's (data, navigation, constants), and
  torch_fixtures.goes_arrays (the no-h5py path on the card) against both;
* the port's writer against octane_tpu's: same variables, dtypes, values
  and attributes for the same scene;
* the CTH + first-guess + SRSAL product path (``-i1cth -firstguess -srsal
  -pd``) through the port's CLI against octane_tpu's ``run_pipeline`` on
  the same 128^2 files, each relaxer, band 13 (CTH on the image grid) and
  band 2 (a 32^2 CTH field zoomed in, bicubic and -nncth), and -ahi with a
  CTH file: Upix/Vpix (the smoothed flow) within 1e-4 px, CTP exact, the
  pixel and wind shorts within 1 count (torch_fixtures.EXACT_SHARE), every
  other variable and every attribute equal;
* patch-match (``-sosm``) and hybrid through ``compute_flow`` against
  octane_tpu's on the 128^2 pair (shorts within 1 count, u_pix within
  5e-3 px), and through the CLI against octane_tpu's ``run_pipeline``;
* temporal interpolation (``do_interp``, ``-interp -interploc``): the
  frames' files against octane_tpu's (t, frdt and Occlusion equal, Rad
  within 1 count), and the writer's interp and oftype-4 products against
  octane_tpu's writer.
"""

import dataclasses
import inspect
import os

import h5py
import numpy as np
import pytest
import torch

from octane_tpu.config import OFConfig as JaxOFConfig
from octane_tpu.flow.dispatcher import compute_flow as jax_compute_flow
from octane_tpu.io.readers import read_scene as jax_read_scene
from octane_tpu.io.writers import write_product as jax_write_product
from octane_tpu.pipeline import run_pipeline as jax_run_pipeline
from octane_tpu_torch import cli, ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow.dispatcher import compute_flow
from octane_tpu_torch.io.datamodel import scene_from_numpy
from octane_tpu_torch.io.readers import read_scene, scene_from_goes_arrays
from octane_tpu_torch.io.writers import write_product
from octane_tpu_torch.pipeline import run_pipeline
from tests import torch_fixtures as fx
from tests.synth import make_cth_file, make_firstguess_file, make_goes_file

torch.set_num_threads(2)
PRODUCT512 = os.path.join(os.path.dirname(__file__), "golden", "product_512.npz")
T0 = fx.FIXTURE_T0


def _jax_cfg(cfg):
    """octane_tpu's OFConfig with the port's settings (the port's fields are
    a subset of octane_tpu's)."""
    return JaxOFConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pair512(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair512")
    f1 = make_goes_file(str(d / "g1.nc"), fx.fixture_counts(0, 0), band=13)
    f2 = make_goes_file(str(d / "g2.nc"), fx.fixture_counts(3.0, -1.5),
                        band=13, t=T0 + 60.0)
    return f1, f2


def _check_product(path):
    want = np.load(PRODUCT512)
    with h5py.File(path) as f:
        for var in ("U", "V", "U_raw", "V_raw"):
            d = np.abs(np.asarray(f[var][()], np.int32) - np.asarray(want[var], np.int32))
            assert d.max() <= 1, f"{var}: max short diff {d.max()}"
            exact = float((d == 0).mean())
            assert exact > fx.EXACT_SHARE[var], f"{var}: {exact:.4f}"


@pytest.mark.parametrize("entry", ["run_pipeline", "cli"])
def test_product_512_fixture(pair512, tmp_path, entry):
    f1, f2 = pair512
    ops.reset_counters()
    if entry == "cli":
        assert cli.main(["-i1", f1, "-i2", f2, "-o", str(tmp_path), "--device", "cpu"]) == 0
    else:
        written = run_pipeline(f1, f2, OFConfig(), outdir=str(tmp_path), device="cpu")
        assert written == [str(tmp_path / "outfile.nc")]
    _check_product(str(tmp_path / "outfile.nc"))
    c = ops.counters()
    assert all(c[k][1] > 0 for k in ops.PATHS["pcg"])   # plain versions on the CPU


def test_cli_sor_recovers_the_shift(pair512, tmp_path):
    """``-solver sor`` through the CLI: warp -> fused assembly -> SOR at
    every level (plain versions on the CPU); the pixel shorts' medians lie
    within 5 counts of the fixture's shift (3.0, -1.5) px."""
    f1, f2 = pair512
    ops.reset_counters()
    assert cli.main(["-i1", f1, "-i2", f2, "-o", str(tmp_path), "--device", "cpu",
                     "-solver", "sor"]) == 0
    with h5py.File(tmp_path / "outfile.nc") as f:
        med = [float(np.median(f[k][()])) for k in ("U_raw", "V_raw")]
    assert abs(med[0] - 300) <= 5 and abs(med[1] + 150) <= 5, med
    c = ops.counters()
    assert all(c[k][1] > 0 for k in ops.PATHS["sor"]) and c["pcg_pass_a"] == (0, 0)


def test_entry_points_default_to_the_card():
    """read_scene, run_pipeline, patch_match_flow (for arrays) and the CLI
    compute on the card unless the caller asks for another device; the
    interpolated frames go where octane_tpu puts them."""
    from octane_tpu_torch.flow.patch_match import patch_match_flow

    from octane_tpu_torch.sequence import run_sequence

    assert inspect.signature(read_scene).parameters["device"].default == "cuda"
    assert inspect.signature(run_sequence).parameters["device"].default == "cuda"
    assert inspect.signature(run_pipeline).parameters["device"].default == "cuda"
    assert inspect.signature(patch_match_flow).parameters["device"].default == "cuda"
    assert cli.build_parser().get_default("device") == "cuda"
    assert (inspect.signature(run_pipeline).parameters["interp_dir"].default
            == inspect.signature(jax_run_pipeline).parameters["interp_dir"].default
            == cli.build_parser().get_default("interploc"))


def test_reader_matches_jax_and_smoke_arrays(pair512):
    f1, _ = pair512
    cfg = OFConfig()
    sc = read_scene(f1, cfg, donav=True, device="cpu")
    js = jax_read_scene(f1, _jax_cfg(cfg), donav=True)
    assert dataclasses.asdict(sc.nav) == dataclasses.asdict(js.nav)
    assert sc.norm_ranges == js.norm_ranges and sc.band == js.band
    assert (sc.t, sc.t_units) == (js.t, js.t_units)
    np.testing.assert_array_equal(sc.raw_counts.numpy(), js.raw_counts)
    np.testing.assert_allclose(sc.data.numpy(), js.data, rtol=0, atol=2e-5)
    np.testing.assert_allclose(sc.lat.numpy(), js.lat, rtol=1e-12)
    np.testing.assert_allclose(sc.lon.numpy(), js.lon, rtol=1e-12)
    # the card has no h5py: chip_smoke.py builds the same scene from arrays
    counts, x, y, nav, t, t_units, band = fx.goes_arrays(
        fx.fixture_counts(0, 0), T0)
    assert dataclasses.asdict(nav) == dataclasses.asdict(sc.nav)
    assert (t, t_units, band) == (sc.t, sc.t_units, int(sc.band[0]))
    sa = scene_from_goes_arrays(counts, x, y, nav, cfg, "cpu", t=t, t_units=t_units,
                                band=band)
    assert torch.equal(sa.data, sc.data) and torch.equal(sa.lat, sc.lat)


@pytest.fixture(scope="module")
def pair128(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair128")
    c1 = fx.fixture_counts(0, 0, 128, 128)
    c2 = fx.fixture_counts(1.5, -0.75, 128, 128)
    f1 = make_goes_file(str(d / "a.nc"), c1, band=13)
    f2 = make_goes_file(str(d / "b.nc"), c2, band=13, t=T0 + 60.0)
    return f1, f2


@pytest.fixture(scope="module")
def jax_pair128(pair128):
    cfg = OFConfig(kiters=3)
    return (cfg, *_jax_flow(*pair128, cfg))


def _jax_flow(f1, f2, cfg):
    """A pair read and solved by octane_tpu: (scene1 fields, scene2 fields,
    the solved scene1)."""
    jcfg = _jax_cfg(cfg)
    s1 = jax_read_scene(f1, jcfg, donav=True)
    s2 = jax_read_scene(f2, jcfg, donav=False)
    s1.nav.g2x_offset, s1.nav.g2y_offset = s2.nav.x_offset, s2.nav.y_offset
    fields1, fields2 = dataclasses.asdict(s1), dataclasses.asdict(s2)
    jax_compute_flow(s1, s2, jcfg)
    return fields1, fields2, s1


def test_flow_512_matches_jax(pair512):
    """The fixture pair's flow against octane_tpu's at 1e-4 px: one m/s
    short is ~3e-4 px, so this bounds how far the wind shorts can move."""
    fields1, fields2, js1 = _jax_flow(*pair512, OFConfig())
    p1 = scene_from_numpy(fields1, "cpu")
    p2 = scene_from_numpy(fields2, "cpu")
    compute_flow(p1, p2, OFConfig())
    for got, want in ((p1.u_pix, js1.u_pix), (p1.v_pix, js1.v_pix)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_compute_flow_matches_jax(jax_pair128):
    cfg, fields1, fields2, js1 = jax_pair128
    p1 = scene_from_numpy(fields1, "cpu")
    p2 = scene_from_numpy(fields2, "cpu")
    assert p1.data.dtype == torch.float32 and p1.lat.dtype == torch.float64
    compute_flow(p1, p2, cfg)
    assert p1.dt == js1.dt == 60.0
    for name in ("u_wind", "v_wind", "u_raw", "v_raw"):
        got = getattr(p1, name)
        assert got.dtype == torch.int16
        d = np.abs(got.numpy().astype(np.int32) - getattr(js1, name).astype(np.int32))
        assert d.max() <= 1, f"{name}: max short diff {d.max()}"
    np.testing.assert_allclose(p1.u_pix.numpy(), js1.u_pix, rtol=0, atol=5e-3)


def _dump(path):
    out = {}
    with h5py.File(path) as f:
        def visit(name, obj):
            attrs = {k: (v.decode() if isinstance(v, bytes) else v)
                     for k, v in obj.attrs.items()
                     if k not in ("DIMENSION_LIST", "REFERENCE_LIST")}
            out[name] = (obj.dtype.str, obj.shape, np.asarray(obj[()]), attrs)
        f.visititems(visit)
    return out


@pytest.mark.parametrize("pixuv", [False, True])
def test_writer_matches_jax(jax_pair128, tmp_path, pixuv):
    cfg, _, _, js1 = jax_pair128
    cfg = cfg.replace(pixuv=pixuv)
    ps1 = scene_from_numpy(dataclasses.asdict(js1), "cpu")
    a = _dump(jax_write_product(str(tmp_path / "jax.nc"), js1, _jax_cfg(cfg)))
    b = _dump(write_product(str(tmp_path / "port.nc"), ps1, cfg))
    assert a.keys() == b.keys()
    for name in a:
        (da, sa, va, aa), (db, sb, vb, ab) = a[name], b[name]
        assert (da, sa) == (db, sb), name
        np.testing.assert_array_equal(va, vb, err_msg=name)
        assert aa.keys() == ab.keys(), name
        for k in aa:
            np.testing.assert_array_equal(aa[k], ab[k], err_msg=f"{name}.{k}")
            assert np.asarray(aa[k]).dtype == np.asarray(ab[k]).dtype, f"{name}.{k}"


def test_unported_options_raise(extras128, tmp_path):
    """Every option is ported: ``-mesh`` parses into the mesh path's config
    (tests/test_torch_mesh_cli.py runs it) and ``-nprocs 1`` runs the
    multi-process path in one process, writing the single-device product's
    variables (tests/test_torch_distributed.py runs 2 processes)."""
    f1, f2 = extras128[13][:2]
    cfg = cli.args_to_config(cli.build_parser().parse_args(
        ["-i1", f1, "-i2", f2, "-o", str(tmp_path), "-mesh", "2x2"]))
    assert cfg.mesh_shape == (2, 2)
    flags = ["-i1", f1, "-i2", f2, "--device", "cpu", "-kiters", "2", "-cgiters", "8"]
    assert cli.main(flags + ["-o", str(tmp_path / "one"), "-nprocs", "1"]) == 0
    assert cli.main(flags + ["-o", str(tmp_path / "single")]) == 0
    with h5py.File(tmp_path / "one" / "outfile.nc") as a, \
            h5py.File(tmp_path / "single" / "outfile.nc") as b:
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["Rad"][()], b["Rad"][()])
        for k in ("U", "V", "U_raw", "V_raw"):
            d = np.abs(a[k][()].astype(np.int64) - b[k][()].astype(np.int64))
            assert d.max() <= 1 and (d == 0).mean() >= 0.99, k


@pytest.fixture(scope="module")
def extras128(tmp_path_factory):
    """Per band: a 128^2 pair shifted by (1.5, -0.75) px, a CLAVR-x CTH file
    on the band's CTH grid (128^2 for band 13, 32^2 for band 2: plateaus 2 km
    apart, within int16 range) and first-guess winds near the true motion
    (~45, ~20 m/s)."""
    out = {}
    for band, ch in ((13, 128), (2, 32)):
        d = tmp_path_factory.mktemp(f"extras{band}")
        f1 = make_goes_file(str(d / "a.nc"), fx.fixture_counts(0, 0, 128, 128), band=band)
        f2 = make_goes_file(str(d / "b.nc"), fx.fixture_counts(1.5, -0.75, 128, 128),
                            band=band, t=T0 + 60.0)
        yy, xx = np.mgrid[0:ch, 0:ch]
        cth = 6000 + 2000.0 * ((xx // (ch // 4) + yy // (ch // 4)) % 3) + 30 * np.sin(xx / 3.0)
        rng = np.random.default_rng(band)
        out[band] = (f1, f2, make_cth_file(str(d / "cth.nc"), cth.astype(np.float32)),
                     make_firstguess_file(str(d / "fg.nc"),
                                          45 + rng.normal(0, 3, (128, 128)),
                                          20 + rng.normal(0, 3, (128, 128))))
    return out


@pytest.mark.parametrize("band,solver,extra", [
    (13, "pcg", []), (13, "sor", []), (2, "pcg", ["-nncth"]), (2, "sor", []),
    (13, "pcg", ["-ahi"])])
def test_cth_firstguess_srsal_product_matches_jax(extras128, tmp_path, band, solver, extra):
    f1, f2, cthf, fgf = extras128[band]
    argv = ["-i1", f1, "-i2", f2, "-i1cth", cthf, "-firstguess", fgf, "-srsal", "-pd",
            "-solver", solver, *extra]
    ops.reset_counters()
    assert cli.main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert ops.counters()["bilateral"] == (0, 1)      # plain version on the CPU
    # -ahi clears do_cth in the config; both pipelines turn it on for the file
    cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
    assert cfg.do_cth == ("-ahi" not in extra)
    jax_run_pipeline(f1, f2, _jax_cfg(cfg), outdir=str(tmp_path / "jax"),
                     cth_file=cthf, firstguess_file=fgf)
    a = _dump(str(tmp_path / "jax" / "outfile.nc"))
    b = _dump(str(tmp_path / "port" / "outfile.nc"))
    assert a.keys() == b.keys() and {"CTP", "Upix", "Vpix"} <= a.keys()
    for name in a:
        (da, sa, va, aa), (db, sb, vb, ab) = a[name], b[name]
        assert (da, sa) == (db, sb), name
        if name in ("Upix", "Vpix"):
            np.testing.assert_allclose(vb, va, rtol=0, atol=1e-4, err_msg=name)
        elif name in fx.EXACT_SHARE:
            d = np.abs(va.astype(np.int32) - vb.astype(np.int32))
            assert d.max() <= 1 and (d == 0).mean() > fx.EXACT_SHARE[name], name
        else:
            np.testing.assert_array_equal(va, vb, err_msg=name)
        assert aa.keys() == ab.keys(), name
        for k in aa:
            np.testing.assert_array_equal(aa[k], ab[k], err_msg=f"{name}.{k}")
    assert b["CTP"][3]["interpcth"] == (0.0 if "-nncth" in extra else 1.0)
    assert b["optical_flow_settings"][3]["dofirstguess"] == 1
    # the smoothing reached the product: Upix is not the unsmoothed flow's
    # 0.01-px shorts
    assert np.abs(b["Upix"][2] - b["U_raw"][2] * 0.01).max() > 0.01


def _assert_products_match(a, b, float_atol=1e-4, within_one_count=()):
    """Two _dump()s: the same variables, dtypes, shapes and attributes; the
    float flow within ``float_atol`` px, the shorts within 1 count
    (torch_fixtures.EXACT_SHARE exact), the variables ``within_one_count``
    within 1 count, every other variable equal."""
    assert a.keys() == b.keys()
    for name in a:
        (da, sa, va, aa), (db, sb, vb, ab) = a[name], b[name]
        assert (da, sa) == (db, sb), name
        if name in within_one_count:
            d = np.abs(va.astype(np.int32) - vb.astype(np.int32))
            assert d.max() <= 1, f"{name}: max count diff {d.max()}"
        elif name in ("Upix", "Vpix"):
            np.testing.assert_allclose(vb, va, rtol=0, atol=float_atol, err_msg=name)
        elif name in fx.EXACT_SHARE:
            d = np.abs(va.astype(np.int32) - vb.astype(np.int32))
            assert d.max() <= 1 and (d == 0).mean() > fx.EXACT_SHARE[name], name
        else:
            np.testing.assert_array_equal(va, vb, err_msg=name)
        assert aa.keys() == ab.keys(), name
        for k in aa:
            np.testing.assert_array_equal(aa[k], ab[k], err_msg=f"{name}.{k}")
            assert np.asarray(aa[k]).dtype == np.asarray(ab[k]).dtype, f"{name}.{k}"


@pytest.mark.parametrize("algorithm,pixuv", [("hybrid", False), ("patch_match", True)])
def test_patch_match_and_hybrid_compute_flow_match_jax(pair128, algorithm, pixuv):
    """compute_flow with algorithm "hybrid" (patch-match initialization,
    then the variational refiner) and "patch_match" (-sosm -pd) against
    octane_tpu's on the same scenes."""
    cfg = OFConfig(kiters=3, algorithm=algorithm, pixuv=pixuv)
    fields1, fields2, js1 = _jax_flow(*pair128, cfg)
    p1 = scene_from_numpy(fields1, "cpu")
    p2 = scene_from_numpy(fields2, "cpu")
    ops.reset_counters()
    compute_flow(p1, p2, cfg)
    c = ops.counters()
    # only the refiner runs the solver's kernels (plain versions on the CPU)
    assert all((c[k][1] > 0) == (algorithm == "hybrid") for k in ops.PATHS["pcg"])
    for name in ("u_wind", "v_wind", "u_raw", "v_raw"):
        d = np.abs(getattr(p1, name).numpy().astype(np.int32)
                   - getattr(js1, name).astype(np.int32))
        assert d.max() <= 1, f"{name}: max short diff {d.max()}"
    for got, want in ((p1.u_pix, js1.u_pix), (p1.v_pix, js1.v_pix)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-3)
    assert abs(float(p1.u_pix[16:-16, 16:-16].median()) - 1.5) < 0.1


def test_patch_match_rejects_multichannel(pair128):
    cfg = OFConfig(algorithm="patch_match")
    s1 = read_scene(pair128[0], cfg, donav=True, device="cpu")
    s2 = read_scene(pair128[1], cfg, donav=False, device="cpu")
    s1.data, s2.data = s1.data.repeat(2, 1, 1), s2.data.repeat(2, 1, 1)
    with pytest.raises(ValueError, match="single-channel"):
        compute_flow(s1, s2, cfg)


@pytest.mark.parametrize("flags", [["-sosm", "-pd"], ["-hybrid"], ["-sosm", "-rad", "1",
                                                                   "-srad", "3"]])
def test_cli_patch_match_matches_jax(pair128, tmp_path, flags):
    f1, f2 = pair128
    argv = ["-i1", f1, "-i2", f2, "-kiters", "3", *flags]
    assert cli.main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
    assert cfg.algorithm == ("hybrid" if "-hybrid" in flags else "patch_match")
    jax_run_pipeline(f1, f2, _jax_cfg(cfg), outdir=str(tmp_path / "jax"))
    a = _dump(str(tmp_path / "jax" / "outfile.nc"))
    b = _dump(str(tmp_path / "port" / "outfile.nc"))
    _assert_products_match(a, b, float_atol=1e-4 if "-sosm" in flags else 5e-3)
    settings = b["optical_flow_settings"]
    assert int(settings[2]) == (4 if "-sosm" in flags else 1)
    if "-sosm" in flags:
        assert settings[3]["Rad"] == cfg.rad and settings[3]["SRad"] == cfg.srad


def _interp_files(written):
    return [w for w in written if "outfile_interp" in os.path.basename(w)]


def test_run_pipeline_interp_matches_jax(pair128, tmp_path):
    """do_interp with deltat 200 s of a 60-s pair's flow scaled to a 600-s
    pair: frames at frt 1/3 and 2/3, as octane_tpu writes them."""
    f1, _ = pair128
    f2 = make_goes_file(str(tmp_path / "b600.nc"), fx.fixture_counts(1.5, -0.75, 128, 128),
                        band=13, t=T0 + 600.0)
    cfg = OFConfig(kiters=2, do_interp=True, deltat=200.0)
    port = run_pipeline(f1, f2, cfg, outdir=str(tmp_path / "port"),
                        interp_dir=str(tmp_path / "port_interp"), device="cpu")
    jax = jax_run_pipeline(f1, f2, _jax_cfg(cfg), outdir=str(tmp_path / "jax"),
                           interp_dir=str(tmp_path / "jax_interp"))
    assert len(port) == len(jax) == 3
    assert [os.path.basename(p) for p in port] == [os.path.basename(p) for p in jax]
    for k, (pj, pp) in enumerate(zip(_interp_files(jax), _interp_files(port))):
        a, b = _dump(pj), _dump(pp)
        assert b["t"][3]["frdt"] == np.float32((k + 1) / 3.0)
        assert b["t"][2] == pytest.approx(T0 + 200.0 * (k + 1))
        assert b["Occlusion"][0] == "<i2"
        # t, frdt and Occlusion equal; Rad requantized from images within 1e-4
        _assert_products_match(a, b, within_one_count=("Rad",))


def test_cli_interploc_is_honoured(pair128, tmp_path, monkeypatch):
    f1, f2 = pair128
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-i1", f1, "-i2", f2, "-o", "out", "-kiters", "2", "-interp",
                     "-deltat", "20", "-interploc", "frames", "--device", "cpu"]) == 0
    assert sorted(os.listdir("frames")) == ["outfile_interp1.nc", "outfile_interp2.nc"]
    assert sorted(os.listdir(".")) == ["frames", "out"]     # no ./interpolation


@pytest.mark.parametrize("kind", ["interp", "oftype4"])
def test_writer_interp_and_patch_match_products_match_jax(jax_pair128, tmp_path, kind):
    cfg, _, _, js1 = jax_pair128
    if kind == "interp":
        rng = np.random.default_rng(4)
        js1 = dataclasses.replace(
            js1, occlusion=rng.integers(0, 3, js1.u_pix.shape).astype(np.int16),
            frdt=1.0 / 3.0, t_interp=js1.t + 20.0)
    else:
        cfg = cfg.replace(algorithm="patch_match", rad=1, srad=3)
    interp = kind == "interp"
    ps1 = scene_from_numpy(dataclasses.asdict(js1), "cpu")
    a = _dump(jax_write_product(str(tmp_path / "jax.nc"), js1, _jax_cfg(cfg), interp=interp))
    b = _dump(write_product(str(tmp_path / "port.nc"), ps1, cfg, interp=interp))
    assert ("Occlusion" in b) == interp and ("frdt" in b["t"][3]) == interp
    _assert_products_match(a, b, float_atol=0.0)
