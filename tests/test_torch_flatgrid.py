"""Polar and mercator grids in the port on the CPU, against octane_tpu.

* ``nav.polar.polar_latlon`` (pole and non-pole, rho = 0 included) and
  ``nav.mercator.mercator_latlon`` within 1e-12 deg of octane_tpu's (float64
  in both: x64 is on in the tests);
* ``nav.winds.pix2uv_ms`` on both grids within 1e-9 m/s;
* ``io.readers.read_scene`` on flat files: NavConstants equal, the data (raw
  float32, no 0-255 normalisation) equal, lat/lon within 1e-12 deg; and the
  file half equal to ``scene_from_flat_arrays`` (the path on the card);
* the flat product writer: the same variables, dtypes, values and
  attributes as octane_tpu's for the same scene;
* the flat pipeline on octane_tpu's 40^2 TestFlatGridPipeline pairs, polar
  and mercator, each relaxer: U/V float64 within 1e-3 m/s of octane_tpu's
  (but within 3 km of a pole on the grid, where the wind's longitude is
  ill-conditioned), named ``outfile_polar.nc`` / ``outfile_merc.nc``;
* ``nav.winds.uv2pix`` with grid "polar" / "mercator": navigated back through
  the GOES fixed grid, as octane_tpu does (it ignores ``grid``), within 1
  float32 ulp of octane_tpu's;
* the CLI's -Polar and -Merc write what run_pipeline writes;
* three faults the port had on flat grids, each against octane_tpu: image
  2's offsets copied into scene 1 on every grid (so a flat first guess was
  navigated where octane_tpu's sector-move guard zeroes it), the product
  and frame names without the grid's suffix, and interpolated frames
  requantized into int16 where flat grids keep float32 counts.
"""

import dataclasses
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octane_tpu.pipeline as jax_pipeline
from octane_tpu.config import OFConfig as JaxOFConfig
from octane_tpu.io.datamodel import NavConstants as JaxNav
from octane_tpu.io.readers import read_scene as jax_read_scene
from octane_tpu.io.writers import write_product as jax_write_product
from octane_tpu.nav.mercator import mercator_latlon as jax_mercator_latlon
from octane_tpu.nav.polar import polar_latlon as jax_polar_latlon
from octane_tpu.nav.winds import pix2uv_ms as jax_pix2uv_ms
from octane_tpu.nav.winds import uv2pix as jax_uv2pix
from octane_tpu_torch import cli, ops
import octane_tpu_torch.pipeline as pipeline
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.io.datamodel import NavConstants, scene_from_numpy
from octane_tpu_torch.io.readers import read_scene, scene_from_flat_arrays
from octane_tpu_torch.io.writers import write_product
from octane_tpu_torch.nav.mercator import mercator_latlon
from octane_tpu_torch.nav.polar import polar_latlon
from octane_tpu_torch.nav.winds import pix2uv_ms, uv2pix
from tests.synth import make_firstguess_file, make_flat_grid_file

torch.set_num_threads(2)


def _jax_cfg(cfg):
    return JaxOFConfig(**dataclasses.asdict(cfg))


def _navs(**kw):
    return NavConstants(**kw), JaxNav(**kw)


def _grid_metres(h=33, w=41, step=25000.0):
    """Projected metres on a grid that holds x = y = 0 (rho = 0)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    return (xx - w // 2) * step, (yy - h // 2) * step * 0.8


@pytest.mark.parametrize("lat1,lon0", [(90.0, 0.0), (90.0, -45.0), (60.0, 10.0),
                                       (-70.0, 100.0)])
def test_polar_latlon_matches_jax(lat1, lon0):
    xg, yg = _grid_metres()
    nav, jnav = _navs(grid="polar", lat1=lat1, lon0_deg=lon0, R=6371000.0)
    lat, lon = polar_latlon(torch.from_numpy(xg), torch.from_numpy(yg), nav)
    jlat, jlon = jax_polar_latlon(jnp.asarray(xg), jnp.asarray(yg), jnav)
    assert lat.dtype == lon.dtype == torch.float64
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), rtol=0, atol=1e-12)
    np.testing.assert_allclose(lon.numpy(), np.asarray(jlon), rtol=0, atol=1e-12)
    centre = (xg == 0) & (yg == 0)
    assert centre.sum() == 1 and lat.numpy()[centre][0] == pytest.approx(lat1, abs=1e-12)


@pytest.mark.parametrize("lon1_deg", [0.0, -120.0])
def test_mercator_latlon_matches_jax(lon1_deg):
    xg, yg = _grid_metres(step=150000.0)
    nav, jnav = _navs(grid="mercator", lon1=lon1_deg * np.pi / 180.0, R=6371000.0)
    lat, lon = mercator_latlon(torch.from_numpy(xg), torch.from_numpy(yg), nav)
    jlat, jlon = jax_mercator_latlon(jnp.asarray(xg), jnp.asarray(yg), jnav)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), rtol=0, atol=1e-12)
    np.testing.assert_allclose(lon.numpy(), np.asarray(jlon), rtol=0, atol=1e-12)


@pytest.mark.parametrize("grid,extra", [("polar", dict(lat1=90.0)),
                                        ("polar", dict(lat1=60.0, lon0_deg=-30.0)),
                                        ("mercator", dict(lon1=0.3))])
def test_pix2uv_ms_matches_jax(grid, extra):
    h, w = 40, 52
    kw = dict(grid=grid, nx=w, ny=h, x_scale=2000.0, x_offset=-2000.0 * w / 2,
              y_scale=2000.0, y_offset=-2000.0 * h / 2, R=6371000.0, **extra)
    nav, jnav = _navs(**kw)
    rng = np.random.default_rng(3)
    u = rng.uniform(-4, 4, (h, w)).astype(np.float32)
    v = rng.uniform(-4, 4, (h, w)).astype(np.float32)
    uw, vw = pix2uv_ms(torch.from_numpy(u), torch.from_numpy(v), nav, 600.0, grid=grid)
    juw, jvw = jax_pix2uv_ms(u, v, jnav, 600.0, grid=grid)
    assert uw.dtype == vw.dtype == torch.float64
    for got, want in ((uw, juw), (vw, jvw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)
    assert float(uw.abs().max()) > 1.0       # no limb mask on flat grids


def _blob(cx, h=40, w=40):
    """octane_tpu's TestFlatGridPipeline scene (tests/test_io.py:134-143)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return 200 * np.exp(-(((xx - cx) ** 2 + (yy - 20) ** 2) / 32.0)) + 20


@pytest.fixture(scope="module")
def flat_pairs(tmp_path_factory):
    """Per grid: the 40^2 pair of octane_tpu's flat pipeline test (+2 px in
    x over 600 s), polar at the pole, polar at 60 N, and mercator."""
    out = {}
    for name, grid, kw in (("polar", "polar", {}), ("polar60", "polar", dict(lat1=60.0,
                                                                            lon0=-30.0)),
                           ("mercator", "mercator", dict(lon1=-75.0))):
        d = tmp_path_factory.mktemp(name)
        out[name] = (grid,
                     make_flat_grid_file(str(d / "p1.nc"), _blob(18), grid=grid, t=0.0, **kw),
                     make_flat_grid_file(str(d / "p2.nc"), _blob(20), grid=grid, t=600.0, **kw))
    return out


@pytest.mark.parametrize("name", ["polar", "polar60", "mercator"])
def test_read_flat_scene_matches_jax(flat_pairs, name):
    grid, f1, _ = flat_pairs[name]
    cfg = OFConfig(grid=grid)
    sc = read_scene(f1, cfg, donav=True, device="cpu")
    js = jax_read_scene(f1, _jax_cfg(cfg), donav=True)
    assert dataclasses.asdict(sc.nav) == dataclasses.asdict(js.nav)
    assert (sc.t, sc.t_units) == (js.t, js.t_units)
    assert sc.norm_ranges == js.norm_ranges and sc.band == js.band
    assert sc.data.dtype == sc.raw_counts.dtype == torch.float32
    np.testing.assert_array_equal(sc.data.numpy(), js.data)      # raw, not normalised
    np.testing.assert_array_equal(sc.raw_counts.numpy(), js.raw_counts)
    np.testing.assert_array_equal(sc.x.numpy(), js.x)
    assert sc.lat.dtype == torch.float64
    np.testing.assert_allclose(sc.lat.numpy(), js.lat, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sc.lon.numpy(), js.lon, rtol=0, atol=1e-12)
    # the array half is the whole of the reader but the h5py reads
    with h5py.File(f1) as f:
        data, x, y = f["Rad"][()], f["x"][()], f["y"][()]
    sa = scene_from_flat_arrays(data, x, y, sc.nav, cfg, "cpu", t=sc.t, t_units=sc.t_units)
    assert torch.equal(sa.data, sc.data) and torch.equal(sa.lat, sc.lat)
    assert torch.equal(sa.lon, sc.lon) and torch.equal(sa.raw_counts, sc.raw_counts)


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


def _assert_same_files(a, b, close=None):
    """Two _dump()s: the same variables, dtypes, shapes and attributes; the
    variables named in ``close`` within its tolerance, every other equal."""
    close = close or {}
    assert a.keys() == b.keys()
    for name in a:
        (da, sa, va, aa), (db, sb, vb, ab) = a[name], b[name]
        assert (da, sa) == (db, sb), name
        if name in close:
            np.testing.assert_allclose(vb, va, rtol=0, atol=close[name], err_msg=name)
        else:
            np.testing.assert_array_equal(va, vb, err_msg=name)
        assert aa.keys() == ab.keys(), name
        for k in aa:
            np.testing.assert_array_equal(aa[k], ab[k], err_msg=f"{name}.{k}")
            assert np.asarray(aa[k]).dtype == np.asarray(ab[k]).dtype, f"{name}.{k}"


@pytest.mark.parametrize("kind", ["ms", "pixuv", "interp"])
@pytest.mark.parametrize("name", ["polar60", "mercator"])
def test_flat_writer_matches_jax(flat_pairs, tmp_path, name, kind):
    """The same scene written by both writers: U/V float64 m/s (or
    Upix/Vpix with -pd), Rad float32, the grid's projection variable."""
    grid, f1, _ = flat_pairs[name]
    cfg = OFConfig(grid=grid, pixuv=kind == "pixuv")
    js = jax_read_scene(f1, _jax_cfg(cfg), donav=True)
    rng = np.random.default_rng(6)
    js.u_pix = rng.normal(2, 1, js.data.shape[1:]).astype(np.float32)
    js.v_pix = rng.normal(0, 1, js.data.shape[1:]).astype(np.float32)
    js.dt = 600.0
    if kind != "pixuv":
        js.u_ms = rng.normal(3, 1, js.u_pix.shape)
        js.v_ms = rng.normal(0, 1, js.u_pix.shape)
    interp = kind == "interp"
    if interp:
        js.occlusion = rng.integers(0, 3, js.u_pix.shape).astype(np.int16)
        js.frdt, js.t_interp = 1.0 / 3.0, 200.0
    ps = scene_from_numpy(dataclasses.asdict(js), "cpu")
    a = _dump(jax_write_product(str(tmp_path / "jax.nc"), js, _jax_cfg(cfg), interp=interp))
    b = _dump(write_product(str(tmp_path / "port.nc"), ps, cfg, interp=interp))
    _assert_same_files(a, b)
    proj = "polar_imager_projection" if grid == "polar" else "merc_imager_projection"
    assert proj in b and b["Rad"][0] == "<f4"
    assert ("U" in b) == (kind != "pixuv") and ("Upix" in b) == (kind == "pixuv")
    if "U" in b:
        assert b["U"][0] == "<f8"


def _run_both(f1, f2, cfg, tmp_path, monkeypatch, **kw):
    """Both packages' run_pipeline on the same files: (port's files, octane_tpu's
    files, {package: (scene1 as compute_flow found it: g2x/g2y/x offsets;
    the solved scene1)})."""
    seen = {}

    def spy(module, key):
        real = module.compute_flow

        def run(scene1, scene2, cfg, **kw):
            nav = scene1.nav
            offsets = (nav.g2x_offset, nav.g2y_offset, nav.x_offset)
            seen[key] = (offsets, real(scene1, scene2, cfg, **kw))
            return seen[key][1]
        monkeypatch.setattr(module, "compute_flow", run)

    spy(pipeline, "port")
    spy(jax_pipeline, "jax")
    port = pipeline.run_pipeline(f1, f2, cfg, outdir=str(tmp_path / "port"),
                                 interp_dir=str(tmp_path / "port_interp"), device="cpu", **kw)
    jax = jax_pipeline.run_pipeline(f1, f2, _jax_cfg(cfg), outdir=str(tmp_path / "jax"),
                                    interp_dir=str(tmp_path / "jax_interp"), **kw)
    return port, jax, seen


def _ill_conditioned(scene, grid, flow_tol=1e-4, wind_tol=1e-3):
    """Pixels whose wind moves by more than ``wind_tol`` m/s when the flow
    moves by ``flow_tol`` px (the flow's budget against octane_tpu): end
    points near a pole on the grid, where the longitude turns fast, or on
    the polar grid's antimeridian (x = 0 beyond the pole), where the sign
    test lon1 >= lon0 flips."""
    u, v = scene.u_pix, scene.v_pix
    uw, vw = pix2uv_ms(u, v, scene.nav, scene.dt, grid=grid)
    bad = torch.zeros(u.shape, dtype=torch.bool)
    for du, dv in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        pu, pv = pix2uv_ms(u + du * flow_tol, v + dv * flow_tol, scene.nav, scene.dt, grid=grid)
        bad |= ((pu - uw).abs() > wind_tol) | ((pv - vw).abs() > wind_tol)
    return bad.numpy()


def _check_winds(a, b, seen, grid):
    """The flows within 1e-4 px of octane_tpu's; the float64 winds within
    1e-3 m/s, but where they are ill-conditioned in the flow (held finite,
    at most 2 % of the pixels); every other variable equal."""
    ps, js = seen["port"][1], seen["jax"][1]
    for got, want in ((ps.u_pix, js.u_pix), (ps.v_pix, js.v_pix)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    ill = _ill_conditioned(ps, grid)
    assert ill.mean() <= 0.02
    for d in (a, b):
        for k in ("U", "V"):
            assert np.isfinite(d[k][2]).all()
            d[k][2][ill] = 0.0
    _assert_same_files(a, b, close={"U": 1e-3, "V": 1e-3, "Rad": 1.0})
    return ill


@pytest.mark.parametrize("solver", ["pcg", "sor"])
@pytest.mark.parametrize("name", ["polar", "polar60", "mercator"])
def test_flat_pipeline_matches_jax(flat_pairs, tmp_path, monkeypatch, name, solver):
    grid, f1, f2 = flat_pairs[name]
    cfg = OFConfig(grid=grid, kiters=2, cgiters=10, solver=solver)
    ops.reset_counters()
    port, jax, seen = _run_both(f1, f2, cfg, tmp_path, monkeypatch)
    assert all(ops.counters()[k][1] > 0 for k in ops.PATHS[solver])
    suffix = "_polar" if grid == "polar" else "_merc"
    assert [os.path.basename(p) for p in port] == [f"outfile{suffix}.nc"]
    assert [os.path.basename(p) for p in jax] == [f"outfile{suffix}.nc"]
    a, b = _dump(jax[0]), _dump(port[0])
    assert b["U"][0] == "<f8" and np.nanmax(np.abs(b["U"][2])) > 1.0
    ill = _check_winds(a, b, seen, grid)
    # only the pole grid has ill-conditioned winds (its blob sits on the pole)
    assert ill.any() == (name == "polar")


def test_scene_from_numpy_carries_a_flat_scene(flat_pairs):
    grid, f1, _ = flat_pairs["polar60"]
    js = jax_read_scene(f1, _jax_cfg(OFConfig(grid=grid)), donav=True)
    js.u_ms = np.random.default_rng(1).normal(0, 1, js.lat.shape)
    ps = scene_from_numpy(dataclasses.asdict(js), "cpu")
    assert dataclasses.asdict(ps.nav) == dataclasses.asdict(js.nav)
    assert (ps.nav.lat1, ps.nav.lon0_deg, ps.nav.R) == (60.0, -30.0, 6371000.0)
    assert ps.raw_counts.dtype == torch.float32 and ps.u_ms.dtype == torch.float64
    np.testing.assert_array_equal(ps.u_ms.numpy(), js.u_ms)


@pytest.mark.parametrize("name", ["polar60", "mercator"])
def test_uv2pix_navigates_flat_grids_through_goes(flat_pairs, name):
    """octane_tpu's uv2pix ignores ``grid`` (octane_tpu/nav/winds.py:123-158):
    a flat grid's first guess goes through the GOES fixed grid.  The port
    matches it rather than correcting it."""
    grid, f1, _ = flat_pairs[name]
    cfg = OFConfig(grid=grid)
    sc = read_scene(f1, cfg, donav=True, device="cpu")
    js = jax_read_scene(f1, _jax_cfg(cfg), donav=True)
    for nav in (sc.nav, js.nav):
        nav.g2x_offset, nav.g2y_offset = nav.x_offset, nav.y_offset
    rng = np.random.default_rng(2)
    ufg = rng.uniform(-20, 20, js.lat.shape).astype(np.float32)
    vfg = rng.uniform(-20, 20, js.lat.shape).astype(np.float32)
    u, v = uv2pix(torch.from_numpy(ufg), torch.from_numpy(vfg), sc.lat, sc.lon, sc.x, sc.y,
                  sc.nav, 600.0, grid=grid)
    gu, gv = uv2pix(torch.from_numpy(ufg), torch.from_numpy(vfg), sc.lat, sc.lon, sc.x, sc.y,
                    sc.nav, 600.0, grid="goes")
    assert torch.equal(u, gu) and torch.equal(v, gv)
    ju, jv = jax_uv2pix(ufg, vfg, js.lat, js.lon, js.x, js.y, js.nav, 600.0, grid=grid)
    for got, want in ((u.numpy(), np.asarray(ju)), (v.numpy(), np.asarray(jv))):
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert u.abs().max() > 1.0


def test_flat_pipeline_leaves_image2_offsets(flat_pairs, tmp_path, monkeypatch):
    """Fault: the port copied image 2's x/y offsets into scene 1 on every
    grid; octane_tpu does so on GOES only (octane_tpu/pipeline.py:40-42).
    With a first guess on a flat grid the uncopied offsets trip uv2pix's
    sector-move guard in both packages, so the guess is zero."""
    grid, f1, f2 = flat_pairs["polar60"]
    h, w = 40, 40
    fg = make_firstguess_file(str(tmp_path / "fg.nc"), np.full((h, w), 3.0, np.float32),
                              np.full((h, w), -1.0, np.float32))
    cfg = OFConfig(grid=grid, kiters=2, cgiters=10, lambdac=0.5)
    port, jax, seen = _run_both(f1, f2, cfg, tmp_path, monkeypatch, firstguess_file=fg)
    assert seen["port"][0] == seen["jax"][0]
    assert seen["port"][0][:2] == (0.0, 0.0) and seen["port"][0][2] != 0.0
    a, b = _dump(jax[0]), _dump(port[0])
    _check_winds(a, b, seen, grid)
    assert b["optical_flow_settings"][3]["dofirstguess"] == 1


@pytest.mark.parametrize("name", ["polar", "mercator"])
def test_flat_interp_frames_match_jax(flat_pairs, tmp_path, monkeypatch, name):
    """Faults: the port named products and frames without the grid's
    suffix (octane_tpu/pipeline.py:60, 112-113) and requantized frames into
    int16 (octane_tpu/pipeline.py:100 keeps the type of raw_counts: float32
    on flat grids)."""
    grid, f1, f2 = flat_pairs[name]
    written_counts = []
    real_write = pipeline.write_product

    def spy(path, scene, cfg, interp=False):
        if interp:
            written_counts.append(scene.raw_counts.dtype)
        return real_write(path, scene, cfg, interp=interp)
    monkeypatch.setattr(pipeline, "write_product", spy)
    cfg = OFConfig(grid=grid, kiters=2, cgiters=10, do_interp=True, deltat=200.0)
    port, jax, seen = _run_both(f1, f2, cfg, tmp_path, monkeypatch)
    suffix = "_polar" if grid == "polar" else "_merc"
    names = [f"outfile{suffix}.nc", f"outfile_interp{suffix}1.nc",
             f"outfile_interp{suffix}2.nc"]
    assert [os.path.basename(p) for p in port] == [os.path.basename(p) for p in jax] == names
    assert written_counts == [np.float32, np.float32]
    for pj, pp in zip(jax, port):
        a, b = _dump(pj), _dump(pp)
        assert b["Rad"][0] == "<f4"
        # the frames' counts are requantized from images close to
        # octane_tpu's: within 1 count
        _check_winds(a, b, seen, grid)


@pytest.mark.parametrize("flag,name", [("-Polar", "polar60"), ("-Merc", "mercator")])
def test_cli_flat_grids_are_run_pipelines(flat_pairs, tmp_path, flag, name):
    grid, f1, f2 = flat_pairs[name]
    assert cli.main(["-i1", f1, "-i2", f2, flag, "-kiters", "2", "-o", str(tmp_path / "cli"),
                     "--device", "cpu"]) == 0
    want = pipeline.run_pipeline(f1, f2, OFConfig(grid=grid, kiters=2),
                                 outdir=str(tmp_path / "api"), device="cpu")[0]
    got = str(tmp_path / "cli" / os.path.basename(want))
    _assert_same_files(_dump(want), _dump(got))
