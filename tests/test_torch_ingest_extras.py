"""The ingest of the CTH + first-guess + SRSAL product path on the CPU,
against octane_tpu:

* ``core.gaussian.ingest_filtsize`` and the ingest regrids
  ``core.zoom.zoom_in_image`` (bicubic and nearest) and ``zoom_out_image``
  at rel <= 1e-6;
* ``io.readers.read_cth`` on synthetic CLAVR-x files: a band-13 scene, whose
  CTH grid is the image grid (w1 == xs), a band-2 128^2 scene with a 32^2
  CTH field (w1 > xs: zoom in, bicubic and nearest), and a CTH grid wider
  than the image (w1 < xs: zoom out; unreachable from GOES band numbers,
  reached by widening the scene's CTH bookkeeping);
* ``io.readers.read_first_guess`` (bit-equal) and ``nav.winds.uv2pix``
  (float64 inside, x64 on in the JAX package's tests), on a scene that
  crosses the limb: off-earth pixels and advected points that leave the
  visible disk get zero displacement, and a moved sector zeroes everything.
  uv2pix returns float32: the two float64 computations agree to ~1e-16,
  which rounds to the same float32 except where a value lies on a rounding
  boundary, so the outputs are held to 1 float32 ulp and 99.9 % bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octane_tpu.config import OFConfig as JaxOFConfig
from octane_tpu.core.gaussian import ingest_filtsize as jax_ingest_filtsize
from octane_tpu.core.zoom import zoom_in_image as jax_zoom_in_image
from octane_tpu.core.zoom import zoom_out_image as jax_zoom_out_image
from octane_tpu.io.readers import read_cth as jax_read_cth
from octane_tpu.io.readers import read_first_guess as jax_read_first_guess
from octane_tpu.io.readers import read_scene as jax_read_scene
from octane_tpu.nav.winds import uv2pix as jax_uv2pix
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.gaussian import ingest_filtsize
from octane_tpu_torch.core.zoom import zoom_in_image, zoom_out_image
from octane_tpu_torch.io.readers import (cth_onto_scene, read_cth, read_first_guess,
                                         read_scene)
from octane_tpu_torch.nav.winds import uv2pix
from tests import torch_fixtures as fx
from tests.synth import make_cth_file, make_firstguess_file, make_goes_file

torch.set_num_threads(2)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cth_field(h, w, seed):
    """A smooth CTH field in metres with 2-km steps, within int16 range."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    c = 6000 + 3000 * np.sin(xx / 5.0) * np.cos(yy / 7.0) + rng.uniform(-50, 50, (h, w))
    return (c + 2000.0 * (xx > w / 2)).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.3, 1.2, 2.9, 3.4])
def test_ingest_filtsize(sigma):
    assert ingest_filtsize(sigma) == jax_ingest_filtsize(sigma)


@pytest.mark.parametrize("bicubic", [True, False])
@pytest.mark.parametrize("src,dst", [((32, 32), (128, 128)), ((25, 40), (100, 81))])
def test_zoom_in_image_matches_jax(src, dst, bicubic):
    img = _cth_field(*src, seed=1)
    got = zoom_in_image(torch.from_numpy(img), dst, bicubic).numpy()
    want = np.asarray(jax_zoom_in_image(jnp.asarray(img), dst, bicubic))
    assert got.shape == want.shape == dst
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("shape,factor", [((256, 256), 0.5), ((90, 70), 0.25),
                                          ((64, 64), 1.0)])
def test_zoom_out_image_matches_jax(shape, factor):
    img = _cth_field(*shape, seed=2)
    got = zoom_out_image(torch.from_numpy(img), factor).numpy()
    want = np.asarray(jax_zoom_out_image(jnp.asarray(img), factor))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6


def _scene_file(path, h, w, band, **kw):
    return make_goes_file(path, fx.fixture_counts(0, 0, h, w), band=band, **kw)


@pytest.mark.parametrize("case", ["band13", "band2_bicubic", "band2_nearest",
                                  "zoom_out"])
def test_read_cth_matches_jax(tmp_path, case):
    band, cth_hw = {"band13": (13, (128, 128)), "band2_bicubic": (2, (32, 32)),
                    "band2_nearest": (2, (32, 32)), "zoom_out": (13, (256, 256))}[case]
    cfg = OFConfig(do_cth=True, interp_cth_bicubic=case != "band2_nearest")
    f1 = _scene_file(str(tmp_path / "g.nc"), 128, 128, band)
    cthf = make_cth_file(str(tmp_path / "cth.nc"), _cth_field(*cth_hw, seed=3))
    sc = read_scene(f1, cfg, donav=True, device="cpu")
    js = jax_read_scene(f1, JaxOFConfig(**dataclasses.asdict(cfg)), donav=True)
    if case == "zoom_out":
        for nav in (sc.nav, js.nav):
            nav.max_xc, nav.max_yc = cth_hw[1], cth_hw[0]
    read_cth(cthf, sc, cfg)
    jax_read_cth(cthf, js, JaxOFConfig(**dataclasses.asdict(cfg)))
    assert (sc.nav.cth_nx, sc.nav.cth_ny) == (js.nav.cth_nx, js.nav.cth_ny)
    assert sc.nav.cth_nx == {"band13": 128, "zoom_out": 256}.get(case, 32)
    assert sc.cth.shape == (128, 128) and sc.cth.dtype == torch.float32
    assert torch.isfinite(sc.cth).all()
    if case == "band13":
        np.testing.assert_array_equal(sc.cth.numpy(), js.cth)
    else:
        assert _rel(sc.cth.numpy(), np.asarray(js.cth)) <= 1e-6
    if case == "band2_nearest":       # nearest takes values of the CTH grid
        assert np.isin(sc.cth.numpy(), _cth_field(*cth_hw, seed=3)).all()


def test_cth_onto_scene_is_the_file_half(tmp_path):
    """``read_cth`` = the h5py read + ``cth_onto_scene`` (the path on the card)."""
    cfg = OFConfig(do_cth=True)
    f1 = _scene_file(str(tmp_path / "g.nc"), 128, 128, 2)
    field = _cth_field(32, 32, seed=4)
    sc = read_cth(make_cth_file(str(tmp_path / "cth.nc"), field),
                  read_scene(f1, cfg, device="cpu"), cfg)
    sa = cth_onto_scene(field, read_scene(f1, cfg, device="cpu"), cfg, "cpu")
    assert torch.equal(sc.cth, sa.cth)


@pytest.fixture(scope="module")
def limb_scene(tmp_path_factory):
    """A 48 x 64 band-13 scene whose columns cross the earth's east limb
    (scan angle ~0.1518 rad at the equator), its first-guess file and both
    packages' scenes with the first guess read."""
    d = tmp_path_factory.mktemp("limb")
    h, w = 48, 64
    f1 = _scene_file(str(d / "g.nc"), h, w, 13, x_offset=0.1500, y_offset=0.0123)
    rng = np.random.default_rng(5)
    ufg = rng.uniform(20, 60, (h, w)).astype(np.float32)     # eastward, to the limb
    vfg = rng.uniform(-30, 30, (h, w)).astype(np.float32)
    fgf = make_firstguess_file(str(d / "fg.nc"), ufg, vfg)
    cfg = OFConfig(do_firstguess=True)
    sc = read_first_guess(fgf, read_scene(f1, cfg, donav=True, device="cpu"))
    js = jax_read_first_guess(fgf, jax_read_scene(
        f1, JaxOFConfig(**dataclasses.asdict(cfg)), donav=True))
    return sc, js


def test_read_first_guess_matches_jax(limb_scene):
    sc, js = limb_scene
    assert sc.ufg.dtype == sc.vfg.dtype == torch.float32
    np.testing.assert_array_equal(sc.ufg.numpy(), js.ufg)
    np.testing.assert_array_equal(sc.vfg.numpy(), js.vfg)


@pytest.mark.parametrize("dt", [60.0, 3600.0])
def test_uv2pix_matches_jax(limb_scene, dt):
    sc, js = limb_scene
    for nav in (sc.nav, js.nav):
        nav.g2x_offset, nav.g2y_offset = nav.x_offset, nav.y_offset
    u, v = uv2pix(sc.ufg, sc.vfg, sc.lat, sc.lon, sc.x, sc.y, sc.nav, dt)
    ju, jv = jax_uv2pix(js.ufg, js.vfg, js.lat, js.lon, js.x, js.y, js.nav, dt)
    assert u.dtype == v.dtype == torch.float32
    for got, want in ((u.numpy(), np.asarray(ju)), (v.numpy(), np.asarray(jv))):
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
        assert (got == want).mean() >= 0.999
    off_earth = torch.isnan(sc.lat)
    assert off_earth.any() and (~off_earth).any()
    assert (u[off_earth] == 0).all() and (v[off_earth] == 0).all()
    assert ((u != 0) & ~off_earth).any()
    # over an hour the wind carries points near the limb off the visible disk
    carried_off = ((u == 0) & (v == 0) & ~off_earth).any()
    assert carried_off == (dt == 3600.0)


def test_uv2pix_moved_sector_is_zero(limb_scene):
    sc, js = limb_scene
    for nav in (sc.nav, js.nav):
        nav.g2x_offset, nav.g2y_offset = nav.x_offset + 1e-3, nav.y_offset
    u, v = uv2pix(sc.ufg, sc.vfg, sc.lat, sc.lon, sc.x, sc.y, sc.nav, 60.0)
    ju, jv = jax_uv2pix(js.ufg, js.vfg, js.lat, js.lon, js.x, js.y, js.nav, 60.0)
    assert not u.any() and not v.any()
    assert not np.asarray(ju).any() and not np.asarray(jv).any()
    assert u.shape == v.shape == sc.ufg.shape and u.dtype == torch.float32
