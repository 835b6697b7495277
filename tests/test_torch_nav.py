"""nav (float64) against octane_tpu.nav with x64 on (tests/conftest.py):
navcal_goes, goes_latlon / goes_xy_from_latlon, haversine and pix2uv.

Budgets: float64 elementwise results to 1e-9 relative (the two libraries'
transcendental functions may differ by ulps); int16 wind shorts exactly,
except at most 1 count where 100 * wind lands within round-off of an
integer.
"""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from octane_tpu.io.datamodel import NavConstants as JaxNav
from octane_tpu.nav import goes as jgoes
from octane_tpu.nav import winds as jwinds
from octane_tpu_torch.io.datamodel import NavConstants
from octane_tpu_torch.nav import goes, winds

torch.set_num_threads(2)

# a 64x64 grid spread over the whole disk (x_scale 85x the ABI 2-km step),
# so off-earth and limb pixels are present
NAV = dict(grid="goes", req=6378137.0, rpol=6356752.31414, pph=35786023.0,
           lam0=math.radians(-75.0), lpo=-75.0, x_scale=5.6e-05 * 85,
           x_offset=-5.6e-05 * 85 * 31.5, y_scale=-5.6e-05 * 85,
           y_offset=5.6e-05 * 85 * 31.5, nx=64, ny=64,
           rad_scale=(0.01, 1.0, 1.0), rad_offset=(-0.5, 0.0, 0.0),
           fk1=(10803.3, 0, 0), fk2=(1392.74, 0, 0), bc1=(0.07544, 0, 0),
           bc2=(0.99975, 0, 0), kap1=(0.0015, 0, 0))


def _navs(**over):
    d = dict(NAV, **over)
    return NavConstants(**d), JaxNav(**d)


def _close(a, b, rtol=1e-9, atol=1e-9):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol,
                               equal_nan=True)


@pytest.mark.parametrize("donav,band_range", [(True, (-1.6443, 185.5699)),
                                             (True, (0.0, 2.0)),
                                             (False, (-25.93664701, 804.03605737))])
def test_navcal_goes(donav, band_range):
    nav, jnav = _navs()
    rng = np.random.default_rng(0)
    counts = rng.integers(100, 16000, (64, 64)).astype(np.int16)
    x = np.arange(64, dtype=np.int16)
    lo, hi = band_range
    d, lat, lon = goes.navcal_goes(torch.from_numpy(counts), torch.from_numpy(x),
                                   torch.from_numpy(x), nav, norm_min=lo,
                                   norm_max=hi, donav=donav)
    jd, jlat, jlon = jgoes.navcal_goes(jnp.asarray(counts), jnp.asarray(x),
                                       jnp.asarray(x), jnav, norm_min=lo,
                                       norm_max=hi, donav=donav)
    assert d.dtype == lat.dtype == torch.float64
    assert np.isnan(np.asarray(jlat)).any() == donav    # off-earth pixels present
    _close(d, jd)
    _close(lat, jlat)
    _close(lon, jlon)


def test_latlon_roundtrip_and_guard():
    nav, jnav = _navs()
    xs = np.linspace(-0.16, 0.16, 23)
    xg, yg = np.meshgrid(xs, xs + 0.003)
    lat, lon = goes.goes_latlon(torch.from_numpy(xg), torch.from_numpy(yg), nav)
    jlat, jlon = jgoes.goes_latlon(jnp.asarray(xg), jnp.asarray(yg), jnav)
    _close(lat, jlat)
    _close(lon, jlon)
    assert float(lat.min()) == -999.0                   # guard fills
    ok = lat > -998
    x2, y2 = goes.goes_xy_from_latlon(lat[ok], lon[ok], nav)
    jx2, jy2 = jgoes.goes_xy_from_latlon(jnp.asarray(lat[ok].numpy()),
                                         jnp.asarray(lon[ok].numpy()), jnav)
    _close(x2, jx2)
    _close(y2, jy2)
    np.testing.assert_allclose(x2.numpy(), xg[ok.numpy()], atol=1e-9)


def test_limb_ramp_and_haversine():
    d = np.linspace(0.0205, 0.0215, 41)
    _close(goes.limb_ramp(torch.from_numpy(d)), jgoes.limb_ramp(jnp.asarray(d)))
    rng = np.random.default_rng(1)
    pts = [rng.uniform(-60, 60, 50) for _ in range(4)]
    got = winds.haversine_m(*(torch.from_numpy(p) for p in pts))
    _close(got, jwinds.haversine_m(*(jnp.asarray(p) for p in pts)), rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("pixuv", [False, True])
def test_pix2uv(pixuv):
    nav, jnav = _navs(x_scale=5.6e-05, x_offset=-0.0339, y_scale=-5.6e-05,
                      y_offset=0.0861)
    for n in (nav, jnav):
        n.g2x_offset, n.g2y_offset = n.x_offset, n.y_offset
    rng = np.random.default_rng(2)
    u = rng.uniform(-4, 4, (48, 56)).astype(np.float32)
    v = rng.uniform(-4, 4, (48, 56)).astype(np.float32)
    got = winds.pix2uv(torch.from_numpy(u), torch.from_numpy(v), nav, 60.0, pixuv=pixuv)
    want = jwinds.pix2uv(jnp.asarray(u), jnp.asarray(v), jnav, 60.0, pixuv=pixuv)
    for a, b in zip(got, want):
        assert a.dtype == torch.int16
        d = np.abs(a.numpy().astype(np.int32) - np.asarray(b, np.int32))
        assert d.max() <= 1 and (d == 0).mean() > 0.999
    ms = winds.pix2uv_ms(torch.from_numpy(u), torch.from_numpy(v), nav, 60.0)
    jms = jwinds.pix2uv_ms(jnp.asarray(u), jnp.asarray(v), jnav, 60.0)
    _close(ms[0], jms[0], rtol=1e-9, atol=1e-7)
    _close(ms[1], jms[1], rtol=1e-9, atol=1e-7)


def test_sector_move_and_unported_grids():
    nav, _ = _navs()
    nav.g2x_offset = nav.x_offset + 1e-3
    z = torch.ones((4, 5))
    out = winds.pix2uv(z, z, nav, 60.0)
    assert all(int(t.abs().max()) == 0 for t in out)
    # the flat grids are ported (tests/test_torch_flatgrid.py): a polar
    # grid's shorts equal octane_tpu's
    flat = dict(grid="polar", x_scale=2000.0, x_offset=-4000.0, y_scale=2000.0,
                y_offset=-3000.0, lat1=60.0, lon0_deg=-30.0, g2x_offset=-4000.0,
                g2y_offset=-3000.0)
    nav2 = dataclasses.replace(nav, **flat)
    got = winds.pix2uv(3.0 * z, -2.0 * z, nav2, 60.0, grid="polar")
    want = jwinds.pix2uv(3.0 * np.ones((4, 5), np.float32), -2.0 * np.ones((4, 5), np.float32),
                         JaxNav(**dataclasses.asdict(nav2)), 60.0, grid="polar")
    for g, w in zip(got, want):
        assert int((g.to(torch.int32) - torch.from_numpy(np.asarray(w, np.int32))).abs().max()) <= 1
    assert int(got[0].abs().max()) > 0
