"""The last public names of octane_tpu that the port lacked, against the
JAX functions on the same numpy inputs (CPU):

* nav.goes.planck_temp, kappa_reflectance and navcal_goes(cal=, out_min=,
  out_max=) for all four calibrations.  The port computes in float64; the
  JAX package does too here, with x64 on (tests/conftest.py), so the
  budget is 1e-9 relative, the two libraries' log and trigonometric
  functions differing by ulps (tests/test_torch_nav.py's budget).
  Without x64 JAX would compute in float32 and agree to ~1e-6 only.
* core.interp.bilinear_sample: the case of tests/test_core.py:50, off-grid
  and edge points, float32 on both sides; the corner selection and clamps
  agree exactly, the weights to 1e-5 absolute on values in [0, 255] (XLA
  may contract the weighted sums into FMAs, PyTorch's eager kernels do
  not).
* io exports read_cth and read_first_guess, as octane_tpu.io does.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from octane_tpu import io as jio
from octane_tpu.core import interp as jinterp
from octane_tpu.nav import goes as jgoes
from octane_tpu_torch import io
from octane_tpu_torch.core import interp
from octane_tpu_torch.io import readers
from octane_tpu_torch.nav import goes

from test_torch_nav import _navs

torch.set_num_threads(2)

NAV_RTOL = 1e-9          # float64 on both sides (x64 on)
BILINEAR_ATOL = 1e-5     # float32 weights on [0, 255] values; FMA contraction in XLA


def _close(a, b, rtol=NAV_RTOL, atol=1e-9):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol,
                               equal_nan=True)


def test_planck_temp_and_kappa_reflectance():
    rad = np.random.default_rng(1).uniform(5.0, 150.0, (33, 17))
    fk1, fk2, bc1, bc2, kap1 = 10803.3, 1392.74, 0.07544, 0.99975, 0.0015
    _close(goes.planck_temp(torch.from_numpy(rad), fk1, fk2, bc1, bc2),
           jgoes.planck_temp(jnp.asarray(rad), fk1, fk2, bc1, bc2))
    _close(goes.kappa_reflectance(torch.from_numpy(rad), kap1),
           jgoes.kappa_reflectance(jnp.asarray(rad), kap1))
    assert goes.planck_temp(torch.from_numpy(rad), fk1, fk2, bc1, bc2).dtype == torch.float64


@pytest.mark.parametrize("cal,norm,out", [
    ("TEMP", (180.0, 320.0), (0.0, 255.0)),
    ("REF", (0.0, 0.5), (10.0, 200.0)),
    ("RAW", (-1.6443, 185.5699), (0.0, 255.0)),
    ("BRIT", (0.0, 120.0), (-5.0, 5.0)),
])
def test_navcal_goes_calibrations(cal, norm, out):
    nav, jnav = _navs()
    rng = np.random.default_rng(2)
    counts = rng.integers(100, 16000, (64, 64)).astype(np.int16)
    x = np.arange(64, dtype=np.int16)
    kw = dict(cal=cal, norm_min=norm[0], norm_max=norm[1], out_min=out[0], out_max=out[1])
    d, lat, lon = goes.navcal_goes(torch.from_numpy(counts), torch.from_numpy(x),
                                   torch.from_numpy(x), nav, **kw)
    jd, jlat, jlon = jgoes.navcal_goes(jnp.asarray(counts), jnp.asarray(x), jnp.asarray(x),
                                       jnav, **kw)
    assert d.dtype == torch.float64
    _close(d, jd)
    _close(lat, jlat)
    _close(lon, jlon)


def test_navcal_goes_defaults_keep_the_raw_bits():
    """The reader's call (RAW, out range [0, 255] by default) gives the
    values of the RAW-only formula it had before cal= existed."""
    nav, _ = _navs()
    rng = np.random.default_rng(3)
    counts = torch.from_numpy(rng.integers(100, 16000, (40, 64)).astype(np.int16))
    x, y = torch.arange(64, dtype=torch.int16), torch.arange(40, dtype=torch.int16)
    lo, hi = -1.6443, 185.5699
    d, _, _ = goes.navcal_goes(counts, x, y, nav, norm_min=lo, norm_max=hi, donav=False)
    xg = (x.double() * nav.x_scale + nav.x_offset)[None, :].expand(40, 64)
    yg = (y.double() * nav.y_scale + nav.y_offset)[:, None].expand(40, 64)
    dval = counts.double() * nav.rad_scale[0] + nav.rad_offset[0]
    before = goes.limb_ramp(xg * xg + yg * yg) * ((dval - lo) / (hi - lo) * 255.0)
    assert torch.equal(d, before)
    with pytest.raises(ValueError, match="cal must be"):
        goes.navcal_goes(counts, x, y, nav, cal="KELVIN")


def _img():
    return np.random.default_rng(0).uniform(0.0, 255.0, (12, 10)).astype(np.float32)


def test_bilinear_sample_interior_case():
    """tests/test_core.py:50's case."""
    img = _img()
    got = float(interp.bilinear_sample(torch.from_numpy(img), 3.5, 4.25))
    want = (0.5 * (0.75 * img[4, 3] + 0.25 * img[5, 3])
            + 0.5 * (0.75 * img[4, 4] + 0.25 * img[5, 4]))
    assert abs(got - want) < 1e-4
    jgot = float(jinterp.bilinear_sample(jnp.asarray(img), jnp.float32(3.5), jnp.float32(4.25)))
    assert abs(got - jgot) <= BILINEAR_ATOL


@pytest.mark.parametrize("lead", [(), (3,)])
def test_bilinear_sample_off_grid_and_edges(lead):
    """Random off-grid points beyond every edge, and the points exactly on
    and just inside the last row and column (the clamps' branches)."""
    img = np.random.default_rng(4).uniform(0.0, 255.0, lead + (12, 10)).astype(np.float32)
    h, w = img.shape[-2:]
    rng = np.random.default_rng(5)
    xs = rng.uniform(-3.0, w + 3.0, (7, 9)).astype(np.float32)
    ys = rng.uniform(-3.0, h + 3.0, (7, 9)).astype(np.float32)
    edges = np.array([0.0, w - 1, w - 1 + 0.5, w, w + 0.25, -0.5], np.float32)
    xs[0, :6], ys[0, :6] = edges, edges * (h / w)
    xs[1, :6], ys[1, :6] = np.float32(2.5), np.array([0.0, h - 1, h - 0.5, h, h + 1, -1],
                                                       np.float32)
    got = interp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xs),
                                 torch.from_numpy(ys))
    want = np.asarray(jinterp.bilinear_sample(jnp.asarray(img), jnp.asarray(xs),
                                              jnp.asarray(ys)))
    assert got.shape == lead + xs.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BILINEAR_ATOL)


def test_io_exports_the_cth_and_first_guess_readers():
    assert {"read_cth", "read_first_guess"} <= set(io.__all__) & set(jio.__all__)
    assert io.read_cth is readers.read_cth
    assert io.read_first_guess is readers.read_first_guess
