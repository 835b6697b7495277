"""octane_tpu_torch.core against octane_tpu.core and the reference_impl oracles.

Same numpy inputs (seeded) go to both packages.  Index selections (shifts,
the pyramid subsample, the Catmull-Rom matrices) must agree exactly; float
arithmetic agrees to a few ulps (XLA may contract multiply-adds into FMAs,
PyTorch's eager kernels do not), stated per test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import reference_impl as ref
from octane_tpu.core import bc as jbc
from octane_tpu.core import gaussian as jgauss
from octane_tpu.core import gradients as jgrad
from octane_tpu.core import interp as jinterp
from octane_tpu.core import normalize as jnorm
from octane_tpu.core import psi as jpsi
from octane_tpu.core import zoom as jzoom
from octane_tpu_torch.core import bc, gaussian, gradients, interp, normalize, psi, zoom

torch.set_num_threads(2)


def _img(shape, seed=0, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("offset", [-2, -1, 1, 2])
def test_clamp_shift_exact(axis, offset):
    a = _img((3, 17, 23))
    got = bc.clamp_shift(_t(a), offset, axis).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbc.clamp_shift(jnp.asarray(a), offset, axis)))


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("offset", [-1, 1])
def test_mirror_shift_exact(axis, offset):
    a = _img((2, 9, 12), seed=1)
    got = bc.mirror_shift(_t(a), offset, axis).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbc.mirror_shift(jnp.asarray(a), offset, axis)))


def test_blur_matches_jax_and_oracle():
    a = _img((24, 30), seed=2)
    fs = gaussian.solver_filtsize(0.5)
    assert fs == jgauss.solver_filtsize(0.5)
    kern = gaussian.gaussian_kernel_1d(1.0, fs)
    np.testing.assert_array_equal(kern, jgauss.gaussian_kernel_1d(1.0, fs))
    got = gaussian.blur_separable(_t(a), kern, fs).numpy()
    want = np.asarray(jgauss.blur_separable(jnp.asarray(a), kern, fs))
    # 20 float32 multiply-adds per pixel: a few ulps of 255
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the loop oracle sums in float64 with the float64 kernel
    oracle = ref.blur(a, ref.gaussian_kernel(1.0, fs), fs)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-3)


@pytest.mark.parametrize("factor", [0.5, 0.25])
def test_pyramid_downsample(factor):
    a = _img((40, 52), seed=3)
    got = zoom.pyramid_downsample(_t(a), factor).numpy()
    want = np.asarray(jzoom.pyramid_downsample(jnp.asarray(a), factor))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)   # blur ulps
    np.testing.assert_allclose(got, ref.solver_downsample(a, factor), rtol=0, atol=2e-3)


def test_catmull_matrix_exact():
    pos = (np.arange(37, dtype=np.float32) / np.float32(1.85)) - np.float32(0.3)
    got = zoom._catmull_matrix_1d(20, pos).numpy()
    np.testing.assert_array_equal(got, np.asarray(jzoom._catmull_matrix_1d(20, pos)))


@pytest.mark.parametrize("new_hw", [(32, 40), (31, 39)])
def test_zoom_in_flow(new_hw):
    f = _img((16, 20), seed=4, lo=-3, hi=3)
    got = zoom.zoom_in_flow(_t(f), new_hw, 0.5).numpy()
    want = np.asarray(jzoom.zoom_in_flow(jnp.asarray(f), new_hw, 0.5))
    # 4-tap matrix rows: the two frameworks may sum the taps in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    oracle = ref.zoom_in_flow(f, new_hw[1], new_hw[0], 0.5)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)


def test_bicubic_sample():
    img = _img((12, 15), seed=5)
    rng = np.random.default_rng(6)
    x = rng.uniform(-2, 16, (7, 9)).astype(np.float32)
    y = rng.uniform(-2, 13, (7, 9)).astype(np.float32)
    got = interp.bicubic_sample(_t(img), _t(x), _t(y)).numpy()
    want = np.asarray(jinterp.bicubic_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    oracle = np.array([[ref.bicubic(img, x[j, i], y[j, i]) for i in range(9)]
                       for j in range(7)])
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-3)


def test_catmull_rom_cell():
    v = [_t(_img((5,), seed=s)) for s in range(4)]
    x = _t(_img((5,), seed=9, lo=0, hi=1))
    got = interp.catmull_rom_cell(*v, x).numpy()
    want = np.asarray(jinterp.catmull_rom_cell(*[jnp.asarray(t.numpy()) for t in v],
                                               jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_gradient_4th():
    a = _img((2, 19, 27), seed=7)
    gx, gy = gradients.gradient_4th(_t(a))
    jx, jy = jgrad.gradient_4th(jnp.asarray(a))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=0, atol=1e-4)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
    ox, oy = ref.compgrad(a[0])
    np.testing.assert_allclose(gx[0].numpy(), ox, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gy[0].numpy(), oy, rtol=0, atol=1e-4)


def test_psi_deriv():
    x = _img((50,), seed=8, lo=0, hi=1e4)
    x[:5] = 0.0
    got = psi.psi_deriv(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpsi.psi_deriv(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(got, [ref.psi(float(v)) for v in x], rtol=1e-6)


def test_normalize():
    for band in range(1, 17):
        assert normalize.band_min_max(band) == jnorm.band_min_max(band)
    with pytest.raises(ValueError):
        normalize.band_min_max(17)
    a = _img((6, 7), seed=10, lo=-5, hi=200)
    got = normalize.normalize_image(_t(a), -1.6443, 185.5699).numpy()
    want = np.asarray(jnorm.normalize_image(jnp.asarray(a), -1.6443, 185.5699))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
