"""octane_tpu_torch.flow.patch_match against octane_tpu.flow.patch_match and
the serial oracle ``reference_impl.patch_match`` on the CPU.

* the spiral offset table equal to octane_tpu's for srad 1-3;
* the zero-guess slice path, the first-guess gather path (rad 1 and 2) and
  the factored full-disk form (``FIRST_GUESS_MAX_PIXELS`` set low in both
  packages for the test): whole-pixel offsets equal to octane_tpu's at
  every pixel and u, v within 1e-4 px of them (the packages sum in the
  same order; XLA may contract a multiply-add, eager PyTorch does not), and
  within 2e-3 px of the oracle (tests/test_patch_match.py's tolerance);
* the zero-guess fast path equal to the zero-first-guess gather path bit
  for bit; an integer translation recovered; the first-guess guard's
  ValueError.
Inputs are noisy images made with numpy from a seed, so no two offsets tie.
"""

import numpy as np
import pytest
import torch

import reference_impl as ref
from octane_tpu.flow import patch_match as jpm
from octane_tpu_torch.flow import patch_match as tpm

torch.set_num_threads(2)


def _pair(seed, h, w, shift):
    rng = np.random.default_rng(seed)
    im1 = rng.normal(100, 25, (h, w)).astype(np.float32)
    im2 = (np.roll(im1, shift, axis=(0, 1))
           + rng.normal(0, 0.5, (h, w))).astype(np.float32)
    return im1, im2


def _port(*args, **kw):
    u, v = tpm.patch_match_flow(*args, device="cpu", **kw)
    assert u.dtype == v.dtype == torch.float32 and u.device.type == "cpu"
    return u.numpy(), v.numpy()


def _check_against_jax(got, want):
    for g, j in zip(got, want):
        j = np.asarray(j)
        # the refined offset lies within half a pixel of the whole-pixel winner
        np.testing.assert_array_equal(np.rint(g), np.rint(j))
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("srad", [1, 2, 3])
def test_spiral_offsets_match_jax(srad):
    got = tpm.spiral_offsets(srad)
    assert got.dtype == np.int32 and got.shape == ((2 * srad + 1) ** 2, 2)
    np.testing.assert_array_equal(got, jpm.spiral_offsets(srad))


@pytest.mark.parametrize("rad", [1, 2])
def test_zero_guess_matches_jax_and_oracle(rad):
    im1, im2 = _pair(5, 14, 16, (0, 1))
    got = _port(im1, im2, None, None, rad=rad, srad=2)
    _check_against_jax(got, jpm.patch_match_flow(im1, im2, None, None, rad=rad, srad=2))
    z = np.zeros_like(im1)
    want = ref.patch_match(im1, im2, z, z, rad=rad, srad=2)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-3)


@pytest.mark.parametrize("rad", [1, 2])
def test_first_guess_matches_jax_and_oracle(rad):
    im1, im2 = _pair(7, 12, 12, (1, 2))
    u0 = np.full(im1.shape, 1.4, np.float32)
    v0 = np.full(im1.shape, 0.6, np.float32)
    got = _port(im1, im2, torch.from_numpy(u0), torch.from_numpy(v0), rad=rad, srad=2)
    _check_against_jax(got, jpm.patch_match_flow(im1, im2, u0, v0, rad=rad, srad=2))
    want = ref.patch_match(im1, im2, u0, v0, rad=rad, srad=2)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-3)


@pytest.mark.parametrize("shape,srad", [((40, 36), 2), ((33, 47), 1)])
def test_factored_form_matches_jax(monkeypatch, shape, srad):
    """Above the guard the zero-guess path sums windows of one e^2 plane
    and selects its probes from the 7^2 - 4 offsets around the spiral."""
    monkeypatch.setattr(jpm, "FIRST_GUESS_MAX_PIXELS", 100)
    monkeypatch.setattr(tpm, "FIRST_GUESS_MAX_PIXELS", 100)
    im1, im2 = _pair(3, *shape, (1, -1))
    got = _port(im1, im2, None, None, rad=2, srad=srad)
    _check_against_jax(got, jpm.patch_match_flow(im1, im2, None, None, rad=2, srad=srad))
    if srad == 2:
        z = np.zeros_like(im1)
        for g, r in zip(got, ref.patch_match(im1, im2, z, z, rad=2, srad=2)):
            np.testing.assert_allclose(g, r, rtol=0, atol=2e-3)


def test_fast_path_matches_gather_path():
    """u0=None (slices) equals u0=zeros (gathers) bit for bit."""
    im1, im2 = _pair(11, 18, 22, (1, -1))
    z = torch.zeros(im1.shape)
    want = _port(im1, im2, z, z, rad=2, srad=2)
    got = _port(im1, im2, None, None, rad=2, srad=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_integer_translation_recovered():
    rng = np.random.default_rng(9)
    im1 = rng.normal(100, 25, (32, 32)).astype(np.float32)
    im2 = np.roll(im1, (0, 2), axis=(0, 1))
    u, v = _port(torch.from_numpy(im1), torch.from_numpy(im2), None, None)
    interior = u[6:-6, 6:-6]
    assert abs(np.median(interior) - 2.0) < 0.2
    assert abs(interior.mean() - 2.0) < 0.2
    assert abs(np.median(v[6:-6, 6:-6])) < 0.2


def test_first_guess_scale_guard():
    h = 4096
    w = tpm.FIRST_GUESS_MAX_PIXELS // h + 1
    g = torch.zeros((h, w))
    with pytest.raises(ValueError, match="sector-scale only"):
        tpm.patch_match_flow(g, g, g, g)
