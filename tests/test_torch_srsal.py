"""SRSAL on the CPU: ``post.srsal.srsal_smooth`` and the plain version of the
bilateral kernel (``ops.bilateral.bilateral_plain``) against octane_tpu's
``srsal_smooth`` at rel <= 1e-5 (docs/PARITY.md:91; XLA's CPU exp and its
FMA contraction differ from PyTorch's), against the loop oracle
``reference_impl.srsal`` at rtol 1e-4, the uniform-CTH mass test of
tests/test_post.py, the 19-px minimum, and the tap table and boundary pad
bit-equal to octane_tpu's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octane_tpu.core.gaussian import gaussian_kernel_1d as jax_gaussian_kernel_1d
from octane_tpu.post.srsal import _reflect_pad as jax_reflect_pad
from octane_tpu.post.srsal import srsal_smooth as jax_srsal_smooth
from octane_tpu_torch import ops
from octane_tpu_torch.core.gaussian import gaussian_kernel_1d
from octane_tpu_torch.ops.bilateral import bilateral, bilateral_plain, reflect_pad
from octane_tpu_torch.post import srsal_smooth
from tests import reference_impl as ref

torch.set_num_threads(2)
SIGPIX2 = -1.0 / (2.0 * 20.0 * 20.0)


def _fields(h, w, seed, cth="uniform"):
    """u, v ~ N(0, 2) and a CTH field, numpy float32.  ``steps``: 4 x 4
    plateaus 20 m apart (one range sigma), so the range weight bites."""
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 2, (h, w)).astype(np.float32)
    v = rng.normal(0, 2, (h, w)).astype(np.float32)
    if cth == "uniform":
        c = rng.uniform(0, 12000, (h, w))
    else:
        c = 5000.0 + 20.0 * np.kron(rng.integers(0, 6, (h // 4 + 1, w // 4 + 1)),
                                    np.ones((4, 4)))[:h, :w]
    return u, v, c.astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_tap_table_bit_equal_to_jax():
    got = gaussian_kernel_1d(9.0, 18)
    want = jax_gaussian_kernel_1d(9.0, 18)
    assert got.dtype == want.dtype == np.float32 and got.shape == (37,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(19, 19), (40, 48), (23, 70)])
def test_reflect_pad_equals_jax(hw):
    a = np.random.default_rng(1).normal(0, 1, hw).astype(np.float32)
    got = reflect_pad(torch.from_numpy(a), 18).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_reflect_pad(jnp.asarray(a), 18)))


@pytest.mark.parametrize("cth", ["uniform", "steps"])
@pytest.mark.parametrize("hw", [(40, 48), (64, 72)])
def test_matches_jax_srsal_smooth(hw, cth):
    u, v, c = _fields(*hw, seed=hw[0], cth=cth)
    ops.reset_counters()
    su, sv = srsal_smooth(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(c))
    assert ops.counters()["bilateral"] == (0, 1)      # the plain version on the CPU
    ju, jv = jax_srsal_smooth(jnp.asarray(u), jnp.asarray(v), jnp.asarray(c))
    assert su.shape == sv.shape == hw and su.dtype == torch.float32
    assert _rel(su.numpy(), np.asarray(ju)) <= 1e-5
    assert _rel(sv.numpy(), np.asarray(jv)) <= 1e-5
    # the wrapper on CPU tensors is the plain version
    plain = bilateral_plain(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(c),
                            gaussian_kernel_1d(9.0, 18), SIGPIX2)
    assert torch.equal(plain[0], su) and torch.equal(plain[1], sv)


def test_matches_loop_oracle():
    u, v, c = _fields(22, 20, seed=11)
    want_u, want_v = ref.srsal(u, v, c)
    su, sv = srsal_smooth(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(c))
    np.testing.assert_allclose(su.numpy(), want_u, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sv.numpy(), want_v, rtol=1e-4, atol=1e-4)


def test_uniform_cth_is_gaussian_of_flow():
    h = w = 40
    u = torch.zeros((h, w))
    u[20, 20] = 1.0
    cth = torch.full((h, w), 5000.0)
    su, sv = srsal_smooth(u, u, cth)
    assert float(su.max()) < 1.0 and float(su.min()) >= 0.0
    assert abs(float(su.sum()) - 1.0) < 0.05      # mass-preserving smoothing
    assert torch.equal(su, sv)


@pytest.mark.parametrize("hw", [(18, 40), (40, 18), (5, 5)])
def test_below_19_px_raises(hw):
    z = torch.zeros(hw)
    with pytest.raises(ValueError, match="19"):
        srsal_smooth(z, z, z)


def test_wrapper_checks_its_inputs():
    z = torch.zeros((32, 32))
    gk = gaussian_kernel_1d(9.0, 18)
    with pytest.raises(TypeError):
        bilateral(z.double(), z, z, gk, SIGPIX2)
    with pytest.raises(ValueError):
        bilateral(z, z, torch.zeros((32, 33)), gk, SIGPIX2)
    with pytest.raises(ValueError):
        bilateral(z, z, z, gk[:-1], SIGPIX2)
