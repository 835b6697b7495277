"""flow.stencil: ``assemble`` in both GNC modes against octane_tpu's
``assemble``, and ``apply_stencil`` against octane_tpu and the dense
reference matrix (tests/reference_impl.dense_matrix).

Assembly budget: rel 1e-5 per coefficient field over the field's max (the
JAX program may contract multiply-adds; psi' = rsqrt differs by ulps).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import reference_impl as ref
from octane_tpu.core.gradients import gradient_4th as jax_grad
from octane_tpu.flow.stencil import StencilSystem as JaxSystem
from octane_tpu.flow.stencil import apply_stencil as jax_apply
from octane_tpu.flow.stencil import assemble as jax_assemble
from octane_tpu_torch.core.gradients import gradient_4th
from octane_tpu_torch.flow.stencil import StencilSystem, apply_stencil, assemble

torch.set_num_threads(2)


def _inputs(c, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    g1 = (base[None] + rng.normal(0, 2, (c, h, w))).astype(np.float32)
    g2 = (np.roll(base, 1, axis=1)[None] + rng.normal(0, 2, (c, h, w))).astype(np.float32)
    u = rng.uniform(-2, 2, (h, w)).astype(np.float32)
    v = rng.uniform(-2, 2, (h, w)).astype(np.float32)
    uhat = rng.uniform(-1, 1, (h, w)).astype(np.float32)
    vhat = rng.uniform(-1, 1, (h, w)).astype(np.float32)
    return g1, g2, u, v, uhat, vhat


def _grads(g1, g2, grad):
    gx1, gy1 = grad(g1)
    gx2, gy2 = grad(g2)
    gxx, _ = grad(gx2)
    gxy, gyy = grad(gy2)
    return gx1, gy1, gx2, gy2, gxx, gxy, gyy


@pytest.mark.parametrize("dozim", [True, False])
@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("c", [1, 2])
def test_assemble_matches_jax(c, al1, dozim):
    g1, g2, u, v, uhat, vhat = _inputs(c, 36, 44, seed=c)
    lam_a, lambdac, alpha = float(np.float32(0.2)), float(np.float32(0.01)), 5.0
    tg = _grads(torch.from_numpy(g1), torch.from_numpy(g2), gradient_4th)
    got = assemble(torch.from_numpy(g1), torch.from_numpy(g2), *tg,
                   *(torch.from_numpy(a) for a in (u, v, uhat, vhat)),
                   al1, alpha, lam_a, lambdac, dozim)
    jg = _grads(jnp.asarray(g1), jnp.asarray(g2), jax_grad)
    want = jax_assemble(jnp.asarray(g1), jnp.asarray(g2), *jg,
                        *(jnp.asarray(a) for a in (u, v, uhat, vhat)),
                        jnp.float32(al1), jnp.float32(alpha), jnp.float32(lam_a),
                        jnp.float32(lambdac), dozim,
                        al1_static=1.0 if al1 == 1.0 else None)
    for name in StencilSystem._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        if al1 == 1.0 and name in ("a5", "a6", "a7", "a8"):
            assert a == -1.0 and b.shape == () and float(b) == -1.0
            continue
        a = a.numpy()
        scale = max(float(np.abs(b).max()), 1.0)
        assert float(np.abs(a - b).max()) / scale < 1e-5, name


def _coefs(h, w, seed):
    rng = np.random.default_rng(seed)
    A = {k: rng.uniform(4.5, 9.0, (h, w)).astype(np.float32) for k in ("a1", "a4")}
    A["a2"] = rng.uniform(-0.3, 0.3, (h, w)).astype(np.float32)
    for k in ("a5", "a6", "a7", "a8"):
        A[k] = -rng.uniform(0.3, 1.0, (h, w)).astype(np.float32)
    A["bu"] = rng.normal(0, 1, (h, w)).astype(np.float32)
    A["bv"] = rng.normal(0, 1, (h, w)).astype(np.float32)
    return A


def test_apply_stencil_matches_dense_matrix():
    h, w = 12, 14
    A = _coefs(h, w, seed=0)
    rng = np.random.default_rng(1)
    du = rng.normal(0, 1, (h, w)).astype(np.float32)
    dv = rng.normal(0, 1, (h, w)).astype(np.float32)
    x = np.empty(2 * h * w, np.float32)
    x[0::2], x[1::2] = du.ravel(), dv.ravel()
    want = (ref.dense_matrix(A) @ x).astype(np.float32)
    s = StencilSystem(**{k: torch.from_numpy(a) for k, a in A.items()})
    au, av = apply_stencil(s, torch.from_numpy(du), torch.from_numpy(dv))
    got = np.empty_like(want)
    got[0::2], got[1::2] = au.numpy().ravel(), av.numpy().ravel()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("quad", [True, False])
def test_apply_stencil_matches_jax(quad):
    h, w = 17, 23
    A = _coefs(h, w, seed=2)
    if quad:
        for k in ("a5", "a6", "a7", "a8"):
            A[k] = None
    rng = np.random.default_rng(3)
    du = rng.normal(0, 1, (h, w)).astype(np.float32)
    dv = rng.normal(0, 1, (h, w)).astype(np.float32)
    s = StencilSystem(**{k: -1.0 if a is None else torch.from_numpy(a) for k, a in A.items()})
    js = JaxSystem(**{k: jnp.float32(-1) if a is None else jnp.asarray(a) for k, a in A.items()})
    au, av = apply_stencil(s, torch.from_numpy(du), torch.from_numpy(dv))
    ju, jv = jax_apply(js, jnp.asarray(du), jnp.asarray(dv))
    np.testing.assert_allclose(au.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(av.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-5)
