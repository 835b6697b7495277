"""ops.assemble: the plain version of the fused assembly (CPU tensors)
against octane_tpu's fused Pallas assembly ``make_fused_assemble`` in
interpret mode (cropped to the true grid) and against its XLA chain
``assemble`` + ``build_cf`` + ``sor_rdet``, on the same warp samples, in
both GNC modes (tests/test_fused_assemble.py).  Budget: |d| / (|want| + 1)
<= 2e-6 per coefficient, ||b||^2 rel <= 1e-6 (docs/PARITY.md:93).  The
CUDA kernel is held against the plain version on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from octane_tpu.flow.stencil import assemble as jax_assemble
from octane_tpu.ops.pallas.assemble import fused_geometry, make_fused_assemble
from octane_tpu.ops.pallas.sor import build_cf as jax_build_cf
from octane_tpu_torch.core.gradients import gradient_4th
from octane_tpu_torch.flow.stencil import assemble
from octane_tpu_torch.ops import assemble as asm
from octane_tpu_torch.ops.pcg import block_partials
from octane_tpu_torch.ops.sor import build_cf
from octane_tpu_torch.ops.warp import warp_bilinear_dense

torch.set_num_threads(2)
ALPHA, LAM_A, LAMBDAC = 5.0, float(np.float32(0.2)), float(np.float32(0.1))


def _inputs(c, h, w, seed=0):
    """Images, their gradients, flow and hints (tests/test_fused_assemble.py:
    _inputs), with the warp's samples taken by the port's plain warp."""
    rng = np.random.default_rng(seed)
    g1 = torch.from_numpy(rng.normal(100, 30, (c, h, w)).astype(np.float32))
    g2 = torch.from_numpy(rng.normal(100, 30, (c, h, w)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-3, 3, (h, w)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-3, 3, (h, w)).astype(np.float32))
    gx1, gy1 = gradient_4th(g1)
    gx2, gy2 = gradient_4th(g2)
    gxx, _ = gradient_4th(gx2)
    gxy, gyy = gradient_4th(gy2)
    stack = torch.cat([g2, gx2, gy2, gxx, gxy, gyy])
    samples, bc_x, bc_y = warp_bilinear_dense(stack, u, v)
    g1s = torch.cat([g1, gx1, gy1])
    return dict(samples=samples, bc_x=bc_x, bc_y=bc_y, g1s=g1s, u=u, v=v,
                uhat=u * 0.5, vhat=v * 0.5, grads=(g1, g2, gx1, gy1, gx2, gy2, gxx, gxy, gyy),
                stack=stack)


def _plain(d, al1, dozim=True):
    return asm.assemble_cf(d["samples"], d["bc_x"], d["bc_y"], d["g1s"], d["u"], d["v"],
                           d["uhat"], d["vhat"], al1, LAMBDAC, ALPHA, LAM_A, dozim)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float((np.abs(got - want) / (np.abs(want) + 1.0)).max())


def _b2(cf):
    cf = np.asarray(cf, np.float64)
    return float((cf[3] ** 2).sum() + (cf[4] ** 2).sum())


@pytest.mark.parametrize("quad", [True, False])
def test_plain_matches_jax_fused_kernel(quad):
    h, w = 136, 280
    d = _inputs(1, h, w)
    hp, wp = fused_geometry((h, w), 13)

    def pad(a):
        a = np.asarray(a)
        widths = [(0, 0)] * (a.ndim - 2) + [(0, hp - h), (0, wp - w)]
        return jnp.asarray(np.pad(a, widths))

    al1 = 1.0 if quad else 0.5
    run = make_fused_assemble((h, w), (hp, wp), 1, quad, True, interpret=True)
    want_cf, want_b2 = run(jnp.float32(al1), jnp.float32(LAMBDAC), jnp.float32(ALPHA),
                           jnp.float32(LAM_A), pad(d["g1s"]), pad(d["samples"]),
                           pad(d["bc_x"]), pad(d["bc_y"]), pad(d["u"]), pad(d["v"]),
                           pad(d["uhat"]), pad(d["vhat"]))
    cf, partials = _plain(d, al1)
    assert _rel(cf.numpy(), np.asarray(want_cf)[:, :h, :w]) <= 2e-6
    got_b2 = float(partials.double().sum())
    assert abs(got_b2 - float(want_b2)) <= 1e-6 * float(want_b2)


@pytest.mark.parametrize("dozim", [True, False])
@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("c", [1, 2])
def test_plain_matches_jax_assemble_build_cf(c, al1, dozim):
    h, w = 40, 56
    d = _inputs(c, h, w, seed=c)
    cf, partials = _plain(d, al1, dozim)
    smp = (jnp.asarray(d["samples"].numpy()), jnp.asarray(d["bc_x"].numpy()),
           jnp.asarray(d["bc_y"].numpy()))
    jg = [jnp.asarray(g.numpy()) for g in d["grads"]]
    sysm = jax_assemble(*jg, *(jnp.asarray(d[k].numpy()) for k in ("u", "v", "uhat", "vhat")),
                        jnp.float32(al1), jnp.float32(ALPHA), jnp.float32(LAM_A),
                        jnp.float32(LAMBDAC), dozim, warp_fn=lambda *_: smp,
                        al1_static=1.0 if al1 == 1.0 else None)
    want = np.asarray(jax_build_cf(sysm, h, w, al1 == 1.0))
    assert _rel(cf.numpy(), want) <= 2e-6
    assert abs(float(partials.double().sum()) - _b2(want)) <= 1e-6 * _b2(want)


@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
def test_plain_is_the_eager_assembly(al1):
    """cf holds stencil.assemble's fields in build_cf's order, bit for bit,
    and the partials are ||b||^2 per 32 x 8 block in the kernels' order."""
    d = _inputs(1, 37, 45, seed=3)
    cf, partials = _plain(d, al1)
    sysm = assemble(*d["grads"], d["u"], d["v"], d["uhat"], d["vhat"], al1, ALPHA,
                    LAM_A, LAMBDAC, True, stack=d["stack"])
    assert torch.equal(cf, build_cf(sysm))
    assert cf.shape[0] == (6 if al1 == 1.0 else 10)
    assert torch.equal(partials, block_partials(sysm.bu ** 2 + sysm.bv ** 2))


def test_wrapper_counts_and_checks():
    d = _inputs(1, 12, 20, seed=4)
    before = (asm.assemble_cf.launches, asm.assemble_cf.plain_calls)
    _plain(d, 0.5)
    assert (asm.assemble_cf.launches, asm.assemble_cf.plain_calls) == (before[0], before[1] + 1)
    args = [d[k] for k in ("samples", "bc_x", "bc_y", "g1s", "u", "v", "uhat", "vhat")]
    bad = {0: args[0][:5], 1: args[1].float(), 3: args[3][:2], 4: args[4].double(),
           5: args[5][:, :10], 6: args[6].t()}
    for i, t in bad.items():
        with pytest.raises((ValueError, TypeError)):
            asm.assemble_cf(*args[:i], t, *args[i + 1:], 0.5, LAMBDAC, ALPHA, LAM_A)
