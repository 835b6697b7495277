"""ops.assemble: the plain version of the fused assembly (CPU tensors)
against octane_tpu's fused Pallas assembly ``make_fused_assemble`` in
interpret mode (cropped to the true grid) and against its XLA chain
``assemble`` + ``build_cf`` + ``sor_rdet``, on the same warp samples, in
both GNC modes (tests/test_fused_assemble.py).  Budget: |d| / (|want| + 1)
<= 2e-6 per coefficient, ||b||^2 rel <= 1e-6 (docs/PARITY.md:93).  The PCG
form (``assemble_pcg``) equals the eager assembly, stacked, with
``initial_partials`` bit for bit, on the whole image and on row ranges,
and octane_tpu's ``assemble`` within 2e-6 of each plane's max (its first
sums within 1e-6).  The CUDA kernels are held against the plain versions
on the card (tests/test_torch_cuda.py).
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
from octane_tpu_torch.ops.pcg import block_partials, initial_partials, num_partials
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


# ---------------------------------------------------------------------------
# the PCG form: (cf, b, first-sum partials) of a row range
# ---------------------------------------------------------------------------

def _pcg(d, al1, dozim=True, rows=None, fields=None):
    f = d if fields is None else fields
    return asm.assemble_pcg(f["samples"], f["bc_x"], f["bc_y"], f["g1s"], f["u"], f["v"],
                            f["uhat"], f["vhat"], al1, LAMBDAC, ALPHA, LAM_A, dozim, rows)


def _todays_route(d, al1, dozim=True):
    """The PCG round's assembly before the kernel: the eager assembly, the
    planes stacked as the solver stacked them, then initial_partials."""
    sysm = assemble(*d["grads"], d["u"], d["v"], d["uhat"], d["vhat"], al1, ALPHA, LAM_A,
                    LAMBDAC, dozim, stack=d["stack"])
    planes = [sysm.a1, sysm.a4, sysm.a2]
    if al1 != 1.0:
        planes += [sysm.a5, sysm.a6, sysm.a7, sysm.a8]
    cf, b = torch.stack(planes), torch.stack([sysm.bu, sysm.bv])
    return cf, b, initial_partials(cf, b)


@pytest.mark.parametrize("hw", [(37, 45), (19, 40)])
@pytest.mark.parametrize("dozim", [True, False])
@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("c", [1, 3])
def test_assemble_pcg_is_todays_route(c, al1, dozim, hw):
    """On the CPU assemble_pcg equals the eager assembly -> stack ->
    initial_partials bit for bit: 3 planes in the quadratic step, else 7,
    and (n, 3) partials in the kernels' block order."""
    d = _inputs(c, *hw, seed=11 + c)
    got = _pcg(d, al1, dozim)
    want = _todays_route(d, al1, dozim)
    assert got[0].shape == (3 if al1 == 1.0 else 7, *hw)
    assert got[2].shape == (num_partials(*hw), 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _slab(d, a0, a1):
    return {k: d[k][..., a0:a1, :].contiguous()
            for k in ("samples", "bc_x", "bc_y", "g1s", "u", "v", "uhat", "vhat")}


@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("split", [(0, 8, 24, 37), (0, 16, 19), (0, 37)])
def test_assemble_pcg_rows_are_the_whole_images(split, c, al1):
    """A band's rows, assembled from its slab (its rows and the stencil's
    ghost row beside each cut) or from the whole image, equal the whole
    image's rows; on bands aligned to the 8-row blocks its partials are the
    whole image's block rows."""
    h, w = split[-1], 45
    d = _inputs(c, h, w, seed=20 + c)
    whole = _pcg(d, al1)
    gw = -(-w // 32)
    for r0, r1 in zip(split[:-1], split[1:]):
        a0, a1 = max(0, r0 - 1), min(h, r1 + 1)
        band = _pcg(d, al1, rows=(r0 - a0, r1 - a0), fields=_slab(d, a0, a1))
        direct = _pcg(d, al1, rows=(r0, r1))
        for got in (band, direct):
            assert torch.equal(got[0], whole[0][:, r0:r1])
            assert torch.equal(got[1], whole[1][:, r0:r1])
            assert torch.equal(got[2], whole[2][r0 // 8 * gw:-(-r1 // 8) * gw])


@pytest.mark.parametrize("dozim", [True, False])
@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("c", [1, 3])
def test_assemble_pcg_matches_jax_assemble(c, al1, dozim):
    """The PCG form's planes against octane_tpu.flow.stencil.assemble on the
    same warp samples, within 2e-6 of each plane's max; the solver's first
    sums gamma_0 = sum(bu^2 / a1 + bv^2 / a4) and ||b||^2 within 1e-6."""
    h, w = 40, 56
    d = _inputs(c, h, w, seed=30 + c)
    cf, b, partials = _pcg(d, al1, dozim)
    smp = (jnp.asarray(d["samples"].numpy()), jnp.asarray(d["bc_x"].numpy()),
           jnp.asarray(d["bc_y"].numpy()))
    jg = [jnp.asarray(g.numpy()) for g in d["grads"]]
    js = jax_assemble(*jg, *(jnp.asarray(d[k].numpy()) for k in ("u", "v", "uhat", "vhat")),
                      jnp.float32(al1), jnp.float32(ALPHA), jnp.float32(LAM_A),
                      jnp.float32(LAMBDAC), dozim, warp_fn=lambda *_: smp,
                      al1_static=1.0 if al1 == 1.0 else None)
    names = ["a1", "a4", "a2"] + ([] if al1 == 1.0 else ["a5", "a6", "a7", "a8"])
    for got, name in zip(list(cf) + list(b), names + ["bu", "bv"]):
        want = np.asarray(getattr(js, name))
        assert float(np.abs(got.numpy() - want).max()) <= 2e-6 * float(np.abs(want).max()), name
    bu, bv, a1, a4 = (np.asarray(getattr(js, k), np.float64) for k in ("bu", "bv", "a1", "a4"))
    gamma0, b2 = float((bu * bu / a1 + bv * bv / a4).sum()), float((bu * bu + bv * bv).sum())
    sums = partials.double().sum(0)
    assert abs(float(sums[0] + sums[1]) - gamma0) <= 1e-6 * abs(gamma0)
    assert abs(float(sums[2]) - b2) <= 1e-6 * b2


def test_assemble_pcg_counts_and_checks():
    d = _inputs(1, 12, 20, seed=4)
    before = (asm.assemble_pcg.launches, asm.assemble_pcg.plain_calls)
    _pcg(d, 0.5)
    assert (asm.assemble_pcg.launches,
            asm.assemble_pcg.plain_calls) == (before[0], before[1] + 1)
    for rows in ((0, 13), (5, 5), (-1, 4), (6, 2)):
        with pytest.raises(ValueError, match="rows"):
            _pcg(d, 0.5, rows=rows)
    args = [d[k] for k in ("samples", "bc_x", "bc_y", "g1s", "u", "v", "uhat", "vhat")]
    bad = {0: args[0][:5], 2: args[2].float(), 3: args[3][:2], 7: args[7].double()}
    for i, t in bad.items():
        with pytest.raises((ValueError, TypeError)):
            asm.assemble_pcg(*args[:i], t, *args[i + 1:], 0.5, LAMBDAC, ALPHA, LAM_A)
