"""ops.pcg: the fused Jacobi-PCG driver (plain passes on the CPU) against
octane_tpu's XLA loop ``flow.cg.pcg_solve`` and its Pallas driver
``ops.pallas.cg.pcg_solve_fused`` in interpret mode, on the system recipe of
tests/test_fused_cg.py.  Budget: rel 1e-4 (dot products are summed in
another order: float round-off, not bitwise).  The CUDA passes are held
against the plain passes on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from octane_tpu.flow.cg import pcg_solve as jax_pcg
from octane_tpu.flow.stencil import StencilSystem as JaxSystem
from octane_tpu.flow.stencil import apply_stencil as jax_apply
from octane_tpu.ops.pallas.cg import pcg_solve_fused as jax_fused
from octane_tpu_torch.flow.cg import pcg_solve
from octane_tpu_torch.flow.stencil import StencilSystem, apply_stencil
from octane_tpu_torch.ops import pcg as pcgmod

torch.set_num_threads(2)
ITERS = 12


def _system_np(h, w, quad, seed=1):
    """tests/test_fused_cg.py:_system as numpy arrays (None: scalar -1)."""
    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return rng.uniform(lo, hi, (h, w)).astype(np.float32)

    d1, d4 = arr(4.5, 9.0), arr(4.5, 9.0)
    bu, bv = arr(-100, 100), arr(-100, 100)
    a2 = arr(-0.2, 0.2)
    offd = [None] * 4 if quad else [-arr(0.3, 1.0) for _ in range(4)]
    return dict(a1=d1, a2=a2, a4=d4, a5=offd[0], a6=offd[1], a7=offd[2],
                a8=offd[3], bu=bu, bv=bv)


def _torch_sys(d):
    return StencilSystem(**{k: -1.0 if a is None else torch.from_numpy(a)
                            for k, a in d.items()})


def _jax_sys(d):
    return JaxSystem(**{k: jnp.float32(-1) if a is None else jnp.asarray(a)
                        for k, a in d.items()})


def _rel(got, want):
    g = np.stack([t.numpy() for t in got])
    wv = np.stack([np.asarray(t) for t in want])
    return float(np.abs(g - wv).max() / np.abs(wv).max())


@pytest.mark.parametrize("oracle", ["xla_loop", "pallas_interpret"])
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("h", [128, 96])
def test_fused_driver_matches_jax(h, quad, oracle):
    d = _system_np(h, 256, quad)
    got = pcgmod.pcg_solve_fused(_torch_sys(d), 1e-8, ITERS)
    js = _jax_sys(d)
    if oracle == "xla_loop":
        want = jax_pcg(lambda a, b: jax_apply(js, a, b), js.a1, js.a4,
                       js.bu, js.bv, jnp.float32(1e-8), ITERS)
    else:
        want = jax_fused(js, jnp.float32(1e-8), ITERS, interpret=True)
    r = _rel(got, want)
    assert r < 1e-4, f"rel diff {r:.2e} vs {oracle} (h={h}, quad={quad})"


@pytest.mark.parametrize("quad", [True, False])
def test_reference_loop_matches_jax(quad):
    d = _system_np(40, 56, quad, seed=5)
    s = _torch_sys(d)
    got = pcg_solve(lambda a, b: apply_stencil(s, a, b), s.a1, s.a4, s.bu, s.bv,
                    1e-8, ITERS)
    js = _jax_sys(d)
    want = jax_pcg(lambda a, b: jax_apply(js, a, b), js.a1, js.a4, js.bu, js.bv,
                   jnp.float32(1e-8), ITERS)
    assert _rel(got, want) < 1e-5


def test_driver_stops_on_tolerance_and_counts_syncs():
    d = _system_np(24, 32, True, seed=2)
    s = _torch_sys(d)
    pcgmod.pcg_solve_fused.host_syncs = 0
    before = (pcgmod.pcg_pass_a.plain_calls, pcgmod.pcg_pass_b.plain_calls)
    du, dv = pcgmod.pcg_solve_fused(s, 1e30, 30)      # converged at entry
    assert float(du.abs().max()) == 0.0 and float(dv.abs().max()) == 0.0
    assert pcgmod.pcg_solve_fused.host_syncs == 1
    assert (pcgmod.pcg_pass_a.plain_calls, pcgmod.pcg_pass_b.plain_calls) == before
    pcgmod.pcg_solve_fused(s, 0.0, 5)                   # runs all 5 iterations
    assert pcgmod.pcg_solve_fused.host_syncs == 1 + 5
    assert pcgmod.pcg_pass_a.plain_calls == before[0] + 5


@pytest.mark.parametrize("quad", [True, False])
def test_pass_a_applies_the_stencil(quad):
    """Pass A's ap equals apply_stencil(p') and its x update is x + alpha p."""
    d = _system_np(20, 30, quad, seed=3)
    s = _torch_sys(d)
    planes = [s.a1, s.a4, s.a2] + ([] if quad else [s.a5, s.a6, s.a7, s.a8])
    cf = torch.stack(planes)
    rng = np.random.default_rng(4)
    x, r, p = (torch.from_numpy(rng.normal(0, 3, (2, 20, 30)).astype(np.float32))
               for _ in range(3))
    ab = torch.tensor([0.3, 0.7])
    xn, pn, ap, part = pcgmod.pcg_pass_a(x, r, p, cf, ab)
    want_p = torch.stack([r[0] / s.a1, r[1] / s.a4]) + 0.7 * p
    torch.testing.assert_close(pn, want_p, rtol=1e-6, atol=1e-5)
    au, av = apply_stencil(s, pn[0], pn[1])
    torch.testing.assert_close(ap, torch.stack([au, av]), rtol=0, atol=0)
    torch.testing.assert_close(xn, x + 0.3 * p, rtol=0, atol=0)
    torch.testing.assert_close(part.sum(), (pn * ap).sum(), rtol=1e-5, atol=1e-3)
    rn, part_b = pcgmod.pcg_pass_b(r, ap, cf, ab[:1].clone())
    torch.testing.assert_close(rn, r - 0.3 * ap, rtol=0, atol=0)
    z = torch.stack([rn[0] / s.a1, rn[1] / s.a4])
    torch.testing.assert_close(part_b.sum(0), torch.stack([(rn * z).sum(), (rn * rn).sum()]),
                               rtol=1e-5, atol=1e-3)


def _kernel_order_sums(part):
    """csrc/pcg.cu's block partials emulated lane by lane in float32: each
    32-lane warp (one block row) reduces with __shfl_down_sync at offsets
    16 .. 1 (an out-of-range lane reads its own value), then thread 0 adds
    the 8 warp sums in warp order; idle threads hold 0."""
    h, w = part.shape
    gh, gw = -(-h // 8), -(-w // 32)
    padded = np.zeros((gh * 8, gw * 32), np.float32)
    padded[:h, :w] = part
    out = []
    for by in range(gh):
        for bx in range(gw):
            warp_sums = []
            for row in range(8):
                v = padded[by * 8 + row, bx * 32:(bx + 1) * 32].copy()
                for o in (16, 8, 4, 2, 1):
                    shifted = v.copy()
                    shifted[:32 - o] = v[o:]
                    v = (v + shifted).astype(np.float32)
                warp_sums.append(v[0])
            acc = warp_sums[0]
            for x in warp_sums[1:]:
                acc = np.float32(acc + x)
            out.append(acc)
    return np.array(out, np.float32)


@pytest.mark.parametrize("hw", [(8, 32), (20, 30), (37, 70)])
def test_block_partials_follow_the_kernel_order(hw):
    part = np.random.default_rng(6).normal(0, 1e3, hw).astype(np.float32)
    got = pcgmod.block_partials(torch.from_numpy(part)).numpy()
    np.testing.assert_array_equal(got, _kernel_order_sums(part))


def test_plain_partials_have_the_kernels_layout():
    d = _system_np(20, 70, False, seed=7)
    s = _torch_sys(d)
    cf = torch.stack([s.a1, s.a4, s.a2, s.a5, s.a6, s.a7, s.a8])
    x = torch.zeros((2, 20, 70))
    r = torch.stack([s.bu, s.bv])
    _, pn, ap, part_a = pcgmod.pcg_pass_a(x, r, r, cf, torch.tensor([0.0, 0.5]))
    _, part_b = pcgmod.pcg_pass_b(r, ap, cf, torch.tensor([0.1]))
    n = 3 * 3                                # ceil(20 / 8) x ceil(70 / 32) blocks
    assert part_a.shape == (n,) and part_b.shape == (n, 2)
    assert torch.equal(part_a, pcgmod.block_partials(pn[0] * ap[0] + pn[1] * ap[1]))


def test_pass_input_checks():
    x = torch.zeros((2, 6, 7))
    cf = torch.ones((3, 6, 7))
    ab = torch.zeros(2)
    with pytest.raises(ValueError):
        pcgmod.pcg_pass_a(x, x, x, torch.ones((4, 6, 7)), ab)
    with pytest.raises(TypeError):
        pcgmod.pcg_pass_a(x.double(), x, x, cf, ab)
    with pytest.raises(ValueError):
        pcgmod.pcg_pass_b(x, x[:, :5], cf, ab[:1])
    with pytest.raises(ValueError):
        pcgmod.pcg_pass_b(x, x, cf, ab)


@pytest.mark.parametrize("quad", [True, False])
def test_pass_a_band_out_buffers(quad):
    """pcg_pass_a_band writes into ``out`` = (x_new, p_new, ap) what it
    returns without it (the plain route on the CPU), partials included, and
    refuses buffers that are inputs or of another shape or type."""
    h, w, row0, hb = 40, 33, 8, 16
    s = _torch_sys(_system_np(h, w, quad, seed=9))
    planes = [s.a1, s.a4, s.a2] + ([] if quad else [s.a5, s.a6, s.a7, s.a8])
    cf = torch.stack(planes)[:, row0:row0 + hb].contiguous()
    rng = np.random.default_rng(10)
    x, r, p = (torch.from_numpy(rng.normal(0, 1, (2, hb, w)).astype(np.float32))
               for _ in range(3))
    gr, gp = (torch.from_numpy(rng.normal(0, 1, (2, 2, w)).astype(np.float32)) for _ in range(2))
    gd = torch.from_numpy(rng.uniform(4.5, 9.0, (2, 2, w)).astype(np.float32))
    args = (x, r, p, cf, torch.tensor([0.3, 0.7]), gr, gp, gd, row0, h)
    want = pcgmod.pcg_pass_a_band(*args)
    out = tuple(torch.empty_like(x) for _ in range(3))
    got = pcgmod.pcg_pass_a_band(*args, out=out)
    assert all(g is o for g, o in zip(got, out))
    assert all(torch.equal(g, wt) for g, wt in zip(got, want))
    for bad in ((x, *out[1:]), (torch.empty((2, hb, w + 1)), *out[1:]),
                (out[0].double(), *out[1:])):
        with pytest.raises(ValueError, match="out"):
            pcgmod.pcg_pass_a_band(*args, out=bad)


@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
def test_core_on_the_assembly_kernels_outputs(al1):
    """pcg_solve_cf fed assemble_pcg's (cf, b, partials) equals
    pcg_solve_fused of the eager assembly's StencilSystem bit for bit, with
    the same device count of iterations."""
    from octane_tpu_torch.core.gradients import gradient_4th
    from octane_tpu_torch.flow.stencil import assemble_samples
    from octane_tpu_torch.ops.assemble import assemble_pcg
    from octane_tpu_torch.ops.warp import warp_bilinear_dense

    h, w = 37, 45
    rng = np.random.default_rng(12)
    g1, g2 = (torch.from_numpy(rng.normal(100, 30, (1, h, w)).astype(np.float32))
              for _ in range(2))
    u, v = (torch.from_numpy(rng.uniform(-3, 3, (h, w)).astype(np.float32)) for _ in range(2))
    gx1, gy1 = gradient_4th(g1)
    gx2, gy2 = gradient_4th(g2)
    gxx, _ = gradient_4th(gx2)
    gxy, gyy = gradient_4th(gy2)
    samples, bc_x, bc_y = warp_bilinear_dense(torch.cat([g2, gx2, gy2, gxx, gxy, gyy]), u, v)
    scalars = (al1, 0.1, 5.0, 0.2)      # al1, lambdac, alpha, lambda / alpha
    cf, b, partials = assemble_pcg(samples, bc_x, bc_y, torch.cat([g1, gx1, gy1]), u, v,
                                   0.5 * u, 0.5 * v, *scalars, True)
    sysm = assemble_samples(samples, bc_x, bc_y, g1, gx1, gy1, u, v, 0.5 * u, 0.5 * v,
                            al1, 5.0, 0.2, 0.1, True)
    counts = [torch.zeros((), dtype=torch.int32) for _ in range(2)]
    got = pcgmod.pcg_solve_cf(cf, b, partials, 1e-6, ITERS, count=counts[0])
    want = pcgmod.pcg_solve_fused(sysm, 1e-6, ITERS, count=counts[1])
    assert all(torch.equal(g, wt) for g, wt in zip(got, want))
    assert int(counts[0]) == int(counts[1]) > 0
