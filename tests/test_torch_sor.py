"""Red-black SOR on the CPU: the reference loop ``flow.cg.sor_solve`` (the
twin) against octane_tpu's XLA loop ``flow.cg.sor_solve``, and the pass
driver ``ops.sor.sor_solve_cf`` (plain half-sweeps on the CPU) against
octane_tpu's Pallas driver ``ops.pallas.sor.sor_solve_fused`` in interpret
mode, on the system recipe of tests/test_sor_kernel.py.  Budget: rel 2e-5
of the iterate's scale (test_sor_kernel.py:43-52; XLA contracts
multiply-adds, so not bitwise).  Against the twin, on the CPU, the driver
is bit-equal while the tolerance does not bind and stops within two passes
of it when it does.  The CUDA pass kernel is held against the plain pass
on the card (tests/test_torch_cuda.py).  Its geometry (strips with 2k halo
columns, row segments with 2k halo rows, cells next to a cut never
updated) and its schedule (a ring of 4k + 4 rows filled one row ahead,
half-sweep t on row s - 2t - 1 at step s) are held here in plain PyTorch
against ``sor_pass_plain``, bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from octane_tpu.flow.cg import sor_solve as jax_sor
from octane_tpu.flow.stencil import StencilSystem as JaxSystem
from octane_tpu.ops.pallas.sor import sor_solve_fused as jax_fused
from octane_tpu_torch import ops
from octane_tpu_torch.flow.cg import sor_rdet, sor_solve
from octane_tpu_torch.flow.stencil import StencilSystem, apply_stencil
from octane_tpu_torch.ops import sor as sormod
from octane_tpu_torch.ops.pcg import block_partials

torch.set_num_threads(2)


def _system_np(h, w, quad, seed=0):
    """tests/test_sor_kernel.py:_make_sys as numpy arrays (None: scalar -1)."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return rng.uniform(lo, hi, (h, w)).astype(np.float32)

    offd = [None] * 4 if quad else [-f(0.2, 1.2) for _ in range(4)]
    a1, a4, a2 = f(4.5, 9.0), f(4.5, 9.0), f(-0.4, 0.4)
    return dict(a1=a1, a2=a2, a4=a4, a5=offd[0], a6=offd[1], a7=offd[2], a8=offd[3],
                bu=f(-1, 1), bv=f(-1, 1))


def _torch_sys(d):
    return StencilSystem(**{k: -1.0 if a is None else torch.from_numpy(a)
                            for k, a in d.items()})


def _jax_sys(d):
    return JaxSystem(**{k: jnp.float32(-1) if a is None else jnp.asarray(a)
                        for k, a in d.items()})


def _assert_close(got, want, rel=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want).max() / max(np.abs(got).max(), 1e-3)
    assert d < rel, f"rel diff {d:.3e} exceeds {rel:.0e}"


class _Counting:
    """The plain pass, counting red+black sweeps."""

    def __init__(self):
        self.sweeps = 0

    def __call__(self, x, cf, sweeps, omega, out=None):
        self.sweeps += sweeps
        return sormod.sor_pass_plain(x, cf, sweeps, omega, out)


ITERS = [3, 8, 13, 30]
SHAPES = [(128, 256), (133, 257)]


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_jax_sor_solve(shape, quad, iters):
    d = _system_np(*shape, quad)
    got = sor_solve(_torch_sys(d), 1e-8, iters)
    want = jax_sor(_jax_sys(d), jnp.float32(1e-8), iters)
    for g, wv in zip(got, want):
        _assert_close(g.numpy(), wv)


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_driver_matches_jax_pallas_driver(shape, quad, iters):
    d = _system_np(*shape, quad, seed=1)
    got = sormod.sor_solve_fused(_torch_sys(d), 1e-8, iters)
    want = jax_fused(_jax_sys(d), jnp.float32(1e-8), iters, interpret=True)
    for g, wv in zip(got, want):
        _assert_close(g.numpy(), wv)


@pytest.mark.parametrize("shape", [(2, 2), (2, 7), (5, 2), (9, 12)])
def test_twin_matches_jax_on_minimal_grids(shape):
    """The mirror-at-1 edges where the neighbour across the edge is the only
    other cell of that row or column."""
    for quad in (True, False):
        d = _system_np(*shape, quad, seed=5)
        got = sor_solve(_torch_sys(d), 1e-8, 6)
        want = jax_sor(_jax_sys(d), jnp.float32(1e-8), 6)
        for g, wv in zip(got, want):
            _assert_close(g.numpy(), wv)


@pytest.mark.parametrize("iters", [1, 7, 8, 13, 30])
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("shape", [(2, 2), (40, 70), (133, 257)])
def test_driver_bit_equal_to_twin_when_tol_does_not_bind(shape, quad, iters):
    s = _torch_sys(_system_np(*shape, quad, seed=2))
    counting = _Counting()
    du, dv = sormod.sor_solve_fused(s, 1e-8, iters, pass_fn=counting)
    tu, tv = sor_solve(s, 1e-8, iters)
    assert counting.sweeps == iters
    assert torch.equal(du, tu) and torch.equal(dv, tv)


@pytest.mark.parametrize("iters", [400, 405])
@pytest.mark.parametrize("quad", [True, False])
def test_driver_stops_within_two_passes_when_tol_binds(quad, iters, monkeypatch):
    """Gauss-Seidel (omega = 1: the random robust system is not SPD) until
    ||r||^2 <= tol.  The twin tests every sweep, the driver once per pass of
    8 on the residual the pass saw on entry: it runs between 0 and 2 x 8
    sweeps more, and its iterate is the twin's after that many sweeps.  At
    405 the remainder pass is skipped because the tolerance bound first."""
    import octane_tpu_torch.flow.cg as cgmod

    s = _torch_sys(_system_np(64, 96, quad, seed=3))
    b2 = float(torch.sum(s.bu * s.bu) + torch.sum(s.bv * s.bv))
    tol = 1e-10 * b2
    counting = _Counting()
    du, dv = sormod.sor_solve_fused(s, tol, iters, omega=1.0, pass_fn=counting)
    n_driver = counting.sweeps
    applies = []

    def counted_apply(*args):
        applies.append(1)
        return apply_stencil(*args)

    monkeypatch.setattr(cgmod, "apply_stencil", counted_apply)
    sor_solve(s, tol, iters, omega=1.0)
    n_twin = len(applies) // 2                   # two half-sweeps per sweep
    monkeypatch.undo()
    assert n_twin < iters // 2, "the tolerance must bind"
    assert n_twin <= n_driver <= n_twin + 2 * sormod.PASS_SWEEPS
    ref_u, ref_v = sor_solve(s, 0.0, n_driver, omega=1.0)
    assert torch.equal(du, ref_u) and torch.equal(dv, ref_v)
    au, av = apply_stencil(s, du, dv)
    assert float(torch.sum((s.bu - au) ** 2) + torch.sum((s.bv - av) ** 2)) <= tol


def test_host_syncs_one_per_pass():
    s = _torch_sys(_system_np(24, 32, True, seed=4))
    ops.reset_counters()
    sormod.sor_solve_fused(s, 1e-8, 30)          # 3 passes of 8 + remainder check
    assert ops.counters()["sor_host_syncs"] == 4
    assert ops.counters()["sor_pass"] == (0, 4)      # one per pass
    sormod.sor_solve_fused(s, 1e-8, 16)          # 2 passes, no remainder
    assert ops.counters()["sor_host_syncs"] == 4 + 2
    du, dv = sormod.sor_solve_fused(s, 1e30, 30)  # converged at entry
    assert ops.counters()["sor_host_syncs"] == 4 + 2 + 1
    assert ops.counters()["sor_pass"] == (0, 6)
    assert float(du.abs().max()) == 0.0 and float(dv.abs().max()) == 0.0


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("colour", [0, 1])
def test_half_sweep_updates_one_colour(quad, colour):
    """In place without ``resid``; with it x is left as it is and the
    partials are the full-grid pre-update ||b - A x||^2 in block order."""
    h, w = 21, 34
    s = _torch_sys(_system_np(h, w, quad, seed=6))
    cf = sormod.build_cf(s)
    assert cf.shape == (6 if quad else 10, h, w)
    assert torch.equal(cf[-1], sor_rdet(s))
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 0.3, (2, h, w))
                         .astype(np.float32))
    x0 = x.clone()
    new, part = sormod.sor_sweep(x, cf, colour, 1.9, resid=True)
    assert torch.equal(x, x0)
    au, av = apply_stencil(s, x[0], x[1])
    ru, rv = s.bu - au, s.bv - av
    assert torch.equal(part, block_partials(ru * ru + rv * rv))
    jj, ii = np.mgrid[0:h, 0:w]
    mine = torch.from_numpy((ii + jj) % 2 == colour)
    assert torch.equal(new[:, ~mine], x0[:, ~mine])
    ndu = (s.a4 * ru - s.a2 * rv) * sor_rdet(s)
    assert torch.equal(new[0][mine], (x0[0] + 1.9 * ndu)[mine])
    same, none = sormod.sor_sweep(x, cf, colour, 1.9)
    assert same is x and none is None and torch.equal(x, new)


def test_omega_threads_through():
    s = _torch_sys(_system_np(32, 48, False, seed=8))
    js = _jax_sys(_system_np(32, 48, False, seed=8))
    du, _ = sormod.sor_solve_fused(s, 1e-8, 6, omega=1.5)
    _assert_close(du.numpy(), jax_sor(js, jnp.float32(1e-8), 6, omega=1.5)[0])
    du2, _ = sormod.sor_solve_fused(s, 1e-8, 6, omega=1.9)
    assert float((du - du2).abs().max()) > 1e-4


def test_geometry_checks_raise():
    cf = torch.ones((10, 6, 7))
    x = torch.zeros((2, 6, 7))
    with pytest.raises(ValueError):
        sormod.sor_solve_cf(torch.ones((7, 6, 7)), 1.0, 1e-8, 8)
    with pytest.raises(ValueError):
        sormod.sor_solve_cf(torch.ones((6, 1, 7)), 1.0, 1e-8, 8)
    with pytest.raises(ValueError):
        sormod.sor_solve_cf(cf, 1.0, 1e-8, 0)
    with pytest.raises(ValueError):
        sormod.sor_sweep(torch.zeros((2, 6, 8)), cf, 0)
    with pytest.raises(ValueError):
        sormod.sor_sweep(x, cf, 2)
    with pytest.raises(TypeError):
        sormod.sor_sweep(x, cf.double(), 0)
    with pytest.raises(ValueError):
        sormod.sor_pass(x, cf, 9)
    with pytest.raises(ValueError):
        sormod.sor_pass(x, cf, 8, out=x)


# ---------------------------------------------------------------------------
# the pass kernel's geometry and schedule, in plain PyTorch
# ---------------------------------------------------------------------------

def _pass_inputs(h, w, quad, seed=11):
    s = _torch_sys(_system_np(h, w, quad, seed=seed))
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, 0.3, (2, h, w))
                         .astype(np.float32))
    return x, sormod.build_cf(s)


def _blocks(h, w, k, strip, seg):
    """(interior, loaded) column and row ranges of each block of the kernel."""
    halo = 2 * k
    for r0 in range(0, h, seg):
        for c0 in range(0, w, strip):
            c1, r1 = min(c0 + strip, w), min(r0 + seg, h)
            yield ((c0, c1), (max(0, c0 - halo), min(w, c1 + halo)),
                   (r0, r1), (max(0, r0 - halo), min(h, r1 + halo)))


def _block_decomposition(x, cf, k, strip, seg=None, omega=1.9):
    """Each block's loaded slice through 2k plain half-sweeps (colour
    corrected for the slice's parity; the slice's own mirror edges stand in
    at cuts), keeping the interior: the overlap argument."""
    _, h, w = x.shape
    out = torch.empty_like(x)
    for (c0, c1), (lc, rc), (r0, r1), (lr, rr) in _blocks(h, w, k, strip, seg or h):
        xs = x[:, lr:rr, lc:rc].clone()
        cs = cf[:, lr:rr, lc:rc].contiguous()
        flip = (lr + lc) & 1
        for _ in range(k):
            for colour in (0, 1):
                sormod.sor_sweep_plain(xs, cs, colour ^ flip, omega)
        out[:, r0:r1, c0:c1] = xs[:, r0 - lr:r1 - lr, c0 - lc:c1 - lc]
    return out


@pytest.mark.parametrize("shape", [(2, 2), (19, 40), (500, 372), (7, 20)])
@pytest.mark.parametrize("strip", [32, 64])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_strip_decomposition_equals_pass(k, strip, shape):
    """Strips of ``strip`` columns with 2k halo columns on each side give
    the whole-grid pass bit for bit (7 x 20: narrower than one strip)."""
    x, cf = _pass_inputs(*shape, quad=k != 3)
    want, _ = sormod.sor_pass_plain(x, cf, k)
    assert torch.equal(_block_decomposition(x, cf, k, strip), want)


@pytest.mark.parametrize("k,seg", [(1, 8), (3, 16), (8, 8)])
def test_row_segments_equal_pass(k, seg):
    x, cf = _pass_inputs(61, 75, quad=False)
    want, _ = sormod.sor_pass_plain(x, cf, k)
    assert torch.equal(_block_decomposition(x, cf, k, 32, seg), want)


@pytest.mark.parametrize("a,b", [(1, 1), (3, 5), (2, 6)])
@pytest.mark.parametrize("quad", [True, False])
def test_pass_split_is_bitwise(quad, a, b):
    """run(x, a + b) == run(run(x, a), b): the remainder pass and a pass of
    4 + 4 give the same iterate as one pass."""
    x, cf = _pass_inputs(23, 41, quad)
    whole, _ = sormod.sor_pass_plain(x, cf, a + b)
    first, _ = sormod.sor_pass_plain(x, cf, a)
    split, _ = sormod.sor_pass_plain(first, cf, b)
    assert torch.equal(whole, split)


def _ring_cell(ring, l, rn, rs, qw, qe, nc, quad):
    """Residual of one ring row, as csrc/sor.cu's ``residual``."""
    def at(row, p):
        return ring[row % ring.shape[0], p]

    xu, xv = at(l, 0), at(l, 1)
    wu, eu, nu, su = xu[qw], xu[qe], at(rn, 0), at(rs, 0)
    wv, ev, nv, sv = xv[qw], xv[qe], at(rn, 1), at(rs, 1)
    if quad:
        off_u = -wu + -eu + -nu + -su
        off_v = -wv + -ev + -nv + -sv
    else:
        a5, a6, a7, a8 = (at(l, p) for p in (7, 8, 9, 10))
        off_u = a5 * wu + a7 * eu + a6 * nu + a8 * su
        off_v = a5 * wv + a7 * ev + a6 * nv + a8 * sv
    a1, a4, a2 = at(l, 2), at(l, 3), at(l, 4)
    ru = at(l, 5) - (a1 * xu + a2 * xv + off_u)
    rv = at(l, 6) - (a2 * xu + a4 * xv + off_v)
    return xu, xv, ru, rv


def _warp_tree(v):
    """Sums of 32-column groups by the shuffle tree (lane l adds l + n)."""
    v = v.reshape(-1, 32)
    n = 32
    while n > 1:
        n //= 2
        v = v[:, :n] + v[:, n:2 * n]
    return v[:, 0]


def _emulate_pass_kernel(x, cf, k, strip, seg, omega=1.9):
    """csrc/sor.cu's schedule, one ring row at a time: row s + 1 lands in
    slot (s + 1) % R at the start of step s (the kernel stores it at the
    end), the residual of row s - 1, half-sweep t on row s - 2t - 1 and the
    write-out of row s - 4k - 2, reading only the ring."""
    nc, h, w = cf.shape
    quad = nc == 6
    halo = 2 * k
    nring = 2 * halo + 4
    gw = -(-w // 32)
    nan = float("nan")
    out = torch.full_like(x, nan)
    partials = torch.full((-(-h // 8) * gw,), nan)
    src = torch.cat([x, cf])
    for (c0, c1), (lc, rc), (r0, r1), (lr, rr) in _blocks(h, w, k, strip, seg):
        nl = rr - lr
        ring = torch.full((nring, 2 + nc, rc - lc), nan)
        cols = torch.arange(lc, rc)
        qw = (torch.where(cols == 0, 1, cols - 1) - lc).clamp(min=0)
        qe = (torch.where(cols == w - 1, w - 2, cols + 1) - lc).clamp(max=rc - lc - 1)
        stale = ((cols == lc) & (lc > 0)) | ((cols == rc - 1) & (rc < w))

        def neighbours(l):
            i = lr + l
            return (1 if i == 0 else i - 1) - lr, (h - 2 if i == h - 1 else i + 1) - lr

        acc = torch.zeros(strip // 32)
        ring[0] = src[:, lr, lc:rc]
        for s in range(nl + 2 * halo + 2):
            if s + 1 < nl:
                ring[(s + 1) % nring] = src[:, lr + s + 1, lc:rc]
            l = s - 1
            if 0 <= l < nl and r0 <= lr + l < r1:
                i = lr + l
                _, _, ru, rv = _ring_cell(ring, l, *neighbours(l), qw, qe, nc, quad)
                part = torch.zeros(strip)
                part[:c1 - c0] = (ru * ru + rv * rv)[c0 - lc:c1 - lc]
                sums = _warp_tree(part)
                acc = sums if i % 8 == 0 else acc + sums
                if i % 8 == 7 or i == h - 1:
                    for g in range(strip // 32):
                        if c0 + 32 * g < w:
                            partials[(i // 8) * gw + c0 // 32 + g] = acc[g]
            for t in range(1, 2 * k + 1):
                l = s - 2 * t - 1
                if not 0 <= l < nl or (lr > 0 and l == 0) or (rr < h and l == nl - 1):
                    continue
                xu, xv, ru, rv = _ring_cell(ring, l, *neighbours(l), qw, qe, nc, quad)
                slot = ring[l % nring]
                a1, a4, a2, rdet = slot[2], slot[3], slot[4], slot[1 + nc]
                mine = ((lr + l + cols) % 2 == (t - 1) % 2) & ~stale
                ndu = (a4 * ru - a2 * rv) * rdet
                ndv = (a1 * rv - a2 * ru) * rdet
                slot[0] = torch.where(mine, xu + omega * ndu, xu)
                slot[1] = torch.where(mine, xv + omega * ndv, xv)
            l = s - 2 * halo - 2
            if 0 <= l < nl and r0 <= lr + l < r1:
                out[:, lr + l, c0:c1] = ring[l % nring, :2, c0 - lc:c1 - lc]
    return out, partials


@pytest.mark.parametrize("shape,k,strip,seg", [
    ((2, 2), 1, 32, 8), ((2, 2), 8, 32, 8), ((19, 40), 3, 32, 8),
    ((19, 40), 8, 32, 16), ((37, 70), 2, 64, 16), ((9, 33), 8, 32, 8)])
@pytest.mark.parametrize("quad", [True, False])
def test_kernel_schedule_equals_pass(quad, shape, k, strip, seg):
    """The kernel's ring, step order and residual accumulation give the
    plain pass's iterate and partials bit for bit."""
    x, cf = _pass_inputs(*shape, quad)
    want, want_part = sormod.sor_pass_plain(x, cf, k)
    got, part = _emulate_pass_kernel(x, cf, k, strip, seg)
    assert torch.equal(got, want)
    assert torch.equal(part, want_part)


def test_solve_ping_pongs_two_buffers():
    """Passes write into the other of two buffers; the plain pass fills
    ``out`` and never changes its input."""
    x, cf = _pass_inputs(12, 17, quad=True)
    x0, out = x.clone(), torch.empty_like(x)
    new, part = sormod.sor_pass(x, cf, 2, out=out)
    assert new is out and torch.equal(x, x0)
    assert torch.equal(new, sormod.sor_pass_plain(x, cf, 2)[0])
    assert part.shape == (2 * 1,)
