"""Red-black SOR on the CPU: the reference loop ``flow.cg.sor_solve`` (the
twin) against octane_tpu's XLA loop ``flow.cg.sor_solve``, and the pass
driver ``ops.sor.sor_solve_cf`` (plain half-sweeps on the CPU) against
octane_tpu's Pallas driver ``ops.pallas.sor.sor_solve_fused`` in interpret
mode, on the system recipe of tests/test_sor_kernel.py.  Budget: rel 2e-5
of the iterate's scale (test_sor_kernel.py:43-52; XLA contracts
multiply-adds, so not bitwise).  Against the twin, on the CPU, the driver
is bit-equal while the tolerance does not bind and stops within two passes
of it when it does.  The CUDA half-sweep is held against the plain one on
the card (tests/test_torch_cuda.py).
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
    """The plain half-sweep, counting red+black sweeps."""

    def __init__(self):
        self.sweeps = 0

    def __call__(self, x, cf, colour, omega, resid=False):
        self.sweeps += colour
        return sormod.sor_sweep_plain(x, cf, colour, omega, resid)


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
    du, dv = sormod.sor_solve_fused(s, 1e-8, iters, sweep=counting)
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
    du, dv = sormod.sor_solve_fused(s, tol, iters, omega=1.0, sweep=counting)
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
    assert ops.counters()["sor_sweep"] == (0, 2 * 30)
    sormod.sor_solve_fused(s, 1e-8, 16)          # 2 passes, no remainder
    assert ops.counters()["sor_host_syncs"] == 4 + 2
    du, dv = sormod.sor_solve_fused(s, 1e30, 30)  # converged at entry
    assert ops.counters()["sor_host_syncs"] == 4 + 2 + 1
    assert ops.counters()["sor_sweep"] == (0, 2 * 46)
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
