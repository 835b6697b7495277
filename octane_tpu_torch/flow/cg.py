"""The two relaxers' reference loops (counterpart of octane_tpu.flow.cg).

* ``pcg_solve``: Jacobi-preconditioned conjugate gradient, the
  reference-exact loop (the in-kernel PCG of
  oct_variational_optical_flow.cu:1100-1183): x0 = 0, r = b, M = diag(A);
  stop when ||r||^2 <= tol or after ``iters`` iterations.  The oracle of
  the kernel driver ``ops.pcg.pcg_solve_fused``.
* ``sor_solve``: red-black SOR with the exact 2 x 2 block solve, stopping
  on the residual every sweep.  The oracle of the kernel driver
  ``ops.sor.sor_solve_cf``, which reads the stopping test once per pass.

Both are used by the tests and chip_smoke.py.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from octane_tpu_torch.flow.stencil import apply_stencil


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def pcg_solve(
    apply_fn: Callable,          # (du, dv) -> (Au, Av)
    diag_u: torch.Tensor,
    diag_v: torch.Tensor,
    bu: torch.Tensor,
    bv: torch.Tensor,
    tol: float,
    iters: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve A x = b from x = 0; returns (du, dv)."""
    minv_u = 1.0 / diag_u
    minv_v = 1.0 / diag_v
    xu = torch.zeros_like(bu)
    xv = torch.zeros_like(bv)
    ru, rv = bu, bv
    zu, zv = minv_u * ru, minv_v * rv
    pu, pv = zu, zv
    resid = _dot(ru, ru) + _dot(rv, rv)
    rz = _dot(ru, zu) + _dot(rv, zv)
    tol32 = float(np.float32(tol))
    k = 0
    while k < iters and float(resid) > tol32:
        apu, apv = apply_fn(pu, pv)
        pap = _dot(pu, apu) + _dot(pv, apv)
        alpha = rz / pap
        xu = xu + alpha * pu
        xv = xv + alpha * pv
        ru = ru - alpha * apu
        rv = rv - alpha * apv
        resid = _dot(ru, ru) + _dot(rv, rv)
        zu = minv_u * ru
        zv = minv_v * rv
        rz_new = _dot(ru, zu) + _dot(rv, zv)
        beta = rz_new / rz
        rz = rz_new
        pu = zu + beta * pu
        pv = zv + beta * pv
        k += 1
    return xu, xv


def sor_rdet(sys) -> torch.Tensor:
    """Reciprocal determinant of the local 2 x 2 block (a1 a2; a2 a4),
    hoisted out of the sweeps (octane_tpu.flow.cg.sor_rdet without its
    optimization barriers)."""
    return 1.0 / (sys.a1 * sys.a4 - sys.a2 * sys.a2)


def checkerboard(h: int, w: int, device) -> torch.Tensor:
    """The red cells, (row + column) even, as an (h, w) bool mask."""
    jj = torch.arange(h, device=device)[:, None]
    ii = torch.arange(w, device=device)[None, :]
    return (ii + jj) % 2 == 0


def sor_solve(sys, tol: float, iters: int, omega: float = 1.9
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Red-black SOR on the coupled stencil system from x = 0; returns
    (du, dv).

    Each colour half-sweep takes the residual r = b - A x over the full grid
    and applies the omega-damped exact 2 x 2 block solve on its colour.  The
    red half-sweep's residual is the stopping test: sweep k runs while
    k < ``iters`` and the residual that sweep k - 1 saw on entry (||b||^2
    before the first) exceeds ``tol``, as octane_tpu's XLA while loop does.
    """
    h, w = sys.bu.shape
    red = checkerboard(h, w, sys.bu.device)
    rdet = sor_rdet(sys)

    def colour_sweep(du, dv, mask):
        au, av = apply_stencil(sys, du, dv)
        ru = sys.bu - au
        rv = sys.bv - av
        ndu = (sys.a4 * ru - sys.a2 * rv) * rdet
        ndv = (sys.a1 * rv - sys.a2 * ru) * rdet
        du = torch.where(mask, du + omega * ndu, du)
        dv = torch.where(mask, dv + omega * ndv, dv)
        return du, dv, _dot(ru, ru) + _dot(rv, rv)

    du = torch.zeros_like(sys.bu)
    dv = torch.zeros_like(sys.bv)
    resid = _dot(sys.bu, sys.bu) + _dot(sys.bv, sys.bv)
    tol32 = float(np.float32(tol))
    k = 0
    while k < iters and float(resid) > tol32:
        du, dv, resid = colour_sweep(du, dv, red)
        du, dv, _ = colour_sweep(du, dv, ~red)
        k += 1
    return du, dv
