"""Jacobi-preconditioned conjugate gradient, the reference-exact loop
(counterpart of octane_tpu.flow.cg.pcg_solve; the in-kernel PCG of
oct_variational_optical_flow.cu:1100-1183).

x0 = 0, r = b, M = diag(A); stop when ||r||^2 <= tol or after ``iters``
iterations.  The oracle for the kernel driver ``ops.pcg.pcg_solve_fused``
in the tests and in chip_smoke.py.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


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
