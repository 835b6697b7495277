"""Euler-Lagrange assembly and the matrix-free coupled 5-point stencil
(counterpart of octane_tpu.flow.stencil).

The coefficients of the 2N x 2N system live in seven (H, W) fields, the
operator is applied matrix-free with the solver's mirror-at-1 edges
(oct_variational_optical_flow.cu:868-1077), and ``assemble`` reproduces
the data and smoothness terms of the assembly loop (:611-1097) in the
JAX package's operation order.  In the quadratic GNC step (al1 == 1) the
four off-diagonals are the Python scalar -1.0.  ``assemble_samples`` is the
same assembly on given warp outputs; ``ops.assemble`` builds the SOR
coefficient stack and the PCG system from it and holds its CUDA kernels
to it.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from octane_tpu_torch.core.bc import mirror_shift
from octane_tpu_torch.core.psi import psi_deriv
from octane_tpu_torch.ops.warp import warp_bilinear_dense

Coef = Union[torch.Tensor, float]


class StencilSystem(NamedTuple):
    """Coefficient fields of the coupled 5-point system A w = b."""

    a1: torch.Tensor   # u-diagonal
    a2: torch.Tensor   # u<->v coupling (symmetric)
    a4: torch.Tensor   # v-diagonal
    a5: Coef           # west  (i-1, j)
    a6: Coef           # north (i, j-1)
    a7: Coef           # east  (i+1, j)
    a8: Coef           # south (i, j+1)
    bu: torch.Tensor   # rhs, u equation
    bv: torch.Tensor   # rhs, v equation


def apply_stencil(sys: StencilSystem, du: torch.Tensor, dv: torch.Tensor):
    """Matrix-free A @ (du, dv) with mirror-at-1 boundary handling."""

    def op(f):
        return (sys.a5 * mirror_shift(f, -1, -1)
                + sys.a7 * mirror_shift(f, 1, -1)
                + sys.a6 * mirror_shift(f, -1, -2)
                + sys.a8 * mirror_shift(f, 1, -2))

    au = sys.a1 * du + sys.a2 * dv + op(du)
    av = sys.a2 * du + sys.a4 * dv + op(dv)
    return au, av


def _sq(x):
    return x * x


def assemble(
    geo1, geo2, gx1, gy1, gx2, gy2, gxx, gxy, gyy,
    u, v, uhat, vhat,
    al1: float, alpha: float, lam_over_alpha: float, lambdac: float,
    dozim: bool, warp_fn=None, stack=None,
) -> StencilSystem:
    """Build the linearised Euler-Lagrange system around (u, v).

    Image/gradient stacks are (C, H, W), flow fields (H, W).  ``al1`` is the
    GNC blend (1, 0.5, 0); al1 == 1 emits the quadratic system with scalar
    off-diagonals.  ``lambdac`` is the per-level hinting weight.
    ``warp_fn(stack, u, v) -> (samples, bc_x, bc_y)`` defaults to the plain
    ``warp_bilinear_dense``; ``stack`` is [geo2, gx2, gy2, gxx, gxy, gyy].
    """
    if warp_fn is None:
        warp_fn = warp_bilinear_dense
    if stack is None:
        stack = torch.cat([geo2, gx2, gy2, gxx, gxy, gyy], dim=0)
    samples, bc_x, bc_y = warp_fn(stack, u, v)
    return assemble_samples(samples, bc_x, bc_y, geo1, gx1, gy1, u, v, uhat, vhat,
                            al1, alpha, lam_over_alpha, lambdac, dozim)


def assemble_samples(
    samples, bc_x, bc_y, geo1, gx1, gy1,
    u, v, uhat, vhat,
    al1: float, alpha: float, lam_over_alpha: float, lambdac: float,
    dozim: bool,
) -> StencilSystem:
    """``assemble`` on given warp outputs: ``samples`` is the (6C, H, W)
    warped [geo2, gx2, gy2, gxx, gxy, gyy] stack, ``bc_x``/``bc_y`` its
    clamp flags."""
    c_, h, w = geo1.shape
    quad_only = float(al1) == 1.0
    one_m_al1 = 1.0 - al1

    # --- smoothness weights from mirror-shifted neighbours (ref :654-725) ---
    uW, uE = mirror_shift(u, -1, -1), mirror_shift(u, 1, -1)
    uN, uS = mirror_shift(u, -1, -2), mirror_shift(u, 1, -2)
    vW, vE = mirror_shift(v, -1, -1), mirror_shift(v, 1, -1)
    vN, vS = mirror_shift(v, -1, -2), mirror_shift(v, 1, -2)
    psisnmiuq = uW + uN + uE + uS
    psisnmivq = vW + vN + vE + vS

    if not quad_only:
        uNE, uSE = mirror_shift(uE, -1, -2), mirror_shift(uE, 1, -2)
        uNW, uSW = mirror_shift(uW, -1, -2), mirror_shift(uW, 1, -2)
        vNE, vSE = mirror_shift(vE, -1, -2), mirror_shift(vE, 1, -2)
        vNW, vSW = mirror_shift(vW, -1, -2), mirror_shift(vW, 1, -2)

        u_ip1 = _sq(uE - u) + _sq(0.25 * ((uSE - uNE) + (uS - uN))) \
            + _sq(vE - v) + _sq(0.25 * ((vSE - vNE) + (vS - vN)))
        u_im1 = _sq(u - uW) + _sq(0.25 * ((uSW - uNW) + (uS - uN))) \
            + _sq(v - vW) + _sq(0.25 * ((vSW - vNW) + (vS - vN)))
        u_jp1 = _sq(uS - u) + _sq(0.25 * ((uSE - uSW) + (uE - uW))) \
            + _sq(vS - v) + _sq(0.25 * ((vSE - vSW) + (vE - vW)))
        u_jm1 = _sq(u - uN) + _sq(0.25 * ((uNE - uNW) + (uE - uW))) \
            + _sq(v - vN) + _sq(0.25 * ((vNE - vNW) + (vE - vW)))

        psis1 = psi_deriv(u_im1)   # west
        psis2 = psi_deriv(u_jm1)   # north
        psis3 = psi_deriv(u_ip1)   # east
        psis4 = psi_deriv(u_jp1)   # south
        psistot = psis1 + psis2 + psis3 + psis4
        psisnmiu = psis1 * uW + psis2 * uN + psis3 * uE + psis4 * uS
        psisnmiv = psis1 * vW + psis2 * vN + psis3 * vE + psis4 * vS

    # --- warped data terms, accumulated over channels (ref :727-829) --------
    bc_xy = bc_x | bc_y
    zero = torch.zeros((h, w), dtype=torch.float32, device=u.device)
    vr1 = vr2 = vr4 = vr5 = vr6 = intcomp = zero
    vr12 = vr22 = vr42 = vr52 = vr62 = intcomp2 = zero
    for c in range(c_):
        g2w = samples[c]
        # zero warped gradients where the warp clamped (ref :767-779)
        ix = torch.where(bc_x, 0.0, samples[c_ + c])
        iy = torch.where(bc_y, 0.0, samples[2 * c_ + c])
        ixx = torch.where(bc_x, 0.0, samples[3 * c_ + c])
        ixy = torch.where(bc_xy, 0.0, samples[4 * c_ + c])
        iyy = torch.where(bc_y, 0.0, samples[5 * c_ + c])

        it = g2w - geo1[c]
        ixt = ix - gx1[c]
        iyt = iy - gy1[c]
        if dozim:
            na = 1.0 / (ix * ix + iy * iy + 1.0)
            nb = 1.0 / (ixx * ixx + ixy * ixy + 1.0)
            nc = 1.0 / (ixy * ixy + iyy * iyy + 1.0)
        else:
            na = nb = nc = 1.0
        intcomp = intcomp + na * it * it
        intcomp2 = intcomp2 + nb * ixt * ixt + nc * iyt * iyt
        vr1 = vr1 + na * ix * ix
        vr12 = vr12 + nb * ixx * ixx + nc * ixy * ixy
        vr2 = vr2 + na * ix * iy
        vr22 = vr22 + nb * ixx * ixy + nc * iyy * ixy
        vr4 = vr4 + na * iy * iy
        vr42 = vr42 + nb * ixy * ixy + nc * iyy * iyy
        vr5 = vr5 + (-na * it) * ix
        vr52 = vr52 - (nb * ixt * ixx + nc * iyt * ixy)
        vr6 = vr6 + (-na * it) * iy
        vr62 = vr62 - (nb * ixt * ixy + nc * iyt * iyy)

    hint_u = lambdac * (u - uhat)
    hint_v = lambdac * (v - vhat)

    if quad_only:
        # the pure-quadratic system of GNC step 0 (ref :837-865, robust half 0)
        a1 = vr1 / alpha + lam_over_alpha * vr12 + lambdac + 4.0
        a2 = vr2 / alpha + lam_over_alpha * vr22
        a4 = vr4 / alpha + lam_over_alpha * vr42 + lambdac + 4.0
        bu = vr5 / alpha + lam_over_alpha * vr52 - hint_u + psisnmiuq - 4.0 * u
        bv = vr6 / alpha + lam_over_alpha * vr62 - hint_v + psisnmivq - 4.0 * v
        return StencilSystem(a1, a2, a4, -1.0, -1.0, -1.0, -1.0, bu, bv)

    psid = psi_deriv(intcomp) / alpha
    psid2 = lam_over_alpha * psi_deriv(intcomp2)

    # --- stencil coefficients (ref :837-865) --------------------------------
    a1 = al1 * (vr1 / alpha + lam_over_alpha * vr12 + lambdac + 4.0) \
        + one_m_al1 * (psid * vr1 + psid2 * vr12 + lambdac + psistot)
    a2 = al1 * (vr2 / alpha + lam_over_alpha * vr22) \
        + one_m_al1 * (psid * vr2 + psid2 * vr22)
    a4 = al1 * (vr4 / alpha + lam_over_alpha * vr42 + lambdac + 4.0) \
        + one_m_al1 * (psid * vr4 + psid2 * vr42 + lambdac + psistot)
    a5 = -(al1 + one_m_al1 * psis1)
    a6 = -(al1 + one_m_al1 * psis2)
    a7 = -(al1 + one_m_al1 * psis3)
    a8 = -(al1 + one_m_al1 * psis4)

    # --- right-hand side (ref :1086-1093) -----------------------------------
    bu = al1 * (vr5 / alpha + lam_over_alpha * vr52 - hint_u + psisnmiuq - 4.0 * u) \
        + one_m_al1 * (psid * vr5 + psid2 * vr52 - hint_u + psisnmiu - psistot * u)
    bv = al1 * (vr6 / alpha + lam_over_alpha * vr62 - hint_v + psisnmivq - 4.0 * v) \
        + one_m_al1 * (psid * vr6 + psid2 * vr62 - hint_v + psisnmiv - psistot * v)
    return StencilSystem(a1, a2, a4, a5, a6, a7, a8, bu, bv)
