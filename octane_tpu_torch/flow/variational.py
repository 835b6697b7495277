"""Coarse-to-fine variational optical flow (modified Zimmer / Brox);
counterpart of octane_tpu.flow.variational.

The pyramid is a Python loop over levels; at each level ``solve_level``
runs GNC x liters rounds of warp -> assemble -> solve.  With
``solver="pcg"`` (the default) a round is the warp, the eager assembly
(flow.stencil) and the Jacobi-PCG passes; with ``solver="sor"`` it is the
warp, the fused assembly (ops.assemble) and the multi-sweep red-black SOR
(ops.sor), as octane_tpu's fused chain on one device.  Every kernel goes
through its wrapper in ``ops`` at every level: the CUDA kernel on the card,
the plain version on the CPU.  The internal ``plain`` argument of
``solve_level``/``_coarse_to_fine`` calls the plain versions on any device
instead (each call counted as a plain call), so the kernels can be timed
and checked against them on the card; no option of ``OFConfig`` or the CLI
reaches it.

The mesh path (octane_tpu_torch.parallel.sharded) runs the same schedule
(``level_schedule``, ``gnc_rounds``) on row bands.

Numerics follow the reference (SURVEY.md section 8): per-level images are
blurred and floor-subsampled from full resolution, first-guess fields are
downsampled the same way and scaled by the level factor, flow upsampling is
half-pixel bicubic divided by the scale factor, and the hinting weight
decays as lambdac * 0.5^k (oct_variational_optical_flow.cu:487-575).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.gradients import gradient_4th
from octane_tpu_torch.core.zoom import pyramid_downsample, zoom_in_flow, zoom_size
from octane_tpu_torch.flow.stencil import assemble
from octane_tpu_torch.ops.assemble import assemble_cf, assemble_cf_plain
from octane_tpu_torch.ops.pcg import (pcg_pass_a, pcg_pass_a_plain, pcg_pass_b,
                                      pcg_pass_b_plain, pcg_solve_fused)
from octane_tpu_torch.ops.sor import sor_pass, sor_pass_plain, sor_solve_cf
from octane_tpu_torch.ops.warp import warp, warp_bilinear_dense


def _f32(x: float) -> float:
    """A Python float rounded to float32, as the JAX solver's scalars are."""
    return float(np.float32(x))


def _counted_plain(wrapper, plain_fn):
    """``plain_fn`` on any device, each call added to ``wrapper.plain_calls``."""
    def run(*args, **kwargs):
        wrapper.plain_calls += 1
        return plain_fn(*args, **kwargs)
    return run


_PLAIN_WARP = _counted_plain(warp, warp_bilinear_dense)
_PLAIN_PASSES = (_counted_plain(pcg_pass_a, pcg_pass_a_plain),
                 _counted_plain(pcg_pass_b, pcg_pass_b_plain))
_PLAIN_ASSEMBLE = _counted_plain(assemble_cf, assemble_cf_plain)
_PLAIN_PASS = _counted_plain(sor_pass, sor_pass_plain)


def level_schedule(cfg: OFConfig, h: int, w: int):
    """(k, factor, (nyy, nxx), lambdac_k) of each pyramid level, coarsest
    first (oct_variational_optical_flow.cu:487-575)."""
    for k in range(cfg.kiters):
        factor = float(np.float32(cfg.scale_factor) ** (cfg.kiters - k - 1))
        yield k, factor, (zoom_size(h, factor), zoom_size(w, factor)), \
            (cfg.lambdac / cfg.alpha) * (0.5 ** k)


def gnc_rounds(gnc_steps: int, liters: int):
    """The GNC blend al1 of each round: 1, 0.5, 0 (quadratic first), each
    ``liters`` times."""
    for step in range(gnc_steps):
        for _ in range(liters):
            yield 1.0 - 0.5 * step


def solve_level(
    g1, g2, u, v, uhat, vhat,
    alpha: float, lam_over_alpha: float, lambdac: float, tol: float,
    liters: int, cgiters: int, gnc_steps: int, dozim: bool,
    solver: str = "pcg", sor_omega: float = 1.9, plain: bool = False,
):
    """GNC x inner iterations at one pyramid level; returns (u, v).

    g1/g2: (C, H, W) level images; u/v: initial flow; uhat/vhat: first-guess
    hint fields at this level.  ``solver`` is "pcg" or "sor" (relaxation
    factor ``sor_omega``); ``plain`` calls the kernels' plain versions on
    any device (see the module docstring).
    """
    gx1, gy1 = gradient_4th(g1)
    gx2, gy2 = gradient_4th(g2)
    gxx, _ = gradient_4th(gx2)
    gxy, gyy = gradient_4th(gy2)   # Ixy = d/dx (d/dy geo2), ref :591-594
    stack = torch.cat([g2, gx2, gy2, gxx, gxy, gyy], dim=0).contiguous()
    warp_fn = _PLAIN_WARP if plain else warp
    alpha, lam_over_alpha, lambdac = _f32(alpha), _f32(lam_over_alpha), _f32(lambdac)

    if solver == "sor":
        # octane_tpu's fused chain (variational.py:125-178): the level stack
        # [geo1, gx1, gy1] is loop-invariant
        g1s = torch.cat([g1, gx1, gy1], dim=0).contiguous()
        asm_fn = _PLAIN_ASSEMBLE if plain else assemble_cf
        pass_fn = _PLAIN_PASS if plain else sor_pass

        def round_(u, v, al1):
            samples, bc_x, bc_y = warp_fn(stack, u, v)
            cf, partials = asm_fn(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                                  al1, lambdac, alpha, lam_over_alpha, dozim)
            return sor_solve_cf(cf, torch.sum(partials), tol, cgiters,
                                sor_omega, pass_fn)
    else:
        passes = _PLAIN_PASSES if plain else (pcg_pass_a, pcg_pass_b)

        def round_(u, v, al1):
            sysm = assemble(g1, g2, gx1, gy1, gx2, gy2, gxx, gxy, gyy,
                            u, v, uhat, vhat, al1, alpha, lam_over_alpha,
                            lambdac, dozim, warp_fn=warp_fn, stack=stack)
            return pcg_solve_fused(sysm, tol, cgiters, *passes)

    for al1 in gnc_rounds(gnc_steps, liters):
        du, dv = round_(u, v, al1)
        u, v = u + du, v + dv
    return u, v


def _coarse_to_fine(geo1, geo2, u0, v0, cfg: OFConfig, plain: bool = False):
    h, w = u0.shape
    c = geo1.shape[0]
    kiters = cfg.kiters
    # the four full-resolution inputs are resampled together (each plane
    # independently, so the values are those of separate calls)
    full = torch.cat([geo1, geo2, u0[None], v0[None]])
    u = v = None
    for k, factor, (nyy, nxx), lambdac_k in level_schedule(cfg, h, w):
        if k == kiters - 1:
            g1, g2 = geo1, geo2
            uhat, vhat = u0, v0
        else:
            lvl = pyramid_downsample(full, factor)
            g1, g2 = lvl[:c], lvl[c:2 * c]
            hint = lvl[2 * c:] * _f32(factor)
            uhat, vhat = hint[0], hint[1]
        if k == 0:
            u, v = uhat, vhat
        else:
            uv = zoom_in_flow(torch.stack([u, v]), (nyy, nxx), cfg.scale_factor)
            u, v = uv[0], uv[1]
        u, v = solve_level(
            g1, g2, u, v, uhat, vhat,
            cfg.alpha, cfg.lambda_over_alpha, lambdac_k, cfg.cg_tol,
            cfg.liters, cfg.cgiters, cfg.gnc_steps, cfg.dozim,
            solver=cfg.solver, sor_omega=cfg.sor_omega, plain=plain)
    return u, v


def variational_flow(
    geo1: torch.Tensor,
    geo2: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    cfg: OFConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full coarse-to-fine solve on the device of the inputs.

    geo1/geo2: (C, H, W) or (H, W) float32 images normalised to [0, 255];
    u0/v0: (H, W) first-guess pixel displacements (zeros if none).
    Returns (u, v) dense pixel displacements at full resolution.
    """
    geo1 = geo1.to(torch.float32)
    geo2 = geo2.to(torch.float32)
    if geo1.dim() == 2:
        geo1, geo2 = geo1[None], geo2[None]
    return _coarse_to_fine(geo1.contiguous(), geo2.contiguous(),
                           u0.to(torch.float32).contiguous(),
                           v0.to(torch.float32).contiguous(), cfg)
