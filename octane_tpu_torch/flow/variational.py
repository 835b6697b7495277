"""Coarse-to-fine variational optical flow (modified Zimmer / Brox);
counterpart of octane_tpu.flow.variational.

The pyramid is a Python loop over levels; at each level ``solve_level``
runs GNC x liters rounds of warp -> assemble -> solve.  With
``solver="pcg"`` (the default) a round is the warp, the fused assembly in
the PCG layout (``ops.assemble.assemble_pcg``: the system and its first
sums) and the Jacobi-PCG passes (``ops.pcg.pcg_solve_cf``); with
``solver="sor"`` it is the warp, the fused assembly in the SOR layout
(``ops.assemble.assemble_cf``) and the multi-sweep red-black SOR
(ops.sor), as octane_tpu's fused chain on one device.  Every kernel goes
through its wrapper in ``ops`` at every level: the CUDA kernel on the card,
the plain version on the CPU.  The internal ``plain`` argument of
``solve_level``/``_coarse_to_fine`` calls the plain versions on any device
instead (each call counted as a plain call), so the kernels can be timed
and checked against them on the card; no option of ``OFConfig`` or the CLI
reaches it.

``flow_program(cfg, shape, nchan, device)`` is the counterpart of the JAX
package's one jitted program per (shape, channels, config), a
flow.program.CapturedPair: on a card a key's second pair captures the
whole solve into one CUDA graph, the relaxers' stopping tests in IF nodes
(ops.guard), and later pairs replay it, reading nothing on the host; on
the CPU it runs eagerly.  ``variational_flow`` goes through it.  While the
tracer (utils.profiling) is on, a solve stamps its levels and relaxer
rounds and keeps each round's count; a program made then captures those.

The mesh path (octane_tpu_torch.parallel.sharded) runs the same schedule
(``level_schedule``, ``gnc_rounds``) and level stacks (``level_stacks``)
on row bands, through programs of its own.

Numerics follow the reference (SURVEY.md section 8): per-level images are
blurred and floor-subsampled from full resolution, first-guess fields are
downsampled the same way and scaled by the level factor, flow upsampling is
half-pixel bicubic divided by the scale factor, and the hinting weight
decays as lambdac * 0.5^k (oct_variational_optical_flow.cu:487-575).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.gradients import gradient_4th
from octane_tpu_torch.core.zoom import zoom_in_flow, zoom_size
from octane_tpu_torch.flow.program import (CapturedPair, cached, clear_program_cache,  # noqa
                                           device_of, record_solve, solve_fields, solve_marks)
from octane_tpu_torch.ops import counted_plain
from octane_tpu_torch.ops.assemble import (assemble_cf, assemble_cf_plain, assemble_pcg,
                                           assemble_pcg_plain)
from octane_tpu_torch.ops.pcg import (pcg_pass_a, pcg_pass_a_plain, pcg_pass_b,
                                      pcg_pass_b_plain, pcg_solve_cf)
from octane_tpu_torch.ops.pyramid import pyramid_level, pyramid_level_plain
from octane_tpu_torch.ops.sor import sor_pass, sor_pass_plain, sor_solve_cf
from octane_tpu_torch.ops.warp import warp, warp_bilinear_dense
from octane_tpu_torch.utils import profiling


def f32(x: float) -> float:
    """A Python float rounded to float32, as the JAX solver's scalars are."""
    return float(np.float32(x))


_PLAIN_WARP = counted_plain(warp, warp_bilinear_dense)
_PLAIN_PASSES = (counted_plain(pcg_pass_a, pcg_pass_a_plain),
                 counted_plain(pcg_pass_b, pcg_pass_b_plain))
_PLAIN_ASSEMBLE = counted_plain(assemble_cf, assemble_cf_plain)
_PLAIN_ASSEMBLE_PCG = counted_plain(assemble_pcg, assemble_pcg_plain)
_PLAIN_PASS = counted_plain(sor_pass, sor_pass_plain)
_PLAIN_PYRAMID = counted_plain(pyramid_level, pyramid_level_plain)


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


def level_stacks(g1, g2):
    """The loop-invariant stacks of a level's (C, rows, W) images: the
    6C-plane sample stack [geo2, gx2, gy2, gxx, gxy, gyy] that the warp
    reads and the 3C-plane [geo1, gx1, gy1] that the assembly reads."""
    gx1, gy1 = gradient_4th(g1)
    gx2, gy2 = gradient_4th(g2)
    gxx, _ = gradient_4th(gx2)
    gxy, gyy = gradient_4th(gy2)   # Ixy = d/dx (d/dy geo2), ref :591-594
    return (torch.cat([g2, gx2, gy2, gxx, gxy, gyy], dim=0).contiguous(),
            torch.cat([g1, gx1, gy1], dim=0).contiguous())


def solve_level(
    g1, g2, u, v, uhat, vhat,
    alpha: float, lam_over_alpha: float, lambdac: float, tol: float,
    liters: int, cgiters: int, gnc_steps: int, dozim: bool,
    solver: str = "pcg", sor_omega: float = 1.9, plain: bool = False, count=None,
    marks=None,
):
    """GNC x inner iterations at one pyramid level; returns (u, v).

    g1/g2: (C, H, W) level images; u/v: initial flow; uhat/vhat: first-guess
    hint fields at this level.  ``solver`` is "pcg" or "sor" (relaxation
    factor ``sor_omega``); ``plain`` calls the kernels' plain versions on
    any device (see the module docstring).  ``count``, an int32 device
    scalar, gains the relaxer's iterations (PCG) or passes (SOR).  With
    ``marks`` (utils.profiling.Marks) each round's relaxer lies between
    two stamps and its count goes to its slot of ``marks.rounds``.
    """
    stack, g1s = level_stacks(g1, g2)
    warp_fn = _PLAIN_WARP if plain else warp
    alpha, lam_over_alpha, lambdac = f32(alpha), f32(lam_over_alpha), f32(lambdac)
    if solver == "sor":
        # octane_tpu's fused chain (variational.py:125-178)
        asm_fn = _PLAIN_ASSEMBLE if plain else assemble_cf
        pass_fn = _PLAIN_PASS if plain else sor_pass

        def round_(u, v, al1, j):
            samples, bc_x, bc_y = warp_fn(stack, u, v)
            cf, partials = asm_fn(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                                  al1, lambdac, alpha, lam_over_alpha, dozim)
            with _relaxer(marks, j) as ran:
                return sor_solve_cf(cf, torch.sum(partials), tol, cgiters,
                                    sor_omega, pass_fn, count, ran)
    else:
        asm_fn = _PLAIN_ASSEMBLE_PCG if plain else assemble_pcg
        passes = _PLAIN_PASSES if plain else (pcg_pass_a, pcg_pass_b)

        def round_(u, v, al1, j):
            samples, bc_x, bc_y = warp_fn(stack, u, v)
            cf, b, partials = asm_fn(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                                     al1, lambdac, alpha, lam_over_alpha, dozim)
            with _relaxer(marks, j) as ran:
                return pcg_solve_cf(cf, b, partials, tol, cgiters, *passes, count, ran)

    for j, al1 in enumerate(gnc_rounds(gnc_steps, liters)):
        du, dv = round_(u, v, al1, j)
        u, v = u + du, v + dv
    return u, v


def _relaxer(marks, j: int):
    """Round ``j``'s relaxer: between its stamps, yielding its count's slot,
    where the solve is traced; else nothing."""
    return contextlib.nullcontext() if marks is None else marks.relax(j)


def _pair(geo1, geo2, u0, v0, cfg: OFConfig, plain: bool = False, marks=None):
    """(u, v, the relaxer's iterations or passes as an int32 device scalar).
    With ``marks`` (utils.profiling.Marks) the solve is traced: it stamps
    its start and end, each level's start and each round's relaxer, and
    sets each round's count."""
    if marks is not None:
        marks.solve()
    h, w = u0.shape
    c = geo1.shape[0]
    kiters = cfg.kiters
    count = torch.zeros((), dtype=torch.int32, device=u0.device)
    # the four full-resolution inputs are resampled together, a level in
    # one call (each plane independently, so the values are those of
    # separate calls)
    full = torch.cat([geo1, geo2, u0[None], v0[None]])
    level_fn = _PLAIN_PYRAMID if plain else pyramid_level
    u = v = None
    for k, factor, (nyy, nxx), lambdac_k in level_schedule(cfg, h, w):
        if marks is not None:
            marks.start_level(k)
        if k == kiters - 1:
            g1, g2 = geo1, geo2
            uhat, vhat = u0, v0
        else:
            lvl = level_fn(full, 0, h, factor, (0, nyy))
            g1, g2 = lvl[:c], lvl[c:2 * c]
            hint = lvl[2 * c:] * f32(factor)
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
            solver=cfg.solver, sor_omega=cfg.sor_omega, plain=plain, count=count,
            marks=marks)
    if marks is not None:
        marks.solved()
    return u, v, count


def _coarse_to_fine(geo1, geo2, u0, v0, cfg: OFConfig, plain: bool = False):
    """The eager solve: (u, v); traced while the tracer is on."""
    marks = solve_marks(cfg, u0.device) if profiling.enabled() else None
    u, v, count = _pair(geo1, geo2, u0, v0, cfg, plain, marks)
    record_solve(cfg.solver, count, marks)
    return u, v


class FlowProgram(CapturedPair):
    """The coarse-to-fine solve of one (shape, channels, config, device)
    (see CapturedPair); on the CPU it runs the solve eagerly."""

    def __init__(self, cfg: OFConfig, shape, nchan: int, device):
        device = device_of(device)
        super().__init__(cfg, shape, nchan, device, device.type == "cuda")

    def _new_marks(self):
        return solve_marks(self.cfg, self.device)

    def _pair(self, geo1, geo2, u0, v0, marks=None):
        return _pair(geo1, geo2, u0, v0, self.cfg, marks=marks)


def program_key(cfg: OFConfig, shape, nchan: int, device) -> tuple:
    """The fields a program is keyed on: those of octane_tpu's
    flow_program (variational.py:262-263) but its TPU option, the device,
    and whether the tracer is on (a traced program captures its stamps)."""
    return (tuple(shape), nchan, *solve_fields(cfg), device_of(device), profiling.enabled())


def flow_program(cfg: OFConfig, shape, nchan: int, device) -> FlowProgram:
    """The cached program of the entire coarse-to-fine solve for a
    (shape, channels, config, device); see FlowProgram."""
    return cached(program_key(cfg, shape, nchan, device),
                  lambda: FlowProgram(cfg, shape, nchan, device))


def variational_flow(
    geo1: torch.Tensor,
    geo2: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    cfg: OFConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full coarse-to-fine solve on the device of the inputs, through its
    program (``flow_program``).

    geo1/geo2: (C, H, W) or (H, W) float32 images normalised to [0, 255];
    u0/v0: (H, W) first-guess pixel displacements (zeros if none).
    Returns (u, v) dense pixel displacements at full resolution.
    """
    geo1 = geo1.to(torch.float32)
    geo2 = geo2.to(torch.float32)
    if geo1.dim() == 2:
        geo1, geo2 = geo1[None], geo2[None]
    program = flow_program(cfg, u0.shape, geo1.shape[0], geo1.device)
    return program(geo1.contiguous(), geo2.contiguous(),
                   u0.to(torch.float32).contiguous(), v0.to(torch.float32).contiguous())
