"""Row-banded variational flow (counterpart of octane_tpu.parallel.sharded).

``sharded_variational_flow(geo1, geo2, u0, v0, cfg, mesh)`` runs the
single-device schedule (flow.variational: levels, GNC x liters rounds of
warp -> assemble -> solve) on the mesh's row bands.  Per level, each band
builds once, on a slab of its rows and a halo, the level-invariant parts:
the level images and hints (``core.zoom.pyramid_downsample_rows`` of the
full-resolution rows they read), their gradients (``gradient_4th`` twice:
4 rows more), the 6C-plane sample stack on the warp's slab and the 3C-plane
[geo1, gx1, gy1] on the assembly's rows.  Inside the rounds only u and v
change: each band holds them on its rows and one ghost row beside each
cut, the assembly's stencil, and exchanges those once per round.  A round
on a band is the band form of the warp (``ops.warp.warp_band``), the
assembly on the band's rows plus the stencil's (the SOR path's
``ops.assemble.assemble_cf`` kernel, or the eager ``flow.stencil``
assembly of the PCG path) cropped to the band, and the banded solve
(``parallel.sor.solve_bands`` / ``parallel.cg.solve_bands``).  Between
levels each band zooms in the coarse rows its Catmull-Rom taps read
(``core.zoom.zoom_in_flow_rows``).  Every elementwise step, the warp, the
assembly, the SOR pass and PCG pass A equal the single-device rows bit for
bit, and on bands aligned to the reduction blocks (parallel.mesh.band_rows)
the solvers' sums are one device's; only the zoom's matrix products may
sum in another order, so the flow equals the single-device flow or agrees
with it to float round-off.

**Warp reach guard** (JAX's ``lax.cond`` to the dense gather,
sharded.py:201-210 of octane_tpu): before each warp one host read brings
every band's max |v| (whole rows, so only v matters).  Within ``halo_warp -
2`` the level's slab holds every sample row; beyond it the band's slab is
rebuilt wide enough for the rest of the level, so a sample is never
clamped (the reference has no reach bound).  ``guard_reads`` counts the
reads: one per round, 36 per default pair.

Left behind from the TPU layout: the 2-D (dy, dx) block grid (a (ry, rx)
mesh runs as ry * rx row bands, the same function: the kernels work on
whole rows, JAX's solvers flatten the mesh to bands too, and processes
split by rows); mesh-divisibility padding (``padded_global_shape``:
shard_map needs equal shards, bands may be uneven, so there are no padded
pixels); the halo-frame position shift with its edge-band patches (the
band warp samples in global coordinates and is bit-exact); the 8-row
ghost strips of the TPU's tiling.

``plain=True`` (internal, as flow.variational's) calls the band forms'
plain versions, each call counted as a plain call.  The inputs and the
result are whole tensors; the result is on the mesh's first device.
"""

from __future__ import annotations

import math
import types
from typing import Tuple

import torch

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.gradients import gradient_4th
from octane_tpu_torch.core.zoom import (flow_rows, pyramid_downsample_rows, pyramid_rows,
                                        zoom_in_flow_rows)
from octane_tpu_torch.flow.stencil import assemble_samples
from octane_tpu_torch.flow.variational import _counted_plain, _f32, gnc_rounds, level_schedule
from octane_tpu_torch.ops.assemble import assemble_cf, assemble_cf_plain
from octane_tpu_torch.ops.pcg import (pcg_pass_a_band, pcg_pass_a_band_plain, pcg_pass_b,
                                      pcg_pass_b_plain)
from octane_tpu_torch.ops.sor import sor_pass_band, sor_pass_band_plain
from octane_tpu_torch.ops.warp import warp_band, warp_band_plain
from octane_tpu_torch.parallel import cg as band_cg
from octane_tpu_torch.parallel import sor as band_sor
from octane_tpu_torch.parallel.halo import LocalExchange
from octane_tpu_torch.parallel.mesh import mesh_bands

_PLAIN_WARP = _counted_plain(warp_band, warp_band_plain)
_PLAIN_ASSEMBLE = _counted_plain(assemble_cf, assemble_cf_plain)
_PLAIN_PASS = _counted_plain(sor_pass_band, sor_pass_band_plain)
_PLAIN_PASSES = (_counted_plain(pcg_pass_a_band, pcg_pass_a_band_plain),
                 _counted_plain(pcg_pass_b, pcg_pass_b_plain))


guard_reads = types.SimpleNamespace(reads=0)     # host reads of the warp reach guard


def reach_halos(vmax, halos, floor: int):
    """Each band's warp halo after a guard read: kept while max |v| <= halo -
    2, else widened to ceil(max |v|) + 2 rounded up to 8 rows (the whole
    level where max |v| is not finite)."""
    out = []
    for m, halo in zip(vmax, halos):
        if m <= halo - 2:
            out.append(halo)
        elif math.isfinite(m):
            out.append(max(floor, -(-(math.ceil(m) + 2) // 8) * 8))
        else:
            out.append(1 << 30)
    return out


def _read_vmax(vs, device):
    """One host read of each band's max |v|."""
    guard_reads.reads += 1
    return torch.stack([v.abs().amax().to(device) for v in vs]).tolist()


def make_sharded_warp(mesh, global_hw: Tuple[int, int], halo: int, true_hw=None,
                      exchange=None):
    """A warp sampler with warp_bilinear_dense's signature over whole
    tensors: each band of the mesh samples its rows from a slab of its rows
    +- ``halo`` (widened by the reach guard), with the band form of the warp
    kernel; the result is on the first band's device.  ``true_hw`` must equal
    ``global_hw``: the bands need no padding."""
    if true_hw is not None and tuple(true_hw) != tuple(global_hw):
        raise ValueError("make_sharded_warp: the bands are not padded, true_hw must equal "
                         "global_hw")
    exchange = exchange or LocalExchange()
    h = global_hw[0]

    def warp(fields, u, v):
        bands = mesh_bands(mesh, h)
        parts = [(0, fields)]
        vs = [v[r0:r1].to(dev) for dev, r0, r1 in bands]
        halos = reach_halos(_read_vmax(vs, bands[0][0]), [halo] * len(bands), halo)
        out = []
        for (dev, r0, r1), hb, vb in zip(bands, halos, vs):
            s0, s1 = max(0, r0 - hb), min(h, r1 + hb)
            slab = exchange.rows(parts, s0, s1, dev)
            out.append((r0, warp_band(slab, u[r0:r1].to(dev), vb, s0, r0, h)))
        dev0 = bands[0][0]
        return tuple(exchange.rows([(r0, o[j]) for r0, o in out], 0, h, dev0)
                     for j in range(3))

    return warp


class _Band:
    """One band's level state: rows [r0, r1), the assembly's rows [a0, a1)
    (the band and the stencil's ghost rows), the warp slab of rows
    [s0, s0 + hs) with its halo, and u, v on the assembly's rows."""

    def __init__(self, dev, r0, r1, h):
        self.dev, self.r0, self.r1 = dev, r0, r1
        self.a0, self.a1 = max(0, r0 - 1), min(h, r1 + 1)
        self.halo = None
        self.uv = None

    def interior(self, t):
        return t[..., self.r0 - self.a0:self.r1 - self.a0, :]

    def build(self, exchange, full, c: int, factor: float, hw, halo: int, top: bool):
        """The level-invariant slabs at warp halo ``halo``: the stack on
        rows [s0, s1), [geo1, gx1, gy1] and the hints on the assembly's rows."""
        h = hw[0]
        hfull = full[0][1].shape[-2]
        self.halo = halo
        self.s0, s1 = max(0, self.a0 - halo), min(h, self.a1 + halo)
        e0, e1 = max(0, self.s0 - 4), min(h, s1 + 4)   # gradient_4th twice: +-4 rows
        if top:
            lvl = exchange.rows(full, e0, e1, self.dev)
            hint = lvl[2 * c:]
        else:
            f0, f1 = pyramid_rows(hfull, factor, (e0, e1))
            lvl = pyramid_downsample_rows(exchange.rows(full, f0, f1, self.dev), f0, hfull,
                                          factor, (e0, e1))
            hint = lvl[2 * c:] * _f32(factor)
        g1, g2 = lvl[:c], lvl[c:2 * c]
        gx1, gy1 = gradient_4th(g1)
        gx2, gy2 = gradient_4th(g2)
        gxx, _ = gradient_4th(gx2)
        gxy, gyy = gradient_4th(gy2)
        self.stack = torch.cat([g2, gx2, gy2, gxx, gxy, gyy])[:, self.s0 - e0:s1 - e0].contiguous()
        a = slice(self.a0 - e0, self.a1 - e0)
        self.g1s = torch.cat([g1, gx1, gy1])[:, a].contiguous()
        self.uhat, self.vhat = hint[0, a].contiguous(), hint[1, a].contiguous()


def _coarse_to_fine_banded(geo1, geo2, u0, v0, cfg: OFConfig, mesh, exchange,
                           plain: bool = False):
    h, w = u0.shape
    c = geo1.shape[0]
    # the full-resolution inputs as one field of 2C + 2 planes; each band
    # reads its rows of it through the exchange
    full = [(0, torch.cat([geo1, geo2, u0[None], v0[None]]))]
    warp_fn = _PLAIN_WARP if plain else warp_band
    alpha, lam_a = _f32(cfg.alpha), _f32(cfg.lambda_over_alpha)
    bands = prev = None
    for k, factor, hw, lambdac_k in level_schedule(cfg, h, w):
        lambdac_k = _f32(lambdac_k)
        top = k == cfg.kiters - 1
        prev_bands, bands = bands, [_Band(dev, r0, r1, hw[0])
                                    for dev, r0, r1 in mesh_bands(mesh, hw[0])]
        for b in bands:
            b.build(exchange, full, c, factor, hw, cfg.halo_warp, top)
            if prev_bands is None:
                b.uv = torch.stack([b.uhat, b.vhat])
            else:
                hc = prev[-1][0] + prev[-1][1].shape[-2]
                c0, c1 = flow_rows(hc, hw[0], (b.a0, b.a1))
                coarse = exchange.rows(prev, c0, c1, b.dev)
                b.uv = zoom_in_flow_rows(coarse, c0, hc, hw, (b.a0, b.a1),
                                         cfg.scale_factor).contiguous()

        for al1 in gnc_rounds(cfg.gnc_steps, cfg.liters):
            halos = reach_halos(_read_vmax([b.uv[1] for b in bands], bands[0].dev),
                                [b.halo for b in bands], cfg.halo_warp)
            warped = []
            for b, halo in zip(bands, halos):
                if halo != b.halo:
                    b.build(exchange, full, c, factor, hw, halo, top)
                warped.append(warp_fn(b.stack, b.uv[0], b.uv[1], b.s0, b.a0, hw[0]))
            if cfg.solver == "sor":
                du = _sor_round(bands, warped, hw[0], al1, lambdac_k, alpha, lam_a, cfg,
                                exchange, plain)
            else:
                du = _pcg_round(bands, warped, hw[0], al1, lambdac_k, alpha, lam_a, cfg,
                                exchange, plain)
            for b, d in zip(bands, du):
                b.interior(b.uv).add_(d.to(b.dev))
            prev = [(b.r0, b.interior(b.uv)) for b in bands]
            for b in bands:          # the stencil's ghost rows of u and v
                exchange.fetch(prev, b.a0, b.r0, b.uv[:, :b.r0 - b.a0])
                exchange.fetch(prev, b.r1, b.a1, b.uv[:, b.r1 - b.a0:])
    uv = exchange.rows(prev, 0, h, bands[0].dev)
    return uv[0], uv[1]


def _sor_round(bands, warped, h, al1, lambdac, alpha, lam_a, cfg, exchange, plain):
    asm_fn = _PLAIN_ASSEMBLE if plain else assemble_cf
    parts = []
    for b, (samples, bc_x, bc_y) in zip(bands, warped):
        cf, _ = asm_fn(samples, bc_x, bc_y, b.g1s, b.uv[0], b.uv[1], b.uhat, b.vhat,
                       al1, lambdac, alpha, lam_a, cfg.dozim)
        parts.append((b.r0, b.interior(cf)))
    resid0 = band_sor.resid0_of(parts, bands[0].dev)
    return band_sor.solve_bands(parts, h, resid0, cfg.cg_tol, cfg.cgiters, cfg.sor_omega,
                                exchange, _PLAIN_PASS if plain else sor_pass_band)


def _pcg_round(bands, warped, h, al1, lambdac, alpha, lam_a, cfg, exchange, plain):
    systems = []
    c = bands[0].g1s.shape[0] // 3
    for b, (samples, bc_x, bc_y) in zip(bands, warped):
        g1s = b.g1s
        sysm = assemble_samples(samples, bc_x, bc_y, g1s[:c], g1s[c:2 * c], g1s[2 * c:],
                                b.uv[0], b.uv[1], b.uhat, b.vhat, al1, alpha, lam_a,
                                lambdac, cfg.dozim)
        cf, rhs = band_cg.system_bands(sysm, slice(b.r0 - b.a0, b.r1 - b.a0))
        systems.append((b.r0, cf, rhs))
    passes = _PLAIN_PASSES if plain else (pcg_pass_a_band, pcg_pass_b)
    return band_cg.solve_bands(systems, h, cfg.cg_tol, cfg.cgiters, exchange, *passes)


def sharded_variational_flow(geo1, geo2, u0, v0, cfg: OFConfig, mesh, exchange=None):
    """Coarse-to-fine variational flow on the mesh's row bands; see the
    module docstring.  geo1/geo2: (C, H, W) or (H, W) float32 images; u0/v0:
    (H, W) first-guess displacements.  Returns (u, v) on the mesh's first
    device.  Every band stays on its device: there is no fallback to the
    CPU or to one device."""
    geo1 = geo1.to(torch.float32)
    geo2 = geo2.to(torch.float32)
    if geo1.dim() == 2:
        geo1, geo2 = geo1[None], geo2[None]
    u0 = u0.to(torch.float32)
    v0 = v0.to(torch.float32)
    return _coarse_to_fine_banded(geo1.contiguous(), geo2.contiguous(), u0.contiguous(),
                                  v0.contiguous(), cfg, mesh, exchange or LocalExchange())
