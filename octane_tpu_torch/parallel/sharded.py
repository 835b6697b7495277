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

The loop itself is ``banded_flow``, over a banded field's parts: with a
``halo.LocalExchange`` every band is the process's own, and with a
``halo.ProcessExchange`` (the multi-process path,
``parallel.distributed``) the process holds tensors for its own bands
only, but knows every band's rows and halos, so each exchange step
(``fetch_bands``) and each join of the solvers' sums is one collective
that every process enters with the same requests.

``plain=True`` (internal, as flow.variational's) calls the band forms'
plain versions, each call counted as a plain call.  The inputs and the
result of ``sharded_variational_flow`` are whole tensors; the result is on
the mesh's first device.
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
from octane_tpu_torch.parallel.halo import LocalExchange, field_rows, stub
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


def _read_vmax(vs, exchange):
    """One host read of every band's max |v| (``vs``: one (rows, W) plane per
    band, None for another process's band), the same on every process."""
    guard_reads.reads += 1
    return exchange.band_values([None if v is None else v.abs().amax() for v in vs])


def make_sharded_warp(mesh, global_hw: Tuple[int, int], halo: int, true_hw=None):
    """A warp sampler with warp_bilinear_dense's signature over whole
    tensors: each band of the mesh samples its rows from a slab of its rows
    +- ``halo`` (widened by the reach guard), with the band form of the warp
    kernel; the result is on the first band's device.  ``true_hw`` must equal
    ``global_hw``: the bands need no padding."""
    if true_hw is not None and tuple(true_hw) != tuple(global_hw):
        raise ValueError("make_sharded_warp: the bands are not padded, true_hw must equal "
                         "global_hw")
    exchange = LocalExchange()
    h = global_hw[0]

    def warp(fields, u, v):
        bands = mesh_bands(mesh, h)
        parts = [(0, fields)]
        vs = [v[r0:r1].to(dev) for dev, r0, r1 in bands]
        halos = reach_halos(_read_vmax(vs, exchange), [halo] * len(bands), halo)
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
    [s0, s0 + hs) with its halo, and u, v on the assembly's rows.  A band of
    another process (``local`` False) keeps only its rows and halo: every
    process knows every band's requests."""

    def __init__(self, i, dev, r0, r1, h):
        self.i, self.dev, self.r0, self.r1 = i, dev, r0, r1
        self.local = dev.type != "meta"
        self.a0, self.a1 = max(0, r0 - 1), min(h, r1 + 1)
        self.halo = None
        self.uv = None

    def interior(self, t):
        return t[..., self.r0 - self.a0:self.r1 - self.a0, :]

    def plan(self, halo: int, factor: float, hw, hfull: int, top: bool):
        """Set the slab rows at warp halo ``halo``; returns the full-resolution
        rows [f0, f1) the band's level slab reads."""
        h = hw[0]
        self.halo = halo
        self.s0, self.s1 = max(0, self.a0 - halo), min(h, self.a1 + halo)
        # gradient_4th twice: +-4 rows
        self.e0, self.e1 = max(0, self.s0 - 4), min(h, self.s1 + 4)
        if top:
            return self.e0, self.e1
        return pyramid_rows(hfull, factor, (self.e0, self.e1))

    def build(self, rows, f0: int, c: int, factor: float, hfull: int, top: bool):
        """The level-invariant slabs from the full-resolution ``rows`` [f0, f1):
        the stack on rows [s0, s1), [geo1, gx1, gy1] and the hints on the
        assembly's rows."""
        if top:
            lvl = rows
            hint = lvl[2 * c:]
        else:
            lvl = pyramid_downsample_rows(rows, f0, hfull, factor, (self.e0, self.e1))
            hint = lvl[2 * c:] * _f32(factor)
        e0 = self.e0
        g1, g2 = lvl[:c], lvl[c:2 * c]
        gx1, gy1 = gradient_4th(g1)
        gx2, gy2 = gradient_4th(g2)
        gxx, _ = gradient_4th(gx2)
        gxy, gyy = gradient_4th(gy2)
        self.stack = torch.cat([g2, gx2, gy2, gxx, gxy, gyy])[:, self.s0 - e0:self.s1 - e0]
        self.stack = self.stack.contiguous()
        a = slice(self.a0 - e0, self.a1 - e0)
        self.g1s = torch.cat([g1, gx1, gy1])[:, a].contiguous()
        self.uhat, self.vhat = hint[0, a].contiguous(), hint[1, a].contiguous()


def _build(bands, halos, exchange, full, wfull: int, c: int, factor: float, hw,
           top: bool) -> None:
    """Plan every band of ``bands`` at its halo, fetch in one step the
    full-resolution rows each reads, and build the local bands' slabs."""
    hfull = field_rows(full)
    reqs, got = [], []
    for b, halo in zip(bands, halos):
        f0, f1 = b.plan(halo, factor, hw, hfull, top)
        rows = (torch.empty((2 * c + 2, f1 - f0, wfull), dtype=torch.float32, device=b.dev)
                if b.local else None)
        reqs.append((b.i, f0, f1, rows))
        got.append((b, f0, rows))
    exchange.fetch_bands(full, reqs)
    for b, f0, rows in got:
        if b.local:
            b.build(rows, f0, c, factor, hfull, top)


def banded_flow(full, hw, c: int, cfg: OFConfig, mesh, exchange, plain: bool = False):
    """The coarse-to-fine solve on the mesh's bands: the one loop of the
    whole-tensor ``sharded_variational_flow`` and of the multi-process
    ``parallel.distributed.distributed_variational_flow``.

    ``full`` is the (H, W) = ``hw`` full-resolution [geo1 (C planes),
    geo2 (C), u0, v0] field as parts [(r0, (2C + 2, rows, W)), ...]: any
    parts under a LocalExchange; one per band of ``mesh_bands(mesh, H)``,
    a ``halo.stub`` for each band of another process, under a
    ProcessExchange.  Returns the bands' [(r0, (2, rows, W) u, v)], stubs
    for other processes' bands.
    """
    h, w = hw
    warp_fn = _PLAIN_WARP if plain else warp_band
    alpha, lam_a = _f32(cfg.alpha), _f32(cfg.lambda_over_alpha)
    bands = prev = None
    for k, factor, hw, lambdac_k in level_schedule(cfg, h, w):
        lambdac_k = _f32(lambdac_k)
        top = k == cfg.kiters - 1
        first = bands is None
        bands = [_Band(i, dev, r0, r1, hw[0])
                 for i, (dev, r0, r1) in enumerate(mesh_bands(mesh, hw[0]))]
        _build(bands, [cfg.halo_warp] * len(bands), exchange, full, w, c, factor, hw, top)
        if first:
            for b in bands:
                if b.local:
                    b.uv = torch.stack([b.uhat, b.vhat])
        else:
            # each band zooms in the coarse rows its Catmull-Rom taps read
            hc, reqs = field_rows(prev), []
            for b in bands:
                c0, c1 = flow_rows(hc, hw[0], (b.a0, b.a1))
                coarse = (torch.empty((2, c1 - c0, wc), dtype=torch.float32, device=b.dev)
                          if b.local else None)
                reqs.append((b.i, c0, c1, coarse))
            exchange.fetch_bands(prev, reqs)
            for b, (_, c0, _, coarse) in zip(bands, reqs):
                if b.local:
                    b.uv = zoom_in_flow_rows(coarse, c0, hc, hw, (b.a0, b.a1),
                                             cfg.scale_factor).contiguous()

        for al1 in gnc_rounds(cfg.gnc_steps, cfg.liters):
            vmax = _read_vmax([b.uv[1] if b.local else None for b in bands], exchange)
            halos = reach_halos(vmax, [b.halo for b in bands], cfg.halo_warp)
            wide = [(b, hb) for b, hb in zip(bands, halos) if hb != b.halo]
            if wide:
                _build(*zip(*wide), exchange, full, w, c, factor, hw, top)
            warped = [warp_fn(b.stack, b.uv[0], b.uv[1], b.s0, b.a0, hw[0]) if b.local else None
                      for b in bands]
            round_fn = _sor_round if cfg.solver == "sor" else _pcg_round
            du = round_fn(bands, warped, hw[0], al1, lambdac_k, alpha, lam_a, cfg, exchange,
                          plain)
            for b, d in zip(bands, du):
                if b.local:
                    b.interior(b.uv).add_(d.to(b.dev))
            prev = [(b.r0, b.interior(b.uv) if b.local else stub(b.r1 - b.r0)) for b in bands]
            reqs = []                # the stencil's ghost rows of u and v
            for b in bands:
                reqs += [(b.i, b.a0, b.r0, b.uv[:, :b.r0 - b.a0] if b.local else None),
                         (b.i, b.r1, b.a1, b.uv[:, b.r1 - b.a0:] if b.local else None)]
            exchange.fetch_bands(prev, reqs)
        wc = hw[1]
    return prev


def _coarse_to_fine_banded(geo1, geo2, u0, v0, cfg: OFConfig, mesh, exchange,
                           plain: bool = False):
    """``banded_flow`` of whole tensors within one process: (u, v) on the
    mesh's first device."""
    # the full-resolution inputs as one field of 2C + 2 planes; each band
    # reads its rows of it through the exchange
    full = [(0, torch.cat([geo1, geo2, u0[None], v0[None]]))]
    prev = banded_flow(full, u0.shape, geo1.shape[0], cfg, mesh, exchange, plain)
    uv = exchange.rows(prev, 0, u0.shape[0], prev[0][1].device)
    return uv[0], uv[1]


def _sor_round(bands, warped, h, al1, lambdac, alpha, lam_a, cfg, exchange, plain):
    asm_fn = _PLAIN_ASSEMBLE if plain else assemble_cf
    parts = []
    for b, wp in zip(bands, warped):
        if not b.local:
            parts.append((b.r0, stub(b.r1 - b.r0)))
            continue
        samples, bc_x, bc_y = wp
        cf, _ = asm_fn(samples, bc_x, bc_y, b.g1s, b.uv[0], b.uv[1], b.uhat, b.vhat,
                       al1, lambdac, alpha, lam_a, cfg.dozim)
        parts.append((b.r0, b.interior(cf)))
    dev0 = band_sor.home(parts, exchange)
    resid0 = band_sor.resid0_of(parts, dev0, exchange)
    return band_sor.solve_bands(parts, h, resid0, cfg.cg_tol, cfg.cgiters, cfg.sor_omega,
                                exchange, _PLAIN_PASS if plain else sor_pass_band)


def _pcg_round(bands, warped, h, al1, lambdac, alpha, lam_a, cfg, exchange, plain):
    systems = []
    for b, wp in zip(bands, warped):
        if not b.local:
            systems.append((b.r0, stub(b.r1 - b.r0), None))
            continue
        samples, bc_x, bc_y = wp
        g1s = b.g1s
        c = g1s.shape[0] // 3
        sysm = assemble_samples(samples, bc_x, bc_y, g1s[:c], g1s[c:2 * c], g1s[2 * c:],
                                b.uv[0], b.uv[1], b.uhat, b.vhat, al1, alpha, lam_a,
                                lambdac, cfg.dozim)
        cf, rhs = band_cg.system_bands(sysm, slice(b.r0 - b.a0, b.r1 - b.a0))
        systems.append((b.r0, cf, rhs))
    passes = _PLAIN_PASSES if plain else (pcg_pass_a_band, pcg_pass_b)
    return band_cg.solve_bands(systems, h, cfg.cg_tol, cfg.cgiters, exchange, *passes)


def sharded_variational_flow(geo1, geo2, u0, v0, cfg: OFConfig, mesh):
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
                                  v0.contiguous(), cfg, mesh, LocalExchange())
