"""Row-banded variational flow (counterpart of octane_tpu.parallel.sharded).

``sharded_variational_flow(geo1, geo2, u0, v0, cfg, mesh)`` runs the
single-device schedule (flow.variational: levels, GNC x liters rounds of
warp -> assemble -> solve) on the mesh's row bands, through the mesh's
program (``sharded_flow_program``).  Per level, each band
builds once, on a slab of its rows and a halo, the level-invariant parts:
the level images and hints (``core.zoom.pyramid_downsample_rows`` of the
full-resolution rows they read) and their stacks
(``flow.variational.level_stacks``, whose gradients read 4 rows more): the
6C-plane sample stack on the warp's slab and the 3C-plane [geo1, gx1, gy1]
on the assembly's rows.  Inside the rounds only u and v
change: each band holds them on its rows and one ghost row beside each
cut, the assembly's stencil, and exchanges those once per round.  A round
on a band is the band form of the warp (``ops.warp.warp_band``), the
assembly on the band's rows plus the stencil's (the SOR path's
``ops.assemble.assemble_cf`` kernel, cropped to the band; the PCG path's
``ops.assemble.assemble_pcg`` kernel, which writes the band's rows and
their first sums only), and the banded solve
(``parallel.sor.solve_bands`` / ``parallel.cg.solve_bands``).  Between
levels each band zooms in the coarse rows its Catmull-Rom taps read
(``core.zoom.zoom_in_flow_rows``).  Every elementwise step, the warp, the
assembly, the SOR pass and PCG pass A equal the single-device rows bit for
bit, and on bands aligned to the reduction blocks (parallel.mesh.band_rows)
the solvers' sums are one device's; only the zoom's matrix products may
sum in another order, so the flow equals the single-device flow or agrees
with it to float round-off.

**Warp reach test** (JAX's ``lax.cond`` to the dense gather,
sharded.py:203-211 of octane_tpu): every round each band warps from its
level slab of ``halo_warp`` rows beside the assembly's rows.  The slab
holds every sample row while max |v| <= halo_warp - 2 on every band (whole
rows, so only v matters); the test of that, the max over the bands (NaN
read as +inf), runs on every device of the process's bands (and is one
MAX all-reduce over processes), and where it fails a body guarded by it
(``ops.guard.decide``: a graph IF node on each card when the program
captures the pair, else one host read) warps every band again, into the
same buffers, from the whole level's sample stack, which each device
fetched from the bands' slabs once per level, ahead of the rounds, at the
top level (where the bands lie on one card of one process, or a staged
exchange, gloo on a card, which stays eager, moves them, the body fetches
it itself instead).  A sample is never clamped by the slab (the
reference has no reach bound), and the band warp samples in global
coordinates, so the flow is the same bit for bit whichever slab served a
round.  ``guard_reads`` counts the host reads: one per round, 36 per
default pair, none in a replay.

``sharded_flow_program(cfg, shape, nchan, mesh)`` is the counterpart of
JAX's one program per (mesh, shape, channels, config), captured and cached
by flow.program, in one of two forms.  ``MeshFlowProgram`` takes whole
tensors in one process; where its bands lie on one card or one a card, a
key's second call captures the whole banded solve into one CUDA graph
(begun on the first band's card, every other card's streams joining it)
and later calls replay it: the solvers' stopping tests and the reach test
are IF nodes on every card, with every cross-card copy between them, so a
replay reads nothing on the host.  ``ProcessFlowProgram`` takes one
process's row block over a ``halo.ProcessExchange`` (parallel.distributed):
under NCCL it captures its part, collectives included; over gloo it stays
eager.  Bands on the CPU run the eager loop (``last_program_info["route"]``
says which and why).

Left behind from the TPU layout: the 2-D (dy, dx) block grid (a (ry, rx)
mesh runs as ry * rx row bands, the same function: the kernels work on
whole rows, JAX's solvers flatten the mesh to bands too, and processes
split by rows); mesh-divisibility padding (``padded_global_shape``:
shard_map needs equal shards, bands may be uneven, so there are no padded
pixels and a ``true_shape`` other than the shape raises); the halo-frame
position shift with its edge-band patches (the band warp samples in global
coordinates and is bit-exact); the 8-row ghost strips of the TPU's tiling.

The loop itself is ``banded_flow``, over a banded field's parts: with a
``halo.LocalExchange`` every band is the process's own, and with a
``halo.ProcessExchange`` (the multi-process path,
``parallel.distributed``) the process holds tensors for its own bands
only, but knows every band's rows and halos, so each exchange step
(``fetch_bands``), each join of the solvers' sums and the reach test's
maximum is one collective that every process enters with the same
requests, whatever its stopping tests decide.

``plain=True`` (internal, as flow.variational's) calls the band forms'
plain versions, each call counted as a plain call.  The inputs and the
result of ``sharded_variational_flow`` are whole tensors; the result is on
the mesh's first device.
"""

from __future__ import annotations

import contextlib
import types
from typing import Tuple

import torch

from octane_tpu_torch import ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.zoom import (flow_rows, pyramid_downsample_rows, pyramid_rows,
                                        zoom_in_flow_rows)
from octane_tpu_torch.flow.program import (CapturedPair, cached, device_of, solve_fields,
                                           solve_marks)
from octane_tpu_torch.flow.variational import f32, gnc_rounds, level_schedule, level_stacks
from octane_tpu_torch.ops import counted_plain
from octane_tpu_torch.ops.assemble import (assemble_cf, assemble_cf_plain, assemble_pcg,
                                           assemble_pcg_plain)
from octane_tpu_torch.ops.guard import decide, when
from octane_tpu_torch.ops.pcg import (pcg_pass_a_band, pcg_pass_a_band_plain, pcg_pass_b,
                                      pcg_pass_b_plain)
from octane_tpu_torch.ops.sor import sor_pass_band, sor_pass_band_plain
from octane_tpu_torch.ops.warp import warp_band, warp_band_plain
from octane_tpu_torch.parallel import cg as band_cg
from octane_tpu_torch.parallel import sor as band_sor
from octane_tpu_torch.parallel.distributed import host_row_block, local_parts, local_rows
from octane_tpu_torch.parallel.halo import LocalExchange, field_rows, stub
from octane_tpu_torch.parallel.mesh import mesh_bands
from octane_tpu_torch.utils import profiling

_PLAIN_WARP = counted_plain(warp_band, warp_band_plain)
_PLAIN_ASSEMBLE = counted_plain(assemble_cf, assemble_cf_plain)
_PLAIN_ASSEMBLE_PCG = counted_plain(assemble_pcg, assemble_pcg_plain)
_PLAIN_PASS = counted_plain(sor_pass_band, sor_pass_band_plain)
_PLAIN_PASSES = (counted_plain(pcg_pass_a_band, pcg_pass_a_band_plain),
                 counted_plain(pcg_pass_b, pcg_pass_b_plain))


guard_reads = types.SimpleNamespace(reads=0)     # host reads of the warp reach test


def _beyond_reach(vs, exchange, halo: int, devices) -> dict:
    """The reach test on each of ``devices``: {device: a 0-dim bool}, true
    unless every band's max |v| is at most ``halo`` - 2, NaN included
    (``vs``: one (rows, W) plane per band, None for another process's
    band); the joined maximum, the same bits on every device."""
    m = exchange.band_max([None if v is None else v.abs().amax() for v in vs], devices)
    return {d: torch.logical_not(t <= halo - 2) for d, t in m.items()}


def _warp_buffers(k: int, hb: int, w: int, device):
    """Fixed (samples, bc_x, bc_y) buffers of a band's warp."""
    return (torch.empty((k, hb, w), dtype=torch.float32, device=device),
            torch.empty((hb, w), dtype=torch.bool, device=device),
            torch.empty((hb, w), dtype=torch.bool, device=device))


def make_sharded_warp(mesh, global_hw: Tuple[int, int], halo: int, true_hw=None):
    """A warp sampler with warp_bilinear_dense's signature over whole
    tensors: each band of the mesh samples its rows from a slab of its rows
    +- ``halo`` with the band form of the warp kernel, and again from the
    whole fields where the reach test fails; the result is on the first
    band's device.  ``true_hw`` must equal ``global_hw``: the bands need no
    padding."""
    if true_hw is not None and tuple(true_hw) != tuple(global_hw):
        raise ValueError("make_sharded_warp: the bands are not padded, true_hw must equal "
                         "global_hw")
    exchange = LocalExchange()
    h = global_hw[0]

    def warp(fields, u, v):
        bands = mesh_bands(mesh, h)
        parts = [(0, fields)]
        out = []
        for dev, r0, r1 in bands:
            s0, s1 = max(0, r0 - halo), min(h, r1 + halo)
            ub, vb = u[r0:r1].to(dev), v[r0:r1].to(dev)
            bufs = _warp_buffers(fields.shape[0], r1 - r0, fields.shape[2], dev)
            warp_band(exchange.rows(parts, s0, s1, dev), ub, vb, s0, r0, h, out=bufs)
            out.append((dev, r0, ub, vb, bufs))

        def wide():
            whole = {dev: fields.to(dev).contiguous() for dev, *_ in out}
            for dev, r0, ub, vb, bufs in out:
                warp_band(whole[dev], ub, vb, 0, r0, h, out=bufs)

        dev0 = bands[0][0]
        guard_reads.reads += when(_beyond_reach([vb for _, _, _, vb, _ in out], exchange,
                                                halo, [dev0])[dev0], wide)
        return tuple(exchange.rows([(r0, bufs[j]) for _, r0, _, _, bufs in out], 0, h, dev0)
                     for j in range(3))

    return warp


class _Band:
    """One band's level state: rows [r0, r1), the assembly's rows [a0, a1)
    (the band and the stencil's ghost rows), the warp slab of rows
    [s0, s1) with its halo, u, v on the assembly's rows and the buffers of
    its warp.  A band of another process (``local`` False) keeps only its
    rows and halo: every process knows every band's requests."""

    def __init__(self, i, dev, r0, r1, h):
        self.i, self.dev, self.r0, self.r1 = i, dev, r0, r1
        self.local = dev.type != "meta"
        self.a0, self.a1 = max(0, r0 - 1), min(h, r1 + 1)
        self.uv = None
        self.level = None           # the whole level's sample stack, where fetched ahead

    def interior(self, t):
        return t[..., self.r0 - self.a0:self.r1 - self.a0, :]

    def plan(self, halo: int, factor: float, hw, hfull: int, top: bool):
        """Set the slab rows at warp halo ``halo``; returns the full-resolution
        rows [f0, f1) the band's level slab reads."""
        h = hw[0]
        self.s0, self.s1 = max(0, self.a0 - halo), min(h, self.a1 + halo)
        # gradient_4th twice: +-4 rows
        self.e0, self.e1 = max(0, self.s0 - 4), min(h, self.s1 + 4)
        if top:
            return self.e0, self.e1
        return pyramid_rows(hfull, factor, (self.e0, self.e1))

    def build(self, rows, f0: int, c: int, factor: float, hfull: int, top: bool):
        """The level-invariant slabs from the full-resolution ``rows`` [f0, f1):
        the stack on rows [s0, s1), [geo1, gx1, gy1] and the hints on the
        assembly's rows, and the warp's buffers."""
        if top:
            lvl = rows
            hint = lvl[2 * c:]
        else:
            lvl = pyramid_downsample_rows(rows, f0, hfull, factor, (self.e0, self.e1))
            hint = lvl[2 * c:] * f32(factor)
        e0 = self.e0
        stack, g1s = level_stacks(lvl[:c], lvl[c:2 * c])
        self.stack = stack[:, self.s0 - e0:self.s1 - e0].contiguous()
        a = slice(self.a0 - e0, self.a1 - e0)
        self.g1s = g1s[:, a].contiguous()
        self.uhat, self.vhat = hint[0, a].contiguous(), hint[1, a].contiguous()
        self.warped = _warp_buffers(6 * c, self.a1 - self.a0, self.stack.shape[2], self.dev)


def _build(bands, halo: int, exchange, full, wfull: int, c: int, factor: float, hw,
           top: bool) -> None:
    """Plan every band at warp halo ``halo``, fetch in one step the
    full-resolution rows each reads, and build the local bands' slabs."""
    hfull = field_rows(full)
    reqs, got = [], []
    for b in bands:
        f0, f1 = b.plan(halo, factor, hw, hfull, top)
        rows = (torch.empty((2 * c + 2, f1 - f0, wfull), dtype=torch.float32, device=b.dev)
                if b.local else None)
        reqs.append((b.i, f0, f1, rows))
        got.append((b, f0, rows))
    exchange.fetch_bands(full, reqs)
    for b, f0, rows in got:
        if b.local:
            b.build(rows, f0, c, factor, hfull, top)


def _fetch_level(bands, exchange, h: int) -> dict:
    """{device: the whole level's sample stack} fetched from the bands' rows
    of their slabs, once per device (the first band of each device or
    process requests it)."""
    field = [(b.r0, b.stack[:, b.r0 - b.s0:b.r1 - b.s0] if b.local else stub(b.r1 - b.r0))
             for b in bands]
    first = {}
    for b in bands:
        first.setdefault((exchange.owner(b.i), b.dev), b)
    level, reqs = {}, []
    for b in first.values():
        if b.local:
            level[b.dev] = torch.empty((b.stack.shape[0], h, b.stack.shape[2]),
                                       dtype=torch.float32, device=b.dev)
        reqs.append((b.i, 0, h, level.get(b.dev) if b.local else None))
    exchange.fetch_bands(field, reqs)
    return level


def _warp_wide(bands, exchange, h: int, warp_fn, tally) -> None:
    """The reach test's body on one device: every local band of ``bands``
    warped again from the whole level's sample stack into its buffers.
    The stack is the one fetched ahead at the top level (``_Band.level``),
    where it was; else the body fetches it from every band of ``bands``.
    ``tally`` (None on the devices that do not keep it) gains one."""
    local = [b for b in bands if b.local]
    level = ({b.dev: b.level for b in local} if all(b.level is not None for b in local)
             else _fetch_level(bands, exchange, h))
    for b in local:
        warp_fn(level[b.dev], b.uv[0], b.uv[1], 0, b.a0, h, out=b.warped)
    if tally is not None:
        tally.add_(1)


def _home(mesh, exchange) -> torch.device:
    """The device of this process's tallies: its first band's."""
    own = [dev for dev in mesh.devices if dev.type != "meta"]
    return own[0] if own else exchange.device


def banded_flow(full, hw, c: int, cfg: OFConfig, mesh, exchange, plain: bool = False,
                marks=None, wide_rounds=None):
    """The coarse-to-fine solve on the mesh's bands: the one loop of the
    whole-tensor ``sharded_variational_flow`` and of the multi-process
    ``parallel.distributed.distributed_variational_flow``.

    ``full`` is the (H, W) = ``hw`` full-resolution [geo1 (C planes),
    geo2 (C), u0, v0] field as parts [(r0, (2C + 2, rows, W)), ...]: any
    parts under a LocalExchange; one per band of ``mesh_bands(mesh, H)``,
    a ``halo.stub`` for each band of another process, under a
    ProcessExchange.  Returns (the bands' [(r0, (2, rows, W) u, v)], stubs
    for other processes' bands; the relaxer's iterations or passes as an
    int32 device scalar).

    Each level's guarded bodies have device tallies of their own, one for
    the solver's and one for the reach test's, since the bands that run
    them differ between levels (a band may be empty at a coarse level);
    ``wide_rounds``, an int32 device scalar where given, is set to the rounds
    whose reach test's body ran.  ``marks`` ({device: utils.profiling.Marks},
    the first band's device first) traces the solve on each of this
    process's cards: the solve, its levels, the relaxer's rounds and the
    exchanges (the level's fetch of its sample stack, each round's ghost
    rows of u and v).
    Each decision is taken on every device of the level's local bands
    (ops.guard.Gate); the reach test's body warps from the whole level's
    sample stack, fetched as the module docstring says.
    """
    h, w = hw
    warp_fn = _PLAIN_WARP if plain else warp_band
    round_fn = _sor_round if cfg.solver == "sor" else _pcg_round
    alpha, lam_a = f32(cfg.alpha), f32(cfg.lambda_over_alpha)
    dev0 = _home(mesh, exchange)
    count = torch.zeros((), dtype=torch.int32, device=dev0)
    marks = marks or {}
    if wide_rounds is not None:
        wide_rounds.zero_()
    for m in marks.values():
        m.solve()
    bands = prev = None
    for k, factor, hw, lambdac_k in level_schedule(cfg, h, w):
        for m in marks.values():
            m.start_level(k)
        lambdac_k = f32(lambdac_k)
        top = k == cfg.kiters - 1
        first = bands is None
        bands = [_Band(i, dev, r0, r1, hw[0])
                 for i, (dev, r0, r1) in enumerate(mesh_bands(mesh, hw[0]))]
        _build(bands, cfg.halo_warp, exchange, full, w, c, factor, hw, top)
        # where the level's decisions are taken: dev0 first
        devs = band_sor.homes([(b.r0, b.stack if b.local else stub(b.r1 - b.r0))
                               for b in bands], exchange)
        in_body = exchange.staged or band_sor.one_body(devs, exchange)
        if not in_body:
            with _traced(marks, "exchange"):
                level = _fetch_level(bands, exchange, hw[0])
            for b in bands:
                if b.local:
                    b.level = level[b.dev]
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

        solved = torch.zeros((), dtype=torch.int32, device=dev0)
        widened = torch.zeros((), dtype=torch.int32, device=dev0)

        def wide(d, bands=bands, h_level=hw[0], widened=widened, in_body=in_body):
            if not in_body:
                bands = [b for b in bands if b.local and b.dev == d]
            _warp_wide(bands, exchange, h_level, warp_fn, widened if d == dev0 else None)

        for j, al1 in enumerate(gnc_rounds(cfg.gnc_steps, cfg.liters)):
            for b in bands:
                if b.local:
                    warp_fn(b.stack, b.uv[0], b.uv[1], b.s0, b.a0, hw[0], out=b.warped)
            gate = decide(_beyond_reach([b.uv[1] if b.local else None for b in bands],
                                        exchange, cfg.halo_warp, devs), widened)
            for d in devs:
                gate(d, lambda d=d: wide(d))
            guard_reads.reads += gate.read
            with _traced(marks, "relax", j) as ran:
                if ran is not None:
                    ran.copy_(solved)
                du = round_fn(bands, hw[0], al1, lambdac_k, alpha, lam_a, cfg, exchange, plain,
                              solved)
                if ran is not None:         # the round's count: solved's gain
                    torch.sub(solved, ran, out=ran)
            for b, d in zip(bands, du):
                if b.local:
                    b.interior(b.uv).add_(d.to(b.dev))
            prev = [(b.r0, b.interior(b.uv) if b.local else stub(b.r1 - b.r0)) for b in bands]
            reqs = []                # the stencil's ghost rows of u and v
            for b in bands:
                reqs += [(b.i, b.a0, b.r0, b.uv[:, :b.r0 - b.a0] if b.local else None),
                         (b.i, b.r1, b.a1, b.uv[:, b.r1 - b.a0:] if b.local else None)]
            with _traced(marks, "exchange", j):
                exchange.fetch_bands(prev, reqs)
        count.add_(solved)
        if wide_rounds is not None:
            wide_rounds.add_(widened)
        wc = hw[1]
    for m in marks.values():
        m.solved()
    return prev, count


@contextlib.contextmanager
def _traced(marks: dict, what: str, *args):
    """The block between stamps on every card of ``marks`` (``Marks.relax``
    or ``Marks.exchange``); yields the first card's round slot of a relaxer
    round, else None.  Without marks, nothing."""
    with contextlib.ExitStack() as stack:
        slots = [stack.enter_context(getattr(m, what)(*args)) for m in marks.values()]
        yield slots[0] if slots else None


def _banded_pair(geo1, geo2, u0, v0, cfg: OFConfig, mesh, exchange, plain: bool = False,
                 field=None, marks=None, wide_rounds=None):
    """``banded_flow`` of whole tensors within one process: (u, v) on the
    mesh's first device, and the relaxer's device count.  ``field``, where
    given, is the (2C + 2, H, W) [geo1, geo2, u0, v0] already joined."""
    # the full-resolution inputs as one field of 2C + 2 planes; each band
    # reads its rows of it through the exchange
    if field is None:
        field = torch.cat([geo1, geo2, u0[None], v0[None]])
    prev, count = banded_flow([(0, field)], tuple(field.shape[1:]), (field.shape[0] - 2) // 2,
                              cfg, mesh, exchange, plain, marks, wide_rounds)
    uv = exchange.rows(prev, 0, field.shape[1], prev[0][1].device)
    return uv[0], uv[1], count


def _coarse_to_fine_banded(geo1, geo2, u0, v0, cfg: OFConfig, mesh, exchange,
                           plain: bool = False):
    """The eager banded solve: (u, v) on the mesh's first device."""
    u, v, count = _banded_pair(geo1, geo2, u0, v0, cfg, mesh, exchange, plain)
    ops.record_pair(cfg.solver, count)
    return u, v


def _sor_round(bands, h, al1, lambdac, alpha, lam_a, cfg, exchange, plain, count):
    asm_fn = _PLAIN_ASSEMBLE if plain else assemble_cf
    parts = []
    for b in bands:
        if not b.local:
            parts.append((b.r0, stub(b.r1 - b.r0)))
            continue
        samples, bc_x, bc_y = b.warped
        cf, _ = asm_fn(samples, bc_x, bc_y, b.g1s, b.uv[0], b.uv[1], b.uhat, b.vhat,
                       al1, lambdac, alpha, lam_a, cfg.dozim)
        parts.append((b.r0, b.interior(cf)))
    dev0 = band_sor.home(parts, exchange)
    resid0 = band_sor.resid0_of(parts, dev0, exchange)
    return band_sor.solve_bands(parts, h, resid0, cfg.cg_tol, cfg.cgiters, cfg.sor_omega,
                                exchange, _PLAIN_PASS if plain else sor_pass_band, count)


def _pcg_round(bands, h, al1, lambdac, alpha, lam_a, cfg, exchange, plain, count):
    asm_fn = _PLAIN_ASSEMBLE_PCG if plain else assemble_pcg
    systems, first = [], []
    for b in bands:
        if not b.local:
            systems.append((b.r0, stub(b.r1 - b.r0), None))
            first.append(None)
            continue
        samples, bc_x, bc_y = b.warped
        cf, rhs, partials = asm_fn(samples, bc_x, bc_y, b.g1s, b.uv[0], b.uv[1], b.uhat,
                                   b.vhat, al1, lambdac, alpha, lam_a, cfg.dozim,
                                   (b.r0 - b.a0, b.r1 - b.a0))
        systems.append((b.r0, cf, rhs))
        first.append(partials)
    passes = _PLAIN_PASSES if plain else (pcg_pass_a_band, pcg_pass_b)
    return band_cg.solve_bands(systems, h, cfg.cg_tol, cfg.cgiters, exchange, *passes,
                               count=count, first=first)


last_program_info = None         # the info of the last program sharded_flow_program gave


def sharded_program_key(cfg: OFConfig, shape, nchan: int, mesh, exchange=None) -> tuple:
    """The fields a banded program is keyed on: octane_tpu's
    (sharded.py:231-234) with the mesh's shape and devices in place of its
    identity, and without its TPU option or its true shape (the bands are
    not padded), and whether the tracer is on (a traced program captures
    its stamps); a program over processes (a ``ProcessExchange``) adds the
    bands' processes, the backend, the group's size and this process's
    rank."""
    key = (tuple(mesh.shape), tuple(device_of(d) for d in mesh.devices), tuple(shape), nchan,
           *solve_fields(cfg), cfg.halo_warp, profiling.enabled())
    if exchange is not None and not isinstance(exchange, LocalExchange):
        key += (exchange.ranks, exchange.backend, exchange.world, exchange.rank)
    return key


class ShardedFlowProgram(CapturedPair):
    """What the two banded programs (see the module docstring) share;
    ``info`` is what ``last_program_info`` reports for it."""

    label = "sharded flow program"

    def __init__(self, cfg: OFConfig, shape, nchan: int, mesh, key, rows: int, devices,
                 route: str, reason: str):
        h, w = self.hw = tuple(shape)
        super().__init__(cfg, (rows, w), nchan, devices[0], route == "graph", devices)
        self.mesh = mesh
        self.wide = None    # the rounds whose band warp fell back to the whole level
        warp_levels = [k for k, _, hw, _ in level_schedule(cfg, h, w)
                       if len(mesh_bands(mesh, hw[0])) > 1]
        self.info = {"warp_levels": frozenset(warp_levels),
                     "cg_levels": frozenset(range(cfg.kiters)), "kiters": cfg.kiters,
                     "key": key, "route": route, "reason": reason}

    def _new_marks(self) -> dict:
        """{device: Marks} of a traced banded solve on this program's cards."""
        return {d: solve_marks(self.cfg, d, exchanges=True) for d in self.devices}

    def __call__(self, geo1, geo2, u0, v0):
        if self.wide is None:           # set by every pair, kept across calls
            self.wide = torch.zeros((), dtype=torch.int32, device=self.device)
        out = super().__call__(geo1, geo2, u0, v0)
        ops.record_wide_rounds(self.wide.clone())
        return out


class MeshFlowProgram(ShardedFlowProgram):
    """The banded program of one process: whole tensors in, the flow on
    the mesh's first device out."""

    def __init__(self, cfg: OFConfig, shape, nchan: int, mesh, key):
        devices = list(dict.fromkeys(device_of(d) for d in mesh.devices))
        first = devices[0]
        if any(d.type != "cuda" for d in devices):
            route, reason = "eager", f"the bands lie on the {first.type}"
        elif len(devices) > 1:
            route, reason = "graph", (f"the bands lie on {len(devices)} cards "
                                      f"({', '.join(map(str, devices))}), one capture")
        else:
            route, reason = "graph", f"every band lies on {first}"
        super().__init__(cfg, shape, nchan, mesh, key, shape[0], devices, route, reason)
        self.field = self.views = None  # the joined inputs (_into_field)

    def __call__(self, geo1, geo2, u0, v0):
        if self.captures:
            self._check(geo1, geo2, u0, v0)
            geo1, geo2, u0, v0 = self._into_field(geo1, geo2, u0, v0)
        return super().__call__(geo1, geo2, u0, v0)

    def _into_field(self, geo1, geo2, u0, v0):
        """The inputs copied into the program's (2C + 2, H, W) field on the
        first band's device, made at the first call: views of it that every
        call and the graph read, so that the joined field is the graph's
        input and no copy of it is made inside the pair."""
        if self.field is None:
            c = self.nchan
            self.field = torch.empty((2 * c + 2, *self.hw), dtype=torch.float32,
                                     device=self.device)
            self.views = (self.field[:c], self.field[c:2 * c], self.field[2 * c],
                          self.field[2 * c + 1])
        if geo1 is not self.views[0]:
            for buf, t in zip(self.views, (geo1, geo2, u0, v0)):
                buf.copy_(t)
        return self.views

    def _static_inputs(self, geo1, geo2, u0, v0) -> list:
        return list(self.views)

    def _pair(self, geo1, geo2, u0, v0, marks=None):
        return _banded_pair(geo1, geo2, u0, v0, self.cfg, self.mesh, LocalExchange(),
                            False, self.field, marks, self.wide)


class ProcessFlowProgram(ShardedFlowProgram):
    """One process's banded program: its row block
    (``parallel.distributed.host_row_block``) in and out.  A replay adds to
    the exchange's ``sent`` what the capture's transfers sent, as its
    launches are added from the capture."""

    def __init__(self, cfg: OFConfig, shape, nchan: int, mesh, key, exchange):
        first = device_of(exchange.device)
        self.row0, r1 = host_row_block(shape[0], mesh)
        if first.type != "cuda":
            route, reason = "eager", f"the bands lie on the {first.type}"
        elif exchange.staged:
            route, reason = "eager", ("gloo stages a card's rows through pinned host "
                                      "memory, which no CUDA graph captures")
        else:
            route, reason = "graph", (f"{exchange.backend}, process {exchange.rank} of "
                                      f"{exchange.world} on {first}")
        super().__init__(cfg, shape, nchan, mesh, key, r1 - self.row0, [first], route, reason)
        self.exchange = exchange
        self.sent: dict = {}            # what one replay's transfers send

    def __call__(self, geo1, geo2, u0, v0):
        out = super().__call__(geo1, geo2, u0, v0)
        if self.graph is not None:      # it replayed
            for k, n in self.sent.items():
                self.exchange.sent[k] += n
        return out

    def _capture(self, geo1, geo2, u0, v0):
        before = dict(self.exchange.sent)
        try:
            super()._capture(geo1, geo2, u0, v0)
        finally:                        # the capture sent nothing
            self.sent = {k: self.exchange.sent[k] - n for k, n in before.items()}
            self.exchange.sent.update(before)

    def _pair(self, geo1, geo2, u0, v0, marks=None):
        block = torch.cat([geo1, geo2, u0[None], v0[None]])
        prev, count = banded_flow(local_parts(block, self.row0, self.mesh, self.hw[0]),
                                  self.hw, self.nchan, self.cfg, self.mesh, self.exchange,
                                  False, marks, self.wide)
        uv = local_rows(prev, block[:2])
        return uv[0], uv[1], count


def sharded_flow_program(cfg: OFConfig, shape, nchan: int, mesh, true_shape=None,
                         exchange=None) -> ShardedFlowProgram:
    """The cached program of the whole banded coarse-to-fine solve over the
    mesh (octane_tpu's sharded_flow_program): with a ``halo.ProcessExchange``
    (one per group, which it keeps: ``parallel.distributed.distributed_exchange``)
    a ``ProcessFlowProgram``, else a ``MeshFlowProgram``.  Sets
    ``last_program_info``: ``warp_levels`` (the levels with more than one
    non-empty band, which the band warp serves), ``cg_levels`` (the levels
    whose solve runs banded: all), ``kiters``, the ``key``, and the ``route``
    ("graph" or "eager") with its ``reason``.  The bands are not padded, so
    ``true_shape`` must be ``shape`` or None."""
    global last_program_info
    if true_shape is not None and tuple(true_shape) != tuple(shape):
        raise ValueError(f"sharded_flow_program: the bands are not padded, true_shape "
                         f"{tuple(true_shape)} must equal shape {tuple(shape)}")
    if isinstance(exchange, LocalExchange):
        exchange = None
    key = sharded_program_key(cfg, shape, nchan, mesh, exchange)
    program = cached(key, lambda: MeshFlowProgram(cfg, shape, nchan, mesh, key)
                     if exchange is None
                     else ProcessFlowProgram(cfg, shape, nchan, mesh, key, exchange))
    last_program_info = program.info
    return program


def sharded_variational_flow(geo1, geo2, u0, v0, cfg: OFConfig, mesh):
    """Coarse-to-fine variational flow on the mesh's row bands, through the
    mesh's program (``sharded_flow_program``); see the module docstring.
    geo1/geo2: (C, H, W) or (H, W) float32 images; u0/v0: (H, W)
    first-guess displacements.  Returns (u, v) on the mesh's first device.
    Every band stays on its device: there is no fallback to the CPU or to
    one device."""
    geo1 = geo1.to(torch.float32)
    geo2 = geo2.to(torch.float32)
    if geo1.dim() == 2:
        geo1, geo2 = geo1[None], geo2[None]
    program = sharded_flow_program(cfg, u0.shape, geo1.shape[0], mesh)
    # the program copies or joins its inputs itself: a broadcast zero guess
    # stays one value
    return program(geo1.contiguous(), geo2.contiguous(), u0.to(torch.float32),
                   v0.to(torch.float32))
