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
package's one jitted program per (shape, channels, config): on a CUDA
device the first pair of a key runs eagerly, the second captures the whole
coarse-to-fine solve into one CUDA graph, and it and every later pair are
one replay each, with the relaxers' stopping tests in graph IF nodes
(ops.guard) and no host read between the first launch and the result.
``variational_flow`` goes through it; on the CPU a program runs the solve
eagerly.  ``clear_program_cache`` drops every program.  While the tracer
(utils.profiling) is on, a solve stamps its levels and relaxer rounds and
keeps each round's count; a program made then captures those too.

The mesh path (octane_tpu_torch.parallel.sharded) runs the same schedule
(``level_schedule``, ``gnc_rounds``) on row bands, through a program of
its own built on ``CapturedPair``.

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

from octane_tpu_torch import ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.gradients import gradient_4th
from octane_tpu_torch.core.zoom import (clear_flow_zoom_matrices, pyramid_downsample,
                                        zoom_in_flow, zoom_size)
from octane_tpu_torch.ops.assemble import (assemble_cf, assemble_cf_plain, assemble_pcg,
                                           assemble_pcg_plain)
from octane_tpu_torch.ops.guard import body_pool, recording
from octane_tpu_torch.ops.pcg import (pcg_pass_a, pcg_pass_a_plain, pcg_pass_b,
                                      pcg_pass_b_plain, pcg_solve_cf)
from octane_tpu_torch.ops.sor import sor_pass, sor_pass_plain, sor_solve_cf
from octane_tpu_torch.ops.warp import warp, warp_bilinear_dense
from octane_tpu_torch.utils import profiling


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
_PLAIN_ASSEMBLE_PCG = _counted_plain(assemble_pcg, assemble_pcg_plain)
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
    gx1, gy1 = gradient_4th(g1)
    gx2, gy2 = gradient_4th(g2)
    gxx, _ = gradient_4th(gx2)
    gxy, gyy = gradient_4th(gy2)   # Ixy = d/dx (d/dy geo2), ref :591-594
    stack = torch.cat([g2, gx2, gy2, gxx, gxy, gyy], dim=0).contiguous()
    warp_fn = _PLAIN_WARP if plain else warp
    alpha, lam_over_alpha, lambdac = _f32(alpha), _f32(lam_over_alpha), _f32(lambdac)

    # the level stack [geo1, gx1, gy1] is loop-invariant
    g1s = torch.cat([g1, gx1, gy1], dim=0).contiguous()
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


def _marks(cfg: OFConfig, device, exchanges: bool = False) -> profiling.Marks:
    """The stamps and round counts of a traced solve of ``cfg`` (with room
    for a banded solve's exchanges)."""
    return profiling.Marks(cfg.solver, cfg.kiters, cfg.gnc_steps, cfg.liters, device,
                           exchanges)


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
    # the four full-resolution inputs are resampled together (each plane
    # independently, so the values are those of separate calls)
    full = torch.cat([geo1, geo2, u0[None], v0[None]])
    u = v = None
    for k, factor, (nyy, nxx), lambdac_k in level_schedule(cfg, h, w):
        if marks is not None:
            marks.start_level(k)
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
            solver=cfg.solver, sor_omega=cfg.sor_omega, plain=plain, count=count,
            marks=marks)
    if marks is not None:
        marks.solved()
    return u, v, count


def _record(solver: str, count, marks, nodes=None, guarded=()) -> None:
    """``ops.record_pair`` of a solve, and where it was traced, its round
    counts and stamps; ``marks`` is one Marks, or {device: Marks} of a
    banded solve, whose first holds the round counts."""
    every = [] if marks is None else list(marks.values()) if isinstance(marks, dict) else [marks]
    ops.record_pair(solver, count, nodes, guarded, every[0].rounds if every else None)
    for m in every:
        if m.device != every[0].device:
            # another card's stamps: its copy waits for the pair, which the
            # first card's stream ran
            torch.cuda.current_stream(m.device).wait_stream(
                torch.cuda.current_stream(every[0].device))
        profiling.attach(m)


def _coarse_to_fine(geo1, geo2, u0, v0, cfg: OFConfig, plain: bool = False):
    """The eager solve: (u, v); traced while the tracer is on."""
    marks = _marks(cfg, u0.device) if profiling.enabled() else None
    u, v, count = _pair(geo1, geo2, u0, v0, cfg, plain, marks)
    _record(cfg.solver, count, marks)
    return u, v


_program_cache: dict = {}
_graph_pools: dict = {}
_side_pools: dict = {}


def _graph_pool(device):
    """The memory pool that every program of ``device`` is captured into."""
    if device not in _graph_pools:
        _graph_pools[device] = torch.cuda.graph_pool_handle()
    return _graph_pools[device]


def _side_pool(device):
    """The memory pool of the programs' allocations on ``device`` where a
    capture begun on another card reaches it."""
    if device not in _side_pools:
        with torch.cuda.device(device):
            _side_pools[device] = torch.cuda.MemPool()
    return _side_pools[device]


@contextlib.contextmanager
def _forked(devices):
    """Pull ``devices`` (cards other than the capturing one) into the
    capture on the current card: each card's current stream becomes a side
    stream that waits on the capturing stream and that the capturing stream
    waits on at the end, and its allocations come from ``_side_pool``."""
    main = torch.cuda.current_stream()
    prev, sides = {}, {}
    with contextlib.ExitStack() as pools:
        try:
            for dev in devices:
                with torch.cuda.device(dev):
                    prev[dev] = torch.cuda.current_stream(dev)
                    side = torch.cuda.Stream(dev)
                    side.wait_stream(main)
                    torch.cuda.set_stream(side)
                    sides[dev] = side
                pools.enter_context(torch.cuda.use_mem_pool(_side_pool(dev), device=dev))
            yield
        finally:
            for dev, side in sides.items():
                main.wait_stream(side)
                with torch.cuda.device(dev):
                    torch.cuda.set_stream(prev[dev])


def program_pool_bytes(device) -> int:
    """Bytes reserved on ``device`` by the programs' graph pool, their pool
    on a card that a capture begun elsewhere reaches, and the IF-node
    bodies' pool."""
    device = _device(device)
    ids = {tuple(body_pool(device).id)}
    if device in _graph_pools:
        ids.add(tuple(_graph_pools[device]))
    if device in _side_pools:
        ids.add(tuple(_side_pools[device].id))
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg.get("segment_pool_id", (0, 0))) in ids)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class CapturedPair:
    """A pair's solve for one (shape, channels, config, device), captured as
    one CUDA graph: the machinery that ``FlowProgram`` and the banded
    program (parallel.sharded.ShardedFlowProgram) share.  Call it as
    ``program(geo1, geo2, u0, v0)`` -> (u, v); ``shape`` is the (rows, W)
    of the flows it is given.

    A subclass gives ``_solve(geo1, geo2, u0, v0)`` -> (u, v, count), the
    solve on this device with ``count`` its relaxer's iterations or passes
    as an int32 device scalar, and ``_eager(geo1, geo2, u0, v0)`` -> (u, v),
    the solve where nothing is captured (it records its own pair); it sets
    ``captures``.  Where ``captures`` holds, the first call runs the solve
    eagerly on a side stream (the warm-up: it builds the kernels, loads
    them and fills the device-side caches, such as the flow zoom's
    matrices) and returns its flow, so a key used once costs one eager
    pair.  The second call copies its inputs into static buffers and
    captures the solve into one CUDA graph in the device's shared pool
    (capture and instantiation take ``capture_seconds``); it and every
    later call copy their inputs in, replay the graph and return copies of
    the outputs, which no later replay touches.  A failed capture raises;
    nothing falls back to the eager solve.  A solve that also computes on
    other cards (``devices``, the first being ``device``) is captured in
    the same graph: the capture begins on ``device``, and each other card
    computes on a side stream forked into it, allocating from that card's
    program pool (``_forked``).

    The wrappers count launches in Python, where a replay calls none, so
    the capture records which of them its graph launches outside guarded
    bodies (``nodes``) and, for each kind of guarded body (one per device
    tally, ops.guard), the launches of one body; each replay reports these
    with the tallies of the bodies that ran to ``ops.record_pair``.

    The warm-up and the capture are the tracer's spans
    ``octane.program.warm_up`` and ``octane.program.capture``.  A program
    made while the tracer is on is traced (``marks``, a
    utils.profiling.Marks made before the capture): its graph also holds
    the solve's stamps and round counts, and each pair files them
    (``profiling.attach``, ``ops.record_pair``).
    """

    label = "flow program"

    def __init__(self, cfg: OFConfig, shape, nchan: int, device, captures: bool,
                 devices=None):
        self.cfg, self.shape, self.nchan = cfg, tuple(shape), nchan
        self.device = device
        self.devices = tuple(devices or (device,))
        self.captures = captures
        self.warmed = False
        self.graph = None
        self.inputs = self.outputs = None
        self.nodes: dict = {}
        self.guarded: list = []         # [(launches of one body, its device tally)]
        self.capture_seconds = None
        self.marks = None               # a traced solve's profiling.Marks

    def _check(self, geo1, geo2, u0, v0) -> None:
        if (tuple(geo1.shape) != (self.nchan, *self.shape) or geo2.shape != geo1.shape
                or tuple(u0.shape) != self.shape or v0.shape != u0.shape):
            raise ValueError(f"{self.label} of {self.nchan} x {self.shape}: got images "
                             f"{tuple(geo1.shape)}, {tuple(geo2.shape)} and flows "
                             f"{tuple(u0.shape)}, {tuple(v0.shape)}")

    def __call__(self, geo1, geo2, u0, v0):
        self._check(geo1, geo2, u0, v0)
        if not self.captures:
            return self._eager(geo1, geo2, u0, v0)
        if not self.warmed:
            with profiling.span("octane.program.warm_up"):
                u, v, count = self._warm_up(geo1, geo2, u0, v0)
                _record(self.cfg.solver, count, self.marks)
            return u, v
        if self.graph is None:
            self._capture(geo1, geo2, u0, v0)
        for buf, t in zip(self.inputs, (geo1, geo2, u0, v0)):
            if buf is not t:
                buf.copy_(t)
        self.graph.replay()
        u, v, count = (t.clone() for t in self.outputs)
        _record(self.cfg.solver, count, self.marks, self.nodes,
                [(body, tally.clone()) for body, tally in self.guarded])
        return u, v

    def _solve(self, geo1, geo2, u0, v0):
        raise NotImplementedError

    def _eager(self, geo1, geo2, u0, v0):
        raise NotImplementedError

    def _warm_up(self, geo1, geo2, u0, v0):
        """The eager solve on a side stream: (u, v, count)."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._solve(geo1, geo2, u0, v0)
        current.wait_stream(side)
        for t in out:                   # made on the side stream, used on this one
            t.record_stream(current)
        self.warmed = True
        return out

    def _static_inputs(self, geo1, geo2, u0, v0) -> list:
        """The buffers that the graph reads its inputs from, holding these
        inputs: copies of them (a subclass may keep its own)."""
        return [t.to(device=self.device, dtype=torch.float32).clone()
                for t in (geo1, geo2, u0, v0)]

    def _capture(self, geo1, geo2, u0, v0):
        dev = self.device
        inputs = self._static_inputs(geo1, geo2, u0, v0)
        before = {name: fn.launches for name, fn in ops.WRAPPERS.items()}
        graph = torch.cuda.CUDAGraph()
        span = profiling.Span("octane.program.capture")
        try:
            # thread_local: the capture refuses this thread's unsafe calls, not
            # those of other threads, such as NCCL's watchdog polling its events
            with (span, recording() as bodies, torch.cuda.device(dev),
                  torch.cuda.graph(graph, pool=_graph_pool(dev),
                                   capture_error_mode="thread_local"),
                  _forked([d for d in self.devices if d != dev])):
                outputs = self._solve(*inputs)
        finally:                        # a capture launches nothing
            captured = {name: fn.launches - before[name] for name, fn in ops.WRAPPERS.items()}
            for name, fn in ops.WRAPPERS.items():
                fn.launches = before[name]
        self.capture_seconds = span.seconds
        kinds = {}      # (id(tally), place in its decision) -> (tally, launches of one body)
        for tally, index, body in bodies:
            if tally is None:
                raise RuntimeError(f"{self.label}: a guarded body has no device tally")
            if kinds.setdefault((id(tally), index), (tally, body))[1] != body:
                raise RuntimeError(f"{self.label}: guarded bodies of one tally and place "
                                   "launch different kernels")
            for name, n in body.items():
                captured[name] -= n
        self.nodes = {name: n for name, n in captured.items() if n}
        self.guarded = [(body, tally) for tally, body in kinds.values()]
        self.graph, self.inputs, self.outputs = graph, inputs, outputs


class FlowProgram(CapturedPair):
    """The coarse-to-fine solve of one (shape, channels, config, device)
    (see CapturedPair); on the CPU it runs the solve eagerly."""

    def __init__(self, cfg: OFConfig, shape, nchan: int, device):
        device = _device(device)
        super().__init__(cfg, shape, nchan, device, device.type == "cuda")
        if self.captures and profiling.enabled():
            self.marks = _marks(cfg, device)

    def _solve(self, geo1, geo2, u0, v0):
        return _pair(geo1, geo2, u0, v0, self.cfg, marks=self.marks)

    def _eager(self, geo1, geo2, u0, v0):
        return _coarse_to_fine(geo1, geo2, u0, v0, self.cfg)


def program_key(cfg: OFConfig, shape, nchan: int, device) -> tuple:
    """The fields a program is keyed on: those of octane_tpu's
    flow_program (variational.py:262-263) but its TPU option, the device,
    and whether the tracer is on (a traced program captures its stamps)."""
    return (tuple(shape), nchan, cfg.alpha, cfg.lambda_, cfg.lambdac, cfg.scale_factor,
            cfg.kiters, cfg.liters, cfg.cgiters, cfg.gnc_steps, cfg.dozim,
            cfg.solver, cfg.sor_omega, cfg.cg_tol, _device(device), profiling.enabled())


def flow_program(cfg: OFConfig, shape, nchan: int, device) -> FlowProgram:
    """The cached program of the entire coarse-to-fine solve for a
    (shape, channels, config, device); see FlowProgram."""
    key = program_key(cfg, shape, nchan, device)
    if key not in _program_cache:
        _program_cache[key] = FlowProgram(cfg, shape, nchan, device)
    return _program_cache[key]


def clear_program_cache() -> None:
    """Drop every program, the banded ones too, and the flow zoom's cached
    matrices, and return their memory to the card."""
    from octane_tpu_torch.parallel.sharded import _sharded_program_cache

    _program_cache.clear()
    _sharded_program_cache.clear()
    _graph_pools.clear()            # a pool whose graphs are gone is not reused
    _side_pools.clear()
    clear_flow_zoom_matrices()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


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
