"""The captured pair programs' shared layer: ``CapturedPair``, the one
cache of the single-device (flow.variational) and banded
(parallel.sharded) programs, ``solve_fields`` of their keys, and the
graph and side pools per card that their captures allocate from."""

from __future__ import annotations

import contextlib

import torch

from octane_tpu_torch import ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.zoom import clear_flow_zoom_matrices
from octane_tpu_torch.ops.guard import body_pool, recording
from octane_tpu_torch.utils import profiling

_cache: dict = {}               # key -> program
_graph_pools: dict = {}
_side_pools: dict = {}


def solve_fields(cfg: OFConfig) -> tuple:
    """The config fields the solve reads: those of every program's key."""
    return (cfg.alpha, cfg.lambda_, cfg.lambdac, cfg.scale_factor, cfg.kiters, cfg.liters,
            cfg.cgiters, cfg.gnc_steps, cfg.dozim, cfg.solver, cfg.sor_omega, cfg.cg_tol)


def cached(key, make):
    """The program of ``key``, made by ``make()`` at its first use."""
    if key not in _cache:
        _cache[key] = make()
    return _cache[key]


def drop_programs(kind) -> None:
    """Drop every cached program of class ``kind``, its graph reset first."""
    for key, program in list(_cache.items()):
        if isinstance(program, kind):
            if program.graph is not None:
                program.graph.reset()
                program.graph = None
            del _cache[key]


def clear_program_cache() -> None:
    """Drop every program, the banded ones too, and the flow zoom's cached
    matrices, and return their memory to the card."""
    _cache.clear()
    _graph_pools.clear()            # a pool whose graphs are gone is not reused
    _side_pools.clear()
    clear_flow_zoom_matrices()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def solve_marks(cfg: OFConfig, device, exchanges: bool = False) -> profiling.Marks:
    """The stamps and round counts of a traced solve of ``cfg`` (with room
    for a banded solve's exchanges)."""
    return profiling.Marks(cfg.solver, cfg.kiters, cfg.gnc_steps, cfg.liters, device,
                           exchanges)


def record_solve(solver: str, count, marks, nodes=None, guarded=()) -> None:
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
    device = device_of(device)
    ids = {tuple(body_pool(device).id)}
    if device in _graph_pools:
        ids.add(tuple(_graph_pools[device]))
    if device in _side_pools:
        ids.add(tuple(_side_pools[device].id))
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg.get("segment_pool_id", (0, 0))) in ids)


def device_of(device) -> torch.device:
    """``device`` as a torch.device; a bare "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class CapturedPair:
    """A pair's solve for one (shape, channels, config, device), captured as
    one CUDA graph: the machinery that ``FlowProgram`` and the banded
    programs (parallel.sharded) share.  Call it as
    ``program(geo1, geo2, u0, v0)`` -> (u, v); ``shape`` is the (rows, W)
    of the flows it is given.

    A subclass gives ``_pair(geo1, geo2, u0, v0, marks)`` -> (u, v, count),
    the solve on this device with ``count`` its relaxer's iterations or
    passes as an int32 device scalar (traced into ``marks`` where given),
    and ``_new_marks()``, the stamps of a traced solve, and sets
    ``captures``.  Where that is false, every call runs and records the
    solve eagerly (``_eager``); else the first call runs the solve
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
        # a traced solve's profiling.Marks
        self.marks = self._new_marks() if captures and profiling.enabled() else None

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
                record_solve(self.cfg.solver, count, self.marks)
            return u, v
        if self.graph is None:
            self._capture(geo1, geo2, u0, v0)
        for buf, t in zip(self.inputs, (geo1, geo2, u0, v0)):
            if buf is not t:
                buf.copy_(t)
        self.graph.replay()
        u, v, count = (t.clone() for t in self.outputs)
        record_solve(self.cfg.solver, count, self.marks, self.nodes,
                     [(body, tally.clone()) for body, tally in self.guarded])
        return u, v

    def _eager(self, geo1, geo2, u0, v0):
        marks = self._new_marks() if profiling.enabled() else None
        u, v, count = self._pair(geo1, geo2, u0, v0, marks)
        record_solve(self.cfg.solver, count, marks)
        return u, v

    def _warm_up(self, geo1, geo2, u0, v0):
        """The eager solve on a side stream: (u, v, count)."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._pair(geo1, geo2, u0, v0, self.marks)
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
                outputs = self._pair(*inputs, self.marks)
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
