"""Profiling and tracing: the port's tracer (counterpart of
octane_tpu.utils.profiling, which has StageTimer and trace() alone).

The reference has no instrumentation at all (SURVEY.md section 5).  The
tracer is off by default; ``enable()``, ``disable()``, ``reset()`` and
``records()`` control it, and ``trace(log_dir)`` turns it on for its
block.  While it is off a span costs one test of a module-level boolean,
and nothing reaches a captured graph.  It keeps its state in this module
and serves one thread.

**Host spans.**  ``span(name)`` (or a function decorated ``traced(name)``)
records the span's name, start and end (``time.perf_counter_ns``), the
span open around it (its parent) and the request id set by the caller
with ``request(i)``, which every span inside inherits.  While on, each
span is also a ``torch.profiler.record_function`` range, so it lies on the
profiler's timeline beside the device's work.  ``span(name, device)``
also stamps ``device``'s current stream at its entry and exit
(``ops.stamp``), which gives its device start and end, and ``card``, the
index of that card.  The port's spans:

  octane.kernels.load            ops.build.load_kernels (a build included)
  octane.ingest                  io.readers.scene_from_goes_arrays
    octane.ingest.h2d            the counts and scan coordinates to the device
    octane.ingest.navcal         nav.goes.navcal_goes (device stamps)
  octane.flow                    flow.dispatcher.compute_flow
    octane.flow.first_guess      the first guess (given, from winds, or zeros)
    octane.flow.solve            the engine: for the variational solve the
                                 program's lookup, copy-in, replay, copies
                                 of the outputs and ops.record_pair
      octane.flow.patch_match    flow.patch_match's search under patch-match
                                 or the hybrid (device stamps; none on a
                                 mesh); inside it flow.patch_match's own
                                 range octane.patch_match, which is opened
                                 with the tracer off too
    octane.flow.pix2uv           nav.winds.pix2uv (device stamps)
    octane.flow.to_host          io.host.to_host: one a card that copies
                                 product rows to page-locked host memory
                                 (device stamps on that card; on a mesh
                                 inside octane.flow.pix2uv)
  octane.program.warm_up         a program key's eager pair (CapturedPair)
  octane.program.capture         its capture and instantiation
  octane.stage.<name>            StageTimer.stage(name)

**Device spans.**  A traced single-device solve (flow.variational._pair)
stamps its start and end, each pyramid level's start and each GNC round's
relaxer start (after the assembly) and end into ``Marks``, a buffer that
its program owns: in a captured graph the stamps are kernel nodes, none
inside an IF body, so a replay carries them.  A traced banded solve
(parallel.sharded.banded_flow) stamps the same on every card of its bands,
each card into its own ``Marks``, and also each level's fetch of the whole
level's sample stack and each round's exchange of u and v's ghost rows
(``Marks.exchange``).  ``attach(marks)`` files a copy of them, on the
device, under the open span; ``records()`` reads them and gives the spans
``octane.solve``, ``octane.level`` (``at`` = (level,)), ``octane.pcg`` or
``octane.sor`` (``at`` = (level, GNC step, inner iteration)) and
``octane.exchange`` (``at`` = (level,) for the level's fetch, the round's
three numbers for its ghost rows), with device times only and ``card``,
the index of the card that stamped them.  ``Marks.rounds`` holds each
round's device count of relaxer iterations or passes (on a mesh, in the
first card's ``Marks``), which ``ops.record_pair`` accumulates over pairs
(``ops.counters()``'s ``*_by_round``).

**Clock.**  The first ``records()`` that reads a card's stamps measures
the offset of its stamp clock to the host clock: rounds of sync, host
read, stamp, sync, host read, keeping the tightest.  A span's ``device_start`` / ``device_end`` are on the host
clock, in ns, beside its host ``start`` / ``end``.  On the CPU the stamp is
the host clock itself.

StageTimer, wall-clock stage accounting, times each stage with a span
(recorded while the tracer is on); trace() writes a Chrome trace
(viewable in Perfetto or chrome://tracing) with the spans' ranges and the
stamp kernels.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

OFFSET_ROUNDS = 16              # sync, stamp, sync rounds of the clock offset

_on = False
_spans: list = []               # closed spans, in the order they closed
_open: list = []                # the spans open now, outermost first
_solves: list = []              # (parent id, request, stamps on the device, slots)
_request = None
_ids = itertools.count()
_offsets: dict = {}             # device -> its stamp clock less the host clock, ns
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop the records kept so far."""
    _spans.clear()
    _solves.clear()


class Span:
    """A span: a context manager while open, a record once closed.  Host
    ``start`` / ``end`` and ``device_start`` / ``device_end`` are ns on the
    host clock (None where the span has no such side); ``parent`` is the
    ``id`` of the span around it; ``at`` places a device span in the
    solve.  It always times itself (``seconds``); it is recorded when the
    tracer is on at its entry."""

    __slots__ = ("name", "id", "parent", "request", "start", "end", "device_start",
                 "device_end", "at", "card", "_device", "_stamps", "_range")

    def __init__(self, name: str, device=None, at: tuple = ()):
        self.name, self.at, self._device = name, at, device
        self.id = self.parent = self.request = self.card = None
        self.start = self.end = self.device_start = self.device_end = None
        self._stamps = self._range = None

    def __enter__(self):
        if _on:
            self.id = next(_ids)
            self.parent = _open[-1].id if _open else None
            self.request = _request
            _open.append(self)
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        if self._range is not None and self._device is not None:
            from octane_tpu_torch.ops.stamp import stamp

            self._stamps = torch.empty(2, dtype=torch.int64, device=self._device)
            stamp(self._stamps, 0)
        return self

    def __exit__(self, *exc):
        if self._stamps is not None:
            from octane_tpu_torch.ops.stamp import stamp

            stamp(self._stamps, 1)
        self.end = time.perf_counter_ns()
        if self._range is not None:
            _open.remove(self)
            self._range.__exit__(*exc)
            self._range = None
            _spans.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def span(name: str, device=None):
    """The span ``name`` while the tracer is on (with stamps on ``device``
    where one is given), else a context that does nothing."""
    return Span(name, device) if _on else _NULL


def traced(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


@contextlib.contextmanager
def _requesting(i):
    global _request
    outer, _request = _request, i
    try:
        yield
    finally:
        _request = outer


def request(i):
    """The block's spans carry request id ``i`` (while the tracer is on)."""
    return _requesting(i) if _on else _NULL


class Marks:
    """The device side of one traced solve of ``levels`` pyramid levels of
    ``steps`` x ``inner`` relaxer rounds: ``stamps``, one int64 slot per
    stamp, and ``rounds``, each round's int32 count of the relaxer's
    iterations or passes (level-major), both on ``device`` and made before
    a capture, so that a replay writes them in place; ``slots`` names each
    stamp.  ``exchanges`` makes room for a banded solve's exchange spans,
    one a level and one a round.  See the module docstring."""

    def __init__(self, solver: str, levels: int, steps: int, inner: int, device,
                 exchanges: bool = False):
        n = levels * steps * inner
        self.name = f"octane.{solver}"
        self.steps, self.inner = steps, inner
        self.device = torch.device(device)
        size = 2 + levels + 2 * n + (2 * (levels + n) if exchanges else 0)
        self.stamps = torch.zeros(size, dtype=torch.int64, device=device)
        self.rounds = torch.zeros(n, dtype=torch.int32, device=device)
        self.slots: List[Tuple[str, tuple, bool]] = []
        self.level = 0

    def _mark(self, name: str, at: tuple = (), end: bool = False) -> None:
        from octane_tpu_torch.ops.stamp import stamp

        stamp(self.stamps, len(self.slots))
        self.slots.append((name, at, end))

    def solve(self) -> None:
        """The solve's start: a new list of slots."""
        self.slots = []
        self._mark("octane.solve")

    def solved(self) -> None:
        self._mark("octane.solve", end=True)

    def start_level(self, k: int) -> None:
        self.level = k
        self._mark("octane.level", (k,))

    def _round(self, j: int) -> tuple:
        return (self.level, j // self.inner, j % self.inner)

    @contextlib.contextmanager
    def relax(self, j: int):
        """Round ``j`` of the level's relaxer, between two stamps; yields
        the 0-dim slot of ``rounds`` that takes its count."""
        at = self._round(j)
        self._mark(self.name, at)
        yield self.rounds[self.level * self.steps * self.inner + j]
        self._mark(self.name, at, end=True)

    @contextlib.contextmanager
    def exchange(self, j=None):
        """An exchange between the bands, between two stamps: the level's
        (``j`` None) or round ``j``'s."""
        at = (self.level,) if j is None else self._round(j)
        self._mark("octane.exchange", at)
        yield
        self._mark("octane.exchange", at, end=True)


def attach(marks: Marks) -> None:
    """File a copy (on the device) of the stamps that ``marks``' solve has
    just written under the open span."""
    if _on:
        _solves.append((_open[-1].id if _open else None, _request, marks.stamps.clone(),
                        marks.slots))


def _device_spans(parent, request_id, times, slots, card=None) -> list:
    """The device spans of one solve's stamps: a stamp opens a span, or
    closes the open one of its name (``end``); a span opened where one of
    its name is open closes that one first (a level ends where the next
    begins), and what is open at the last stamp closes there."""
    out, stack = [], []
    for t, (name, at, end) in zip(times, slots):
        if end or any(s.name == name for s in stack):
            while stack:
                s = stack.pop()
                s.device_end = t
                if s.name == name:
                    break
        if not end:
            s = Span(name, at=at)
            s.id, s.request, s.device_start, s.card = next(_ids), request_id, t, card
            s.parent = stack[-1].id if stack else parent
            stack.append(s)
            out.append(s)
    for s in stack:
        s.device_end = times[-1]
    return out


def _measure_offset(device) -> int:
    """The card's stamp clock less the host clock (ns), from the tightest
    of OFFSET_ROUNDS rounds of sync, host read, stamp, sync, host read."""
    from octane_tpu_torch.ops.stamp import launch

    buf = torch.zeros(1, dtype=torch.int64, device=device)
    best = None
    for _ in range(OFFSET_ROUNDS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter_ns()
        launch(buf, 0)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
        if best is None or t1 - t0 < best[0]:
            best = (t1 - t0, int(buf.item()) - (t0 + t1) // 2)
    return best[1]


def _offset(device) -> int:
    if device.type != "cuda":
        return 0
    if device not in _offsets:
        _offsets[device] = _measure_offset(device)
    return _offsets[device]


def _resolve() -> None:
    """Read the stamps kept on the devices (one copy to the host a device)."""
    items = defaultdict(list)           # device -> [(span or solve, stamps)]
    for s in _spans:
        if s._stamps is not None:
            items[s._stamps.device].append((s, s._stamps))
    for solve in _solves:
        items[solve[2].device].append((solve, solve[2]))
    solved = []
    for device, group in items.items():
        off = _offset(device)
        flat = torch.cat([t for _, t in group]).tolist()
        pos = 0
        for owner, t in group:
            times = [v - off for v in flat[pos:pos + t.numel()]]
            pos += t.numel()
            if isinstance(owner, Span):
                owner.device_start, owner.device_end = times
                owner.card = device.index
                owner._stamps = None
            else:
                solved += _device_spans(owner[0], owner[1], times, owner[3], device.index)
    _solves.clear()
    _spans.extend(solved)


def records() -> Dict[Optional[int], List[Span]]:
    """{request id (None outside any request): its spans, by start}; the
    device stamps are read here.  The records stay until ``reset()``."""
    _resolve()
    out: Dict[Optional[int], List[Span]] = {}
    for s in sorted(_spans, key=lambda s: s.start if s.start is not None else s.device_start):
        out.setdefault(s.request, []).append(s)
    return out


def totals(spans) -> Dict[str, Tuple[float, float]]:
    """{span name: (host ms, device ms)} summed over ``spans`` (one
    request's records, say); a side a span lacks adds 0."""
    out: Dict[str, Tuple[float, float]] = {}
    for s in spans:
        host, dev = out.get(s.name, (0.0, 0.0))
        if s.start is not None:
            host += (s.end - s.start) / 1e6
        if s.device_start is not None:
            dev += (s.device_end - s.device_start) / 1e6
        out[s.name] = (host, dev)
    return out


def capped_share(by_round, solver: str, cgiters: int, pairs: int) -> Optional[float]:
    """The share of relaxer rounds that ran their whole budget (``cgiters``
    PCG iterations, or the SOR driver's passes for ``cgiters`` sweeps) in
    each of ``pairs`` pairs, from the counts summed over them
    (``ops.counters()``' ``pcg_iterations_by_round`` / ``sor_passes_by_round``)."""
    if not by_round:
        return None
    budget = cgiters
    if solver == "sor":
        from octane_tpu_torch.ops.sor import PASS_SWEEPS

        budget = -(-cgiters // min(PASS_SWEEPS, cgiters))
    return sum(n == budget * pairs for n in by_round) / len(by_round)


class StageTimer:
    """Accumulates wall-clock durations per named stage.

    Each stage is a span ``octane.stage.<name>`` (recorded while the tracer
    is on).  Synchronises the device of ``sync_on`` at stage end so timings
    are attributable; use only for coarse stage accounting.
    """

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        s = Span(f"octane.stage.{name}").__enter__()
        try:
            yield
        finally:
            if torch.is_tensor(sync_on) and sync_on.is_cuda:
                torch.cuda.synchronize(sync_on.device)
            s.__exit__(None, None, None)
            self.records.setdefault(name, []).append(s.seconds)

    def summary(self) -> List[Tuple[str, int, float, float]]:
        """[(stage, count, total_s, mean_s)] ordered by total time."""
        rows = [(k, len(v), sum(v), sum(v) / len(v))
                for k, v in self.records.items()]
        return sorted(rows, key=lambda r: -r[2])

    def report(self) -> str:
        lines = [f"{'stage':<28}{'n':>5}{'total_ms':>12}{'mean_ms':>12}"]
        for name, n, tot, mean in self.summary():
            lines.append(f"{name:<28}{n:>5}{tot * 1e3:>12.2f}{mean * 1e3:>12.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler``, the tracer on, and write
    its Chrome trace to ``log_dir``/trace_<pid>_<ns>.json; yields the
    profiler.  The spans stay for ``records()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
