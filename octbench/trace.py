"""Reduction of a ``torch.profiler`` trace of the profiled slice: each
card's busy time as the union of its kernel, memcpy and memset
intervals, kernel time by name, by layer and by the host range that
launched it (summed over the cards), and the gaps in which no card is
busy by what the host was doing.  The grouping of kernel names into the
port's layers is a frozen copy of tools/profile_torch_pair.py's.

Times are in the profiler's microseconds; ``Trace`` holds plain tuples, so
the arithmetic is tested without a profiler.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

SLICE = "octbench.slice"            # the record_function range of the profiled slice
GAP_MIN_US = 10.0                   # shorter gaps are launch latencies, not host work

GROUPS = (("warp_bilinear", "warp kernel"), ("warp_band", "warp kernel (band form)"),
          ("pcg_pass_a", "PCG pass A"), ("pcg_pass_b", "PCG pass B"),
          ("assemble_cf", "fused assembly kernel"), ("assemble_pcg", "PCG assembly kernel"),
          ("sor_pass", "SOR pass kernel"), ("gemm", "matmul (zoom)"),
          ("index", "index_select (shifts, subsample)"), ("reduce", "reductions (sums)"),
          ("elementwise", "elementwise"), ("copy", "copies / cat / stack"),
          ("fill", "fills"), ("set_if", "graph IF-node conditions"))


def group(name: str) -> str:
    low = name.lower()
    for key, label in GROUPS:
        if key in low:
            return label
    if "cat" in low or "memcpy" in low:
        return "copies / cat / stack"
    return "other"


@dataclasses.dataclass
class Trace:
    """device: [(start, end, name, card)] of every device operation, card
    the device's index; host: [(start, end, name)] of every host range;
    (t0, t1): the slice; cards: how many cards the run uses, busy or not;
    launched_in: for each device operation, in the order of ``device``,
    the names of the record_function ranges open on the host where it was
    launched, innermost first (empty where the trace does not link it to
    its launch)."""

    device: List[Tuple[float, float, str, int]]
    host: List[Tuple[float, float, str]]
    t0: float
    t1: float
    cards: int = 1
    launched_in: List[Tuple[str, ...]] = dataclasses.field(default_factory=list)


def _open_ranges(ranges, points):
    """For each (t, thread) of ``points``, the names of the ``ranges``
    ((start, end, name, thread)) open at t on that thread, innermost (the
    latest begun) first; on every thread where that thread opened none."""
    threads = {r[3] for r in ranges}
    out = [()] * len(points)
    for th in threads | {None}:
        mine = sorted(r for r in ranges if th is None or r[3] == th)
        todo = sorted((t, i) for i, (t, p_th) in enumerate(points)
                      if (p_th == th if th is not None else p_th not in threads))
        j, active = 0, []
        for t, i in todo:
            while j < len(mine) and mine[j][0] <= t:
                active.append(mine[j])
                j += 1
            active = [r for r in active if r[1] > t]
            out[i] = tuple(r[2] for r in sorted(active, reverse=True))
    return out


def from_profiler(prof, cards: int = 1) -> Trace:
    """The Trace of a profile that holds the ``SLICE`` range.  A device
    operation was launched where the runtime call with its correlation id
    ran: for a graph replay's kernels, ``cudaGraphLaunch``."""
    import torch

    device, ids, host, ranges, runtime, span = [], [], [], [], {}, None
    for ev in prof.events():
        rng = (float(ev.time_range.start), float(ev.time_range.end), ev.name)
        user = getattr(ev, "is_user_annotation", False)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # a record_function range is mirrored on the device's timeline
            # around the work it launched: not an operation of the device
            if not (user or ev.name.startswith("octbench.")):
                device.append(rng + (int(ev.device_index),))
                ids.append(ev.id)
        else:
            host.append(rng)
            if ev.name == SLICE:
                span = rng
            if user:
                ranges.append(rng + (ev.thread,))
            elif ev.name.startswith("cu"):          # cudaLaunchKernel, cudaGraphLaunch, ...
                runtime[ev.id] = (rng[0], ev.thread)
    if span is None:
        raise RuntimeError(f"octbench: the trace has no {SLICE} range")
    launches = [runtime.get(i) for i in ids]
    found = iter(_open_ranges(ranges, [p for p in launches if p is not None]))
    names = [() if p is None else next(found) for p in launches]
    order = sorted(range(len(device)), key=device.__getitem__)
    host.sort()
    return Trace([device[i] for i in order], host, span[0], span[1], cards,
                 [names[i] for i in order])


def union(intervals) -> List[Tuple[float, float]]:
    """Sorted disjoint union of (start, end) intervals."""
    out: List[List[float]] = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _clipped(tr: Trace, card=None):
    """The device intervals inside the slice, of one card or of all."""
    return [(max(s, tr.t0), min(e, tr.t1)) for s, e, _, c in tr.device
            if e > tr.t0 and s < tr.t1 and (card is None or c == card)]


def busy_by_card(tr: Trace) -> Dict[int, float]:
    """{card: busy time inside the slice}, each card's the union of its own
    intervals."""
    return {card: sum(e - s for s, e in union(_clipped(tr, card)))
            for card in sorted({c for *_, c in tr.device})}


def busy_us(tr: Trace) -> float:
    """Busy time inside the slice summed over the cards: cards x wall less
    the idle card-time."""
    return sum(busy_by_card(tr).values())


def idle_share(tr: Trace) -> float:
    """1 - the cards' summed busy time over cards x the slice's wall: on
    one card, 1 - its busy time over the wall."""
    return 1.0 - busy_us(tr) / (tr.cards * (tr.t1 - tr.t0))


def kernel_us(tr: Trace, names) -> float:
    """Summed device time, over the cards, of the operations whose name
    holds one of ``names``."""
    return sum(e - s for s, e, n, _ in tr.device if any(k in n for k in names))


def device_us_in(tr: Trace, prefix: str) -> float:
    """Device time inside the slice, summed over the cards, of the
    operations launched inside a host range whose name starts with
    ``prefix``."""
    return sum(min(e, tr.t1) - max(s, tr.t0)
               for (s, e, _, _), names in zip(tr.device, tr.launched_in)
               if e > tr.t0 and s < tr.t1 and any(n.startswith(prefix) for n in names))


def device_ops(tr: Trace, top: int = 10) -> List[list]:
    """[[layer, seconds]] of the device time by layer (``group``), summed
    over the cards, largest first."""
    by = defaultdict(float)
    for s, e, n, _ in tr.device:
        by[group(n)] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _host_label(tr: Trace, starts, t: float) -> str:
    """The outermost octbench range and the innermost host range open at ``t``."""
    i = bisect.bisect_right(starts, t)
    outer, inner = None, None
    for s, e, n in tr.host[max(0, i - 400):i]:
        if s <= t < e and n != SLICE:
            if n.startswith("octbench.") and outer is None:
                outer = n
            if inner is None or s >= inner[0]:
                inner = (s, n)
    if inner is None:
        return "no host range open"
    label = inner[1]
    return f"{outer}: {label}" if outer and outer != label else label


def idle_gaps(tr: Trace, top: int = 10) -> List[list]:
    """[[what the host was doing, seconds]] of the gaps in the slice longer
    than GAP_MIN_US in which no card is busy, summed by the host range
    open at each gap's start, largest first.  A gap on one card while
    another works is not among them."""
    busy = union(_clipped(tr))
    edges = [tr.t0] + [x for iv in busy for x in iv] + [tr.t1]
    starts = [s for s, _, _ in tr.host]
    by: Dict[str, float] = defaultdict(float)
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 - g0 >= GAP_MIN_US:
            by[_host_label(tr, starts, g0)] += (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
