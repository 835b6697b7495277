"""Reduction of a ``torch.profiler`` trace of the profiled slice: each
card's busy time as the union of its kernel, memcpy and memset
intervals, kernel time by name and by layer (summed over the cards), and
the gaps in which no card is busy by what the host was doing.  The
grouping of kernel names into the port's layers is a frozen copy of
tools/profile_torch_pair.py's.

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
    (t0, t1): the slice; cards: how many cards the run uses, busy or not."""

    device: List[Tuple[float, float, str, int]]
    host: List[Tuple[float, float, str]]
    t0: float
    t1: float
    cards: int = 1


def from_profiler(prof, cards: int = 1) -> Trace:
    import torch

    device, host, span = [], [], None
    for ev in prof.events():
        rng = (float(ev.time_range.start), float(ev.time_range.end), ev.name)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # a record_function range is mirrored on the device's timeline
            # around the work it launched: not an operation of the device
            if not (getattr(ev, "is_user_annotation", False) or ev.name.startswith("octbench.")):
                device.append(rng + (int(ev.device_index),))
        else:
            host.append(rng)
            if ev.name == SLICE:
                span = rng
    if span is None:
        raise RuntimeError(f"octbench: the trace has no {SLICE} range")
    device.sort()
    host.sort()
    return Trace(device, host, span[0], span[1], cards)


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
