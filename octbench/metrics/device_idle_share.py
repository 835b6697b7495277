"""device_idle_share: 1 - the cards' busy time over cards x the wall of the
profiled slice (torch.profiler; the slice is the traffic's ``trace_pairs``
pairs ahead of the window), each card's busy time the union of its own
kernel, memcpy and memset intervals (trace.idle_share): on one card,
1 - its busy time over the wall.  It reads under the profiler, whose host
cost stretches the slice's wall: a sector pair by ~10 %, a full-disk pair
by ~2-3 % (PERF.md, section 3).  The wall of the same pairs untraced is
no steadier denominator: a full-disk slice's two pairs differ from two
others by more than the card's idle time."""

from octbench import trace


def read(run):
    return None if run.trace is None else trace.idle_share(run.trace)
