"""patch_match_ms: device milliseconds a pair launched inside the port's
``octane.patch_match`` range, over the profiled slice (the traffic's
``trace_pairs`` pairs ahead of the window), summed over the cards
(trace.device_us_in).  flow.patch_match opens that range once a search,
around the whole search and its sub-pixel fit, whether or not the port's
tracer is on.  None without a trace, or where nothing ran inside such a
range (a program that opens none)."""

from octbench import trace

RANGE = "octane.patch_match"


def read(run):
    if run.trace is None or not run.slice_pairs:
        return None
    us = trace.device_us_in(run.trace, RANGE)
    return us / 1e3 / run.slice_pairs if us > 0 else None
