"""exchange_ms: device milliseconds a pair of the copies between cards,
summed over the cards, over the profiled slice (the traffic's
``trace_pairs`` first pairs of the window): the operations that CUPTI
names for peer copies, "Memcpy PtoP (Device -> Device)" on the four-H100
node.  The port moves rows between cards a plane at a time, each plane's
rows one peer copy (parallel.halo.LocalExchange): the bands' ghost rows,
each level's slabs and whole-level sample stack, the flow's rows to the
first card, and pix2uv's rows.  None without a trace or where no peer copy
ran (one card)."""

from octbench import trace

NAMES = ("Memcpy PtoP",)


def read(run):
    if run.trace is None or not run.slice_pairs:
        return None
    us = trace.kernel_us(run.trace, NAMES)
    return us / 1e3 / run.slice_pairs if us > 0 else None
