"""pair_ms: the window over the pairs completed in it, host clock, from
counts in host memory to winds in host memory, one pair in flight."""


def read(run):
    return 1e3 * run.window_s / run.pairs if run.pairs else None
