"""pair_ms_p95: the 95th percentile (linear interpolation between ranks)
of every pair's latency in the window, host clock."""

import numpy as np


def read(run):
    if len(run.latencies) < 20:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
