"""Profiling and tracing (counterpart of octane_tpu.utils.profiling).

The reference has no instrumentation at all (SURVEY.md section 5).  This
module provides:

  * StageTimer -- wall-clock stage accounting; a stage given a CUDA tensor
    to wait for synchronises its device first (the counterpart of
    ``jax.block_until_ready``), so its time is attributable;
  * trace() -- a context manager around ``torch.profiler`` that records the
    CPU and, where a card is present, the CUDA activity, and writes a
    Chrome trace (viewable in Perfetto or chrome://tracing) into a
    directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Tuple

import torch


class StageTimer:
    """Accumulates wall-clock durations per named stage.

    Synchronises the device of ``sync_on`` at stage end so timings are
    attributable; use only for coarse stage accounting.
    """

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.is_tensor(sync_on) and sync_on.is_cuda:
                torch.cuda.synchronize(sync_on.device)
            self.records.setdefault(name, []).append(time.perf_counter() - t0)

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
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``log_dir``/trace_<pid>_<ns>.json; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
