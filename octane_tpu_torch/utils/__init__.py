"""Utilities: profiling (counterpart of octane_tpu.utils)."""

from octane_tpu_torch.utils.profiling import StageTimer, trace

__all__ = ["StageTimer", "trace"]
