"""Post-processing: bilateral flow smoothing (counterpart of octane_tpu.post)."""

from octane_tpu_torch.post.srsal import srsal_smooth

__all__ = ["srsal_smooth"]
