"""Post-processing: bilateral flow smoothing and temporal interpolation
(counterpart of octane_tpu.post)."""

from octane_tpu_torch.post.srsal import srsal_smooth
from octane_tpu_torch.post.temporal import fill_holes, forward_splat, interpolate_frame

__all__ = ["srsal_smooth", "fill_holes", "forward_splat", "interpolate_frame"]
