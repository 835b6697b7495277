"""Core numerics on tensors: shifts, blur, bicubic, pyramid zoom, gradients,
robust penalty and normalisation (counterpart of octane_tpu.core)."""

from octane_tpu_torch.core.bc import clamp_shift, mirror_shift
from octane_tpu_torch.core.gaussian import (blur_separable, gaussian_kernel_1d,
                                            ingest_filtsize, solver_filtsize)
from octane_tpu_torch.core.gradients import gradient_4th
from octane_tpu_torch.core.interp import bicubic_sample, bilinear_sample, catmull_rom_cell
from octane_tpu_torch.core.normalize import band_min_max, normalize_image
from octane_tpu_torch.core.psi import psi_deriv
from octane_tpu_torch.core.zoom import (pyramid_downsample, zoom_in_flow,
                                        zoom_in_image, zoom_out_image, zoom_size)

__all__ = [
    "clamp_shift", "mirror_shift",
    "bicubic_sample", "bilinear_sample", "catmull_rom_cell",
    "gaussian_kernel_1d", "blur_separable", "solver_filtsize", "ingest_filtsize",
    "zoom_size", "pyramid_downsample", "zoom_in_flow", "zoom_in_image",
    "zoom_out_image",
    "gradient_4th", "psi_deriv",
    "band_min_max", "normalize_image",
]
