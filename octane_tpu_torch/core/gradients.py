"""4th-order central differences with clamped taps (counterpart of
octane_tpu.core.gradients; oct_compgrad_cu, oct_variational_optical_flow.cu:
409-449):  df/dx = (-f[i+2] + 8 f[i+1] - 8 f[i-1] + f[i-2]) / 12."""

from __future__ import annotations

import torch

from octane_tpu_torch.core.bc import clamp_shift


def gradient_4th(img: torch.Tensor):
    """Return (d/dx, d/dy) of a (..., H, W) image."""

    def d(axis):
        return (
            -clamp_shift(img, 2, axis)
            + 8.0 * clamp_shift(img, 1, axis)
            - 8.0 * clamp_shift(img, -1, axis)
            + clamp_shift(img, -2, axis)
        ) / 12.0

    return d(-1), d(-2)
