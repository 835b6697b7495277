"""Gaussian kernel and separable blur (counterpart of octane_tpu.core.gaussian).

Keeps the reference's two quirks: the 2*filtsize+1 tap kernel is
normalised over all taps but the convolution applies only taps
-filtsize .. filtsize-1 (oct_variational_optical_flow.cu:322,344), and the
boundary is clamp-to-edge.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from octane_tpu_torch.core.bc import clamp_shift


def solver_filtsize(factor: float) -> int:
    """sigma = 1/sqrt(2*factor), filtsize = trunc(2*sigma), min 5
    (oct_variational_optical_flow.cu:521-526)."""
    sigma = 1.0 / math.sqrt(2.0 * factor)
    return max(int(2.0 * sigma), 5)


def ingest_filtsize(sigma: float) -> int:
    """Half-width of the ingest blur: trunc(2*sigma), min 5
    (oct_gaussian.cc:54-56)."""
    return max(int(2.0 * sigma), 5)


def gaussian_kernel_1d(sigma: float, filtsize: int) -> np.ndarray:
    """2*filtsize+1 taps, exp(-x^2/2s^2)/(pi*2s^2), sum-normalised, float32."""
    s = 2.0 * sigma * sigma
    x = np.arange(-filtsize, filtsize + 1, dtype=np.float64)
    k = np.exp(-(x * x) / s) / (math.pi * s)
    k = k / k.sum()
    return k.astype(np.float32)


def blur_separable(img: torch.Tensor, kernel: np.ndarray,
                   filtsize: int) -> torch.Tensor:
    """Clamp-edge separable blur of (..., H, W), taps [-filtsize, filtsize),
    horizontal then vertical, accumulated in tap order."""
    kernel = np.asarray(kernel, np.float32)

    def conv_axis(a, axis):
        out = None
        for off in range(-filtsize, filtsize):
            term = clamp_shift(a, off, axis) * float(kernel[off + filtsize])
            out = term if out is None else out + term
        return out

    return conv_axis(conv_axis(img, -1), -2)
