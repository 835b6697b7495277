"""Solver pyramid resampling (counterpart of octane_tpu.core.zoom).

* ``pyramid_downsample``: blur at full resolution, then point-sample at
  (trunc(jj/factor), trunc(ii/factor)) -- the reference's integer-position
  bicubic (oct_variational_optical_flow.cu:352-408).  The subsample is an
  exact index selection.
* ``zoom_in_flow``: Catmull-Rom at half-pixel-offset positions, divided by
  the scale factor (:450-466).  The separable interpolation matrices are
  built on the device from their taps and weights and applied with
  ``torch.matmul`` (keep TF32 off on the card:
  ``torch.backends.cuda.matmul.allow_tf32`` is False by default).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from octane_tpu_torch.core.gaussian import (blur_separable, gaussian_kernel_1d,
                                            solver_filtsize)


def zoom_size(n: int, factor: float) -> int:
    """Round-half-up size rule: int(n*factor + 0.5) (oct_zoom.cc:12-16)."""
    return int(float(n) * factor + 0.5)


def _weights_sigma(factor: float) -> float:
    """Downsampling Gaussian sigma 0.6*sqrt(1/f^2 - 1) (oct_zoom.cc:31)."""
    return 0.6 * math.sqrt(1.0 / (factor * factor) - 1.0)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device``, without a stream sync on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _catmull_taps(n_in: int, positions: np.ndarray):
    """(n_out, 4) tap indices and float32 weights for static positions.

    Tap indices are truncated and clamped independently; the weights are
    evaluated with numpy float32 scalar arithmetic, as octane_tpu does (a
    scalar ``x ** 3`` rounds differently from any array form), once per
    distinct fraction.
    """
    p = np.asarray(positions, np.float32)
    taps = np.stack([np.clip(np.trunc(p + np.float32(o)), 0, n_in - 1)
                     for o in (-1, 0, 1, 2)], axis=1).astype(np.int64)
    frac = p - taps[:, 1].astype(np.float32)
    uniq, inverse = np.unique(frac, return_inverse=True)
    table = np.empty((len(uniq), 4), np.float32)
    for r, x in enumerate(uniq):
        x = np.float32(x)
        table[r] = (0.5 * (-x + 2 * x * x - x ** 3),
                    1.0 - 2.5 * x * x + 1.5 * x ** 3,
                    0.5 * (x + 4 * x * x - 3 * x ** 3),
                    0.5 * (-x * x + x ** 3))
    return taps, table[inverse.reshape(-1)]


def _catmull_matrix_1d(n_in: int, positions: np.ndarray, device="cpu") -> torch.Tensor:
    """(n_out, n_in) float32 Catmull-Rom matrix on ``device``; taps that
    clamp onto the same sample accumulate their weights in tap order."""
    taps, wgts = _catmull_taps(n_in, positions)
    taps, wgts = _upload(taps, device), _upload(wgts, device)
    cols = torch.arange(n_in, device=device)[None, :]
    m = torch.zeros((len(positions), n_in), dtype=torch.float32, device=device)
    for o in range(4):
        m = m + torch.where(cols == taps[:, o:o + 1], wgts[:, o:o + 1], 0.0)
    return m


def pyramid_downsample(img: torch.Tensor, factor: float) -> torch.Tensor:
    """Solver-path downsample of a full-resolution (..., H, W) image."""
    h, w = img.shape[-2], img.shape[-1]
    nxx, nyy = zoom_size(w, factor), zoom_size(h, factor)
    fs = solver_filtsize(factor)
    blurred = blur_separable(img, gaussian_kernel_1d(_weights_sigma(factor), fs), fs)

    def idx(n_out, n_in):
        # float32 division + trunc, like the CUDA integer cast
        pos = torch.arange(n_out, dtype=torch.float32, device=img.device)
        return torch.trunc(pos / float(np.float32(factor))).long().clamp_(0, n_in - 1)

    return blurred.index_select(-2, idx(nyy, h)).index_select(-1, idx(nxx, w))


def zoom_in_flow(flow: torch.Tensor, new_hw, scale_factor: float) -> torch.Tensor:
    """Upsample a (..., h, w) flow field to ``new_hw`` and rescale it."""
    nyy, nxx = new_hw
    h, w = flow.shape[-2], flow.shape[-1]
    fx = np.float32(nxx) / np.float32(w)
    fy = np.float32(nyy) / np.float32(h)
    i2 = (np.arange(nxx, dtype=np.float32) / fx) - (
        np.float32(0.5) - np.float32(0.5) / fx)
    j2 = (np.arange(nyy, dtype=np.float32) / fy) - (
        np.float32(0.5) - np.float32(0.5) / fy)
    ry = _catmull_matrix_1d(h, j2, flow.device)
    rx = _catmull_matrix_1d(w, i2, flow.device)
    out = torch.matmul(torch.matmul(ry, flow), rx.T)
    return out / float(np.float32(scale_factor))
