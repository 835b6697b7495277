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
* ``pyramid_rows`` / ``pyramid_downsample_rows`` and ``flow_rows`` /
  ``zoom_in_flow_rows``: the same two solver resamplings for output rows
  [a, b) only, from the input rows they read (the row-banded mesh path);
  the pyramid's rows equal the whole call's bit for bit.
* ``zoom_in_image`` / ``zoom_out_image``: the ingest regrids (CTH onto
  the image grid): bicubic (or nearest) at half-pixel-offset positions,
  and blur + bicubic at ii/factor (oct_zoom.cc:51-88, 180-222).  Positions
  are computed in numpy float32 exactly as octane_tpu computes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from octane_tpu_torch.core.gaussian import (blur_separable, gaussian_kernel_1d,
                                            ingest_filtsize, solver_filtsize)
from octane_tpu_torch.core.interp import bicubic_sample


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


def _half_pixel_positions(n_out: int, n_in: int) -> np.ndarray:
    """float32 source positions ii/f - (0.5 - 0.5/f), f = n_out/n_in, of a
    zoom in (oct_zoom.cc:190-196)."""
    f = np.float32(n_out) / np.float32(n_in)
    return (np.arange(n_out, dtype=np.float32) / f) - (np.float32(0.5) - np.float32(0.5) / f)


def _bicubic_grid(img: torch.Tensor, xs: np.ndarray, ys: np.ndarray) -> torch.Tensor:
    """Bicubic samples of (..., H, W) ``img`` at every (ys[r], xs[c])."""
    x = _upload(xs, img.device)[None, :].expand(len(ys), len(xs))
    y = _upload(ys, img.device)[:, None].expand(len(ys), len(xs))
    return bicubic_sample(img, x, y)


def zoom_out_image(img: torch.Tensor, factor: float) -> torch.Tensor:
    """Ingest zoom out of (..., H, W) by ``factor`` < 1: Gaussian blur, then
    bicubic at the real positions ii/factor (oct_zoom_out_float)."""
    h, w = img.shape[-2], img.shape[-1]
    if factor >= 0.999999:
        return img
    nxx, nyy = zoom_size(w, factor), zoom_size(h, factor)
    sigma = _weights_sigma(factor)
    fs = ingest_filtsize(sigma)
    blurred = blur_separable(img, gaussian_kernel_1d(sigma, fs), fs)
    i2 = (np.arange(nxx, dtype=np.float64) / factor).astype(np.float32)
    j2 = (np.arange(nyy, dtype=np.float64) / factor).astype(np.float32)
    return _bicubic_grid(blurred, i2, j2)


def zoom_in_image(img: torch.Tensor, new_hw, bicubic: bool = True) -> torch.Tensor:
    """Ingest zoom in of (..., H, W) to ``new_hw`` at half-pixel-offset
    positions: bicubic, or nearest (CTH with -nncth) (oct_zoom_in_float)."""
    nyy, nxx = new_hw
    h, w = img.shape[-2], img.shape[-1]
    i2, j2 = _half_pixel_positions(nxx, w), _half_pixel_positions(nyy, h)
    if bicubic:
        return _bicubic_grid(img, i2, j2)
    i3 = np.clip((i2 + 0.5).astype(np.int32), 0, w - 1).astype(np.int64)
    j3 = np.clip((j2 + 0.5).astype(np.int32), 0, h - 1).astype(np.int64)
    return img.index_select(-2, _upload(j3, img.device)).index_select(
        -1, _upload(i3, img.device))


def zoom_out_image_rows(read_rows, h_in: int, w_in: int, factor: float, rows,
                       device="cpu") -> torch.Tensor:
    """Output rows [r0, r1) of ``zoom_out_image`` of an (h_in, w_in) source
    known through ``read_rows(s0, s1)``, its rows [s0, s1) as a tensor or
    array (moved to ``device``).  Reads the rows the bicubic taps (+-2) and
    the blur (+-filtsize) reach, so the blur's clamp acts only where the
    block's edge is the source's; the positions are sliced from the whole
    grid's, so the rows equal the whole call's bit for bit."""
    r0, r1 = rows
    if factor >= 0.999999:
        return torch.as_tensor(read_rows(r0, r1), device=device)
    nxx, nyy = zoom_size(w_in, factor), zoom_size(h_in, factor)
    sigma = _weights_sigma(factor)
    fs = ingest_filtsize(sigma)
    j2 = (np.arange(nyy, dtype=np.float64) / factor).astype(np.float32)[r0:r1]
    s0 = max(0, int(np.floor(float(j2.min()))) - 2 - fs)
    s1 = min(h_in, int(np.ceil(float(j2.max()))) + 3 + fs)
    blk = torch.as_tensor(read_rows(s0, s1), device=device)
    blurred = blur_separable(blk, gaussian_kernel_1d(sigma, fs), fs)
    i2 = (np.arange(nxx, dtype=np.float64) / factor).astype(np.float32)
    return _bicubic_grid(blurred, i2, j2 - np.float32(s0))


def zoom_in_image_rows(read_rows, h_in: int, w_in: int, new_hw, rows, bicubic: bool = True,
                       device="cpu") -> torch.Tensor:
    """Output rows [r0, r1) of ``zoom_in_image`` (see zoom_out_image_rows;
    the rows read are those of the bicubic taps, -1 .. +2)."""
    nyy, nxx = new_hw
    r0, r1 = rows
    i2 = _half_pixel_positions(nxx, w_in)
    j2 = _half_pixel_positions(nyy, h_in)[r0:r1]
    s0 = max(0, int(np.floor(float(j2.min()))) - 2)
    s1 = min(h_in, int(np.floor(float(j2.max()))) + 4)
    blk = torch.as_tensor(read_rows(s0, s1), device=device)
    if bicubic:
        return _bicubic_grid(blk, i2, j2 - np.float32(s0))
    i3 = np.clip((i2 + 0.5).astype(np.int32), 0, w_in - 1).astype(np.int64)
    j3 = np.clip((j2 + 0.5).astype(np.int32), 0, h_in - 1).astype(np.int64) - s0
    return blk.index_select(-2, _upload(j3, blk.device)).index_select(
        -1, _upload(i3, blk.device))


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


def _pyramid_index(a: int, b: int, n_in: int, factor: float, device="cpu") -> torch.Tensor:
    """Source rows of output rows [a, b): float32 division + trunc, like the
    CUDA integer cast."""
    pos = torch.arange(a, b, dtype=torch.float32, device=device)
    return torch.trunc(pos / float(np.float32(factor))).long().clamp_(0, n_in - 1)


def pyramid_rows(h: int, factor: float, rows):
    """[s0, s1): the full-resolution rows that level rows [a, b) of
    ``pyramid_downsample`` read (their blur taps [-filtsize, filtsize))."""
    fs = solver_filtsize(factor)
    idx = _pyramid_index(*rows, h, factor)
    return max(0, int(idx[0]) - fs), min(h, int(idx[-1]) + fs)


def pyramid_downsample_rows(img: torch.Tensor, s0: int, h: int, factor: float,
                            rows) -> torch.Tensor:
    """Level rows [a, b) of ``pyramid_downsample`` of an h-row image, from
    ``img``, its rows [s0, s0 + n) (at least ``pyramid_rows``'): equal to the
    whole call's rows bit for bit (the blur clamps only where the slab's
    edge is the image's)."""
    w = img.shape[-1]
    nxx = zoom_size(w, factor)
    fs = solver_filtsize(factor)
    blurred = blur_separable(img, gaussian_kernel_1d(_weights_sigma(factor), fs), fs)
    ridx = _pyramid_index(*rows, h, factor, img.device) - s0
    return blurred.index_select(-2, ridx).index_select(
        -1, _pyramid_index(0, nxx, w, factor, img.device))


def flow_rows(h_in: int, n_out: int, rows):
    """[c0, c1): the coarse rows that rows [a, b) of ``zoom_in_flow`` to
    n_out rows read (their four Catmull-Rom taps)."""
    taps, _ = _catmull_taps(h_in, _half_pixel_positions(n_out, h_in)[rows[0]:rows[1]])
    return int(taps.min()), int(taps.max()) + 1


def zoom_in_flow_rows(flow: torch.Tensor, c0: int, h_in: int, new_hw, rows,
                      scale_factor: float) -> torch.Tensor:
    """Rows [a, b) of ``zoom_in_flow`` of an h_in-row field to ``new_hw``,
    from ``flow``, its rows [c0, c0 + n) (at least ``flow_rows``'); the
    products sum the same taps, in another order than the whole matrix
    product may (float round-off)."""
    nyy, nxx = new_hw
    w = flow.shape[-1]
    j2 = _half_pixel_positions(nyy, h_in)[rows[0]:rows[1]]
    ry = _catmull_matrix_1d(h_in, j2, flow.device)[:, c0:c0 + flow.shape[-2]]
    rx = _catmull_matrix_1d(w, _half_pixel_positions(nxx, w), flow.device)
    out = torch.matmul(torch.matmul(ry, flow), rx.T)
    return out / float(np.float32(scale_factor))


def zoom_in_flow(flow: torch.Tensor, new_hw, scale_factor: float) -> torch.Tensor:
    """Upsample a (..., h, w) flow field to ``new_hw`` and rescale it."""
    nyy, nxx = new_hw
    h, w = flow.shape[-2], flow.shape[-1]
    i2, j2 = _half_pixel_positions(nxx, w), _half_pixel_positions(nyy, h)
    ry = _catmull_matrix_1d(h, j2, flow.device)
    rx = _catmull_matrix_1d(w, i2, flow.device)
    out = torch.matmul(torch.matmul(ry, flow), rx.T)
    return out / float(np.float32(scale_factor))
