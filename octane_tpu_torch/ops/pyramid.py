"""One level of the solver pyramid: CUDA kernel and plain version.

``pyramid_level(img, s0, h, factor, rows)`` is level rows [a, b) of
``core.zoom.pyramid_downsample`` of an h-row image, from ``img``, a
contiguous float32 (N, Hs, W) stack of its rows [s0, s0 + Hs) (the whole
image, or a band's slab holding at least ``core.zoom.pyramid_rows``'): the
blur with the pyramid's Gaussian of ``factor`` (fs =
``solver_filtsize(factor)``, clamped to ``img``'s own rows and columns),
then the rows and columns at (trunc(j / f), trunc(i / f)).

On a CUDA tensor it launches ``csrc/pyramid.cu``, one launch for the N
planes, which computes only the kept pixels from the pyramid's indices
(``core.zoom.pyramid_index``, built here on the device); octane_tpu has no
Pallas kernel here (its ``core/zoom.py`` pyramid is plain XLA).  On a CPU
tensor it runs ``pyramid_level_plain``, which is
``core.zoom.pyramid_downsample_rows``, whose bits the kernel repeats.
``pyramid_level.launches`` / ``.plain_calls`` count them.  The weights
reach the kernel as launch parameters, so a captured solve uploads
nothing.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from octane_tpu_torch.core.gaussian import gaussian_kernel_1d, solver_filtsize
from octane_tpu_torch.core.zoom import (pyramid_downsample_rows, pyramid_index, pyramid_rows,
                                        weights_sigma, zoom_size)
from octane_tpu_torch.ops.build import check_status, load_kernels

MAX_TAPS = 128          # 2 fs that the kernel's parameters hold (csrc/pyramid.cu kMaxTaps)
MAX_ROWS = 32           # output rows of a tile (kMaxRows)
PITCH = 33              # words of horizontal sums a staged row (kHPitch)
SMEM_BYTES = 16 * 1024  # a tile's shared memory

# the plain version: the blur of every pixel, then the kept rows and columns
pyramid_level_plain = pyramid_downsample_rows


def pyramid_taps(factor: float):
    """(fs, the 2 fs float32 weights of taps -fs .. fs - 1) of a level."""
    fs = solver_filtsize(factor)
    return fs, gaussian_kernel_1d(weights_sigma(factor), fs)[:2 * fs]


def row_step(factor: float) -> int:
    """The most source rows between two neighbouring level rows'
    (trunc(j / f) in float32): 1 / f where f is a power of two, whose
    division is exact, else ceil(1 / f) + 1 for the division's rounding."""
    inv = 1.0 / float(np.float32(factor))
    return math.ceil(inv) + (inv != math.ceil(inv))


def tiling(fs: int, factor: float):
    """(output rows a tile, source rows it stages): the most rows, at most
    32, whose sources, from the first row's window to the last's (at most
    2 fs + (rows - 1) ``row_step``), fit ``SMEM_BYTES`` of horizontal
    sums."""
    step = row_step(factor)
    rows = MAX_ROWS
    while rows > 1 and 4 * PITCH * (2 * fs + (rows - 1) * step) > SMEM_BYTES:
        rows -= 1
    return rows, 2 * fs + (rows - 1) * step


def _check(img, s0, h, factor, rows) -> int:
    if img.dim() != 3 or min(img.shape[1:]) < 1:
        raise ValueError(f"pyramid_level: an image of shape {tuple(img.shape)} is not "
                         "(N, Hs, W) with rows and columns")
    if img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError(f"pyramid_level: the image must be contiguous float32, got "
                         f"{img.dtype}{'' if img.is_contiguous() else ', not contiguous'}")
    if not 0.0 < factor < 1.0:
        raise ValueError(f"pyramid_level: factor {factor} is not in (0, 1)")
    fs = solver_filtsize(factor)
    if 2 * fs > MAX_TAPS:
        raise ValueError(f"pyramid_level: factor {factor} needs {2 * fs} taps, more than the "
                         f"kernel's {MAX_TAPS}")
    a, b = rows
    if not 0 <= a <= b <= zoom_size(h, factor):
        raise ValueError(f"pyramid_level: rows {tuple(rows)} are not level rows of an image "
                         f"of {h} rows at factor {factor}")
    if a < b:
        r0, r1 = pyramid_rows(h, factor, rows)
        if not 0 <= s0 <= r0 or s0 + img.shape[1] < r1:
            raise ValueError(f"pyramid_level: image rows [{s0}, {s0 + img.shape[1]}) do not "
                             f"hold [{r0}, {r1}), the rows that level rows {tuple(rows)} read")
    return fs


def pyramid_level(img: torch.Tensor, s0: int, h: int, factor: float, rows) -> torch.Tensor:
    """The (N, b - a, zoom_size(W, factor)) level rows; see the module
    docstring."""
    fs = _check(img, s0, h, factor, rows)
    if img.device.type == "cpu":
        pyramid_level.plain_calls += 1
        return pyramid_level_plain(img, s0, h, factor, rows)
    if img.device.type != "cuda":
        raise ValueError(f"pyramid_level: unsupported device {img.device}")
    n, hs, w = img.shape
    ridx = pyramid_index(*rows, h, factor, img.device)
    if s0:
        ridx -= s0
    cidx = pyramid_index(0, zoom_size(w, factor), w, factor, img.device)
    ho, wo = ridx.numel(), cidx.numel()
    out = torch.empty((n, ho, wo), dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    _, taps = pyramid_taps(factor)
    weights = (ctypes.c_float * len(taps))(*taps.tolist())
    tile_rows, cap = tiling(fs, factor)
    lib = load_kernels()
    with torch.cuda.device(img.device):
        status = lib.octane_pyramid_level(
            img.data_ptr(), ridx.data_ptr(), cidx.data_ptr(), out.data_ptr(), n, hs, w, ho, wo,
            fs, ctypes.addressof(weights), tile_rows, cap,
            torch.cuda.current_stream(img.device).cuda_stream)
    check_status(status, "octane_pyramid_level")
    pyramid_level.launches += 1
    return out


pyramid_level.launches = 0
pyramid_level.plain_calls = 0


__all__ = ["pyramid_level", "pyramid_level_plain", "pyramid_taps", "row_step", "tiling",
           "MAX_TAPS"]
