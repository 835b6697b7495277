"""Catmull-Rom bicubic sampling (counterpart of octane_tpu.core.interp).

Index casts truncate toward zero like C's ``(int)``, and every tap index
is clamped to [0, n-1] independently (oct_bicubic.cc:36-96).
"""

from __future__ import annotations

import torch


def catmull_rom_cell(v0, v1, v2, v3, x):
    """1-D cubic convolution (oct_bicubic.cc:10-18)."""
    return v1 + 0.5 * x * (
        v2 - v0 + x * (2.0 * v0 - 5.0 * v1 + 4.0 * v2 - v3
                       + x * (3.0 * (v1 - v2) + v3 - v0))
    )


def bicubic_sample(img: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Bicubic interpolation of (..., H, W) ``img`` at real positions (x, y);
    the fraction is measured from the clamped integer base."""
    h, w = img.shape[-2], img.shape[-1]
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xi = [torch.trunc(x + o).to(torch.int64).clamp_(0, w - 1)
          for o in (-1, 0, 1, 2)]
    yi = [torch.trunc(y + o).to(torch.int64).clamp_(0, h - 1)
          for o in (-1, 0, 1, 2)]
    fx = x - xi[1].to(torch.float32)
    fy = y - yi[1].to(torch.float32)
    flat = img.reshape(img.shape[:-2] + (-1,))

    def gather(ix, iy):
        idx = (iy * w + ix).reshape(-1)
        return flat.index_select(-1, idx).reshape(img.shape[:-2] + x.shape)

    cols = []
    for c in range(4):
        taps = [gather(xi[c], yi[r]) for r in range(4)]
        cols.append(catmull_rom_cell(*taps, fy))
    return catmull_rom_cell(*cols, fx)
