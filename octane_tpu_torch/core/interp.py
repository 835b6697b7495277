"""Bilinear and Catmull-Rom bicubic sampling (counterpart of
octane_tpu.core.interp).

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


def bilinear_sample(img: torch.Tensor, x, y) -> torch.Tensor:
    """Bilinear interpolation of (..., H, W) ``img`` at real positions
    (x, y), the solver's warp lookup (oct_variational_optical_flow.cu:
    732-761): a position below 0 clamps to 0 and one at or past n to n - 1
    (values in (n - 1, n) pass through), and the cell origin is clamped to
    n - 2 so all four corners are in range."""
    h, w = img.shape[-2], img.shape[-1]
    x = torch.as_tensor(x, dtype=torch.float32, device=img.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=img.device)
    x = torch.where(x < 0.0, 0.0, torch.where(x >= w, float(w - 1), x))
    y = torch.where(y < 0.0, 0.0, torch.where(y >= h, float(h - 1), y))
    x0 = torch.trunc(x).to(torch.int64).clamp_(max=w - 2)
    y0 = torch.trunc(y).to(torch.int64).clamp_(max=h - 2)
    p1 = (x0 + 1).to(torch.float32) - x
    p2 = x - x0.to(torch.float32)
    p3 = (y0 + 1).to(torch.float32) - y
    p4 = y - y0.to(torch.float32)
    flat = img.reshape(img.shape[:-2] + (-1,))

    def gather(ix, iy):
        idx = (iy * w + ix).reshape(-1)
        return flat.index_select(-1, idx).reshape(img.shape[:-2] + x.shape)

    f11, f21 = gather(x0, y0), gather(x0 + 1, y0)
    f12, f22 = gather(x0, y0 + 1), gather(x0 + 1, y0 + 1)
    return p3 * (p1 * f11 + p2 * f21) + p4 * (p1 * f12 + p2 * f22)
