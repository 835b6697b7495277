"""Cross-bilateral flow smoothing, "SRSAL" (counterpart of
octane_tpu.post.srsal; oct_srsal_cuda.cu:34-82).

A (2p+1)^2 spatial Gaussian (filtsigma 9, p = 2 * filtsigma = 18: 37 x 37
taps) times a cloud-top-height range kernel exp(-dCTH^2 / (2 * 20^2)),
applied to (u, v) with the reference's mixed reflect boundary (left:
reflect without edge repeat, right: symmetric with edge repeat).  The work
is the kernel wrapper ``ops.bilateral.bilateral``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from octane_tpu_torch.core.gaussian import gaussian_kernel_1d
from octane_tpu_torch.ops.bilateral import bilateral


def srsal_smooth(u: torch.Tensor, v: torch.Tensor, cth: torch.Tensor,
                 filtsigma: float = 9.0,
                 sigpix: float = 20.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilateral smooth of (u, v) guided by ``cth``; returns (u_s, v_s).

    The fields are (H, W) on one device, with H, W >= p + 1 (ValueError
    otherwise: the reflect boundary would need a second reflection)."""
    p = int(2 * filtsigma)
    gk = gaussian_kernel_1d(filtsigma, p)
    sigpix2 = -1.0 / (2.0 * sigpix * sigpix)

    def f32(t):
        return t.to(torch.float32).contiguous()

    out = bilateral(f32(u), f32(v), f32(cth), gk, sigpix2)
    return out[0], out[1]
