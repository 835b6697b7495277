"""The fused Euler-Lagrange assembly of the SOR path: CUDA kernel and plain
version.

``assemble_cf(samples, bc_x, bc_y, g1s, u, v, uhat, vhat, al1, lambdac,
alpha, lam_a, dozim)`` builds the linearised system of one GNC round from
the warp's outputs (``samples``, the (6C, H, W) warped [geo2, gx2, gy2,
gxx, gxy, gyy]; ``bc_x``/``bc_y``, its clamp flags), the level stack
``g1s`` = [geo1, gx1, gy1] (3C, H, W), the flow (u, v) and the hint fields,
and returns (cf, partials): the SOR coefficient stack of ``ops.sor.build_cf``
(6 planes in the quadratic step al1 == 1, else 10) and the partials of
||b||^2, one per 32 x 8 block in the kernels' summation order
(``ops.pcg.block_partials``).  On a CUDA tensor it launches
``csrc/assemble.cu`` (the port of ``_kernel`` of
octane_tpu/ops/pallas/assemble.py); on a CPU tensor it runs
``assemble_cf_plain``: flow.stencil.assemble_samples, then build_cf.  The
kernel follows the plain version op for op, so the two agree bit for bit.
``assemble_cf.launches`` / ``.plain_calls`` count them.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.ops.build import check_status, load_kernels
from octane_tpu_torch.ops.pcg import block_partials, num_partials
from octane_tpu_torch.ops.sor import build_cf


def assemble_cf_plain(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                      al1: float, lambdac: float, alpha: float, lam_a: float,
                      dozim: bool):
    """Plain version: (cf, block partials of ||b||^2)."""
    from octane_tpu_torch.flow.stencil import assemble_samples

    c = g1s.shape[0] // 3
    sysm = assemble_samples(samples, bc_x, bc_y, g1s[:c], g1s[c:2 * c], g1s[2 * c:],
                            u, v, uhat, vhat, al1, alpha, lam_a, lambdac, dozim)
    return build_cf(sysm), block_partials(sysm.bu * sysm.bu + sysm.bv * sysm.bv)


def _check(g1s, samples, bc_x, bc_y, fields):
    if g1s.dim() != 3 or g1s.shape[0] not in (3, 6, 9):
        raise ValueError(f"assemble_cf: g1s must be (3C, h, w) with C <= 3, "
                         f"got {tuple(g1s.shape)}")
    c, hw = g1s.shape[0] // 3, tuple(g1s.shape[1:])
    if min(hw) < 2:
        raise ValueError("assemble_cf: the grid needs at least 2 rows and 2 columns")
    wanted = [(g1s, (3 * c, *hw), torch.float32), (samples, (6 * c, *hw), torch.float32),
              (bc_x, hw, torch.bool), (bc_y, hw, torch.bool)]
    for t, shape, dtype in wanted + [(t, hw, torch.float32) for t in fields]:
        if tuple(t.shape) != shape:
            raise ValueError(f"assemble_cf: expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"assemble_cf: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.device != g1s.device:
            raise ValueError("assemble_cf: inputs must be contiguous and on one device")
    if g1s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"assemble_cf: unsupported device {g1s.device}")


def assemble_cf(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                al1: float, lambdac: float, alpha: float, lam_a: float,
                dozim: bool = True):
    """(cf, partials); see the module docstring."""
    _check(g1s, samples, bc_x, bc_y, (u, v, uhat, vhat))
    if g1s.device.type == "cpu":
        assemble_cf.plain_calls += 1
        return assemble_cf_plain(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                                 al1, lambdac, alpha, lam_a, dozim)
    lib = load_kernels()
    c3, h, w = g1s.shape
    quad = float(al1) == 1.0
    cf = torch.empty((6 if quad else 10, h, w), dtype=torch.float32, device=g1s.device)
    partials = torch.empty(num_partials(h, w), dtype=torch.float32, device=g1s.device)
    # PyTorch's CUDA division by a Python scalar multiplies by the float
    # reciprocal; the kernel does the same with this one
    inv_alpha = float(np.float32(1.0) / np.float32(alpha))
    with torch.cuda.device(g1s.device):
        status = lib.octane_assemble_cf(
            g1s.data_ptr(), samples.data_ptr(), bc_x.data_ptr(), bc_y.data_ptr(),
            u.data_ptr(), v.data_ptr(), uhat.data_ptr(), vhat.data_ptr(),
            cf.data_ptr(), partials.data_ptr(), c3 // 3, h, w, int(quad), int(dozim),
            al1, 1.0 - al1, lambdac, inv_alpha, lam_a,
            torch.cuda.current_stream(g1s.device).cuda_stream)
    check_status(status, "octane_assemble_cf")
    assemble_cf.launches += 1
    return cf, partials


assemble_cf.launches = 0
assemble_cf.plain_calls = 0
