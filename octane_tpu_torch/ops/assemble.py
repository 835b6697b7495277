"""The fused Euler-Lagrange assembly of one GNC round: CUDA kernel and plain
versions, in the SOR path's layout and the PCG path's.

``assemble_cf(samples, bc_x, bc_y, g1s, u, v, uhat, vhat, al1, lambdac,
alpha, lam_a, dozim)`` builds the linearised system of one GNC round from
the warp's outputs (``samples``, the (6C, H, W) warped [geo2, gx2, gy2,
gxx, gxy, gyy]; ``bc_x``/``bc_y``, its clamp flags), the level stack
``g1s`` = [geo1, gx1, gy1] (3C, H, W), the flow (u, v) and the hint fields,
and returns (cf, partials): the SOR coefficient stack of ``ops.sor.build_cf``
(6 planes in the quadratic step al1 == 1, else 10) and the partials of
||b||^2, one per 32 x 8 block in the kernels' summation order
(``ops.pcg.block_partials``).  On a CUDA tensor it launches
``assemble_cf`` of ``csrc/assemble.cu`` (the port of ``_kernel`` of
octane_tpu/ops/pallas/assemble.py); on a CPU tensor it runs
``assemble_cf_plain``: flow.stencil.assemble_samples, then build_cf.

``assemble_pcg(..., dozim, rows=None)`` takes the same inputs and returns
the PCG round's system (cf, b, partials): cf the (3 | 7, R, W) stack
[a1, a4, a2(, a5, a6, a7, a8)] of ``ops.pcg.pcg_solve_fused``, b the
(2, R, W) [bu, bv] and the (n, 3) first-sum partials of
``ops.pcg.initial_partials``, for the rows ``rows`` = (r_begin, r_end) of
the inputs (default: all of them), partials in blocks from r_begin.  The
inputs are a slab whose edges take the mirror-at-1 neighbours, so a band
passes its rows and the stencil's ghost rows and asks for its own.  On a
CUDA tensor it launches ``assemble_pcg`` of ``csrc/assemble.cu`` (the
counterpart of the XLA-fused assembly of octane_tpu's PCG round,
flow/variational.py:78-103); on a CPU tensor ``assemble_pcg_plain``:
assemble_samples, ``ops.pcg.stack_system`` of the rows, then
initial_partials.

The kernels follow the plain versions op for op, so they agree bit for
bit.  ``.launches`` / ``.plain_calls`` on each wrapper count them.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.ops.build import check_status, load_kernels
from octane_tpu_torch.ops.pcg import block_partials, initial_partials, num_partials, stack_system
from octane_tpu_torch.ops.sor import build_cf


def _system(samples, bc_x, bc_y, g1s, u, v, uhat, vhat, al1, lambdac, alpha, lam_a, dozim):
    """flow.stencil.assemble_samples on the wrappers' inputs."""
    from octane_tpu_torch.flow.stencil import assemble_samples

    c = g1s.shape[0] // 3
    return assemble_samples(samples, bc_x, bc_y, g1s[:c], g1s[c:2 * c], g1s[2 * c:],
                            u, v, uhat, vhat, al1, alpha, lam_a, lambdac, dozim)


def assemble_cf_plain(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                      al1: float, lambdac: float, alpha: float, lam_a: float,
                      dozim: bool):
    """Plain version: (cf, block partials of ||b||^2)."""
    sysm = _system(samples, bc_x, bc_y, g1s, u, v, uhat, vhat, al1, lambdac, alpha, lam_a,
                   dozim)
    return build_cf(sysm), block_partials(sysm.bu * sysm.bu + sysm.bv * sysm.bv)


def assemble_pcg_plain(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                       al1: float, lambdac: float, alpha: float, lam_a: float,
                       dozim: bool, rows=None):
    """Plain version: (cf, b, (n, 3) first-sum partials) of ``rows``."""
    sysm = _system(samples, bc_x, bc_y, g1s, u, v, uhat, vhat, al1, lambdac, alpha, lam_a,
                   dozim)
    cf, b = stack_system(sysm, slice(*_rows(rows, u.shape[0])))
    return cf, b, initial_partials(cf, b)


def _rows(rows, h: int):
    """(r_begin, r_end) of ``rows``, all ``h`` rows for None."""
    r0, r1 = (0, h) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 < r1 <= h:
        raise ValueError(f"assemble_pcg: rows [{r0}, {r1}) do not fit {h} rows")
    return r0, r1


def _check(name, g1s, samples, bc_x, bc_y, fields):
    if g1s.dim() != 3 or g1s.shape[0] not in (3, 6, 9):
        raise ValueError(f"{name}: g1s must be (3C, h, w) with C <= 3, "
                         f"got {tuple(g1s.shape)}")
    c, hw = g1s.shape[0] // 3, tuple(g1s.shape[1:])
    if min(hw) < 2:
        raise ValueError(f"{name}: the grid needs at least 2 rows and 2 columns")
    wanted = [(g1s, (3 * c, *hw), torch.float32), (samples, (6 * c, *hw), torch.float32),
              (bc_x, hw, torch.bool), (bc_y, hw, torch.bool)]
    for t, shape, dtype in wanted + [(t, hw, torch.float32) for t in fields]:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.device != g1s.device:
            raise ValueError(f"{name}: inputs must be contiguous and on one device")
    if g1s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {g1s.device}")


def _inv_alpha(alpha: float) -> float:
    """PyTorch's CUDA division by a Python scalar multiplies by the float
    reciprocal; the kernels do the same with this one."""
    return float(np.float32(1.0) / np.float32(alpha))


def assemble_cf(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                al1: float, lambdac: float, alpha: float, lam_a: float,
                dozim: bool = True):
    """(cf, partials); see the module docstring."""
    _check("assemble_cf", g1s, samples, bc_x, bc_y, (u, v, uhat, vhat))
    if g1s.device.type == "cpu":
        assemble_cf.plain_calls += 1
        return assemble_cf_plain(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                                 al1, lambdac, alpha, lam_a, dozim)
    lib = load_kernels()
    c3, h, w = g1s.shape
    quad = float(al1) == 1.0
    cf = torch.empty((6 if quad else 10, h, w), dtype=torch.float32, device=g1s.device)
    partials = torch.empty(num_partials(h, w), dtype=torch.float32, device=g1s.device)
    with torch.cuda.device(g1s.device):
        status = lib.octane_assemble_cf(
            g1s.data_ptr(), samples.data_ptr(), bc_x.data_ptr(), bc_y.data_ptr(),
            u.data_ptr(), v.data_ptr(), uhat.data_ptr(), vhat.data_ptr(),
            cf.data_ptr(), partials.data_ptr(), c3 // 3, h, w, int(quad), int(dozim),
            al1, 1.0 - al1, lambdac, _inv_alpha(alpha), lam_a,
            torch.cuda.current_stream(g1s.device).cuda_stream)
    check_status(status, "octane_assemble_cf")
    assemble_cf.launches += 1
    return cf, partials


def assemble_pcg(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                 al1: float, lambdac: float, alpha: float, lam_a: float,
                 dozim: bool = True, rows=None):
    """(cf, b, partials) of the rows ``rows``; see the module docstring."""
    _check("assemble_pcg", g1s, samples, bc_x, bc_y, (u, v, uhat, vhat))
    c3, h, w = g1s.shape
    r0, r1 = _rows(rows, h)
    if g1s.device.type == "cpu":
        assemble_pcg.plain_calls += 1
        return assemble_pcg_plain(samples, bc_x, bc_y, g1s, u, v, uhat, vhat,
                                  al1, lambdac, alpha, lam_a, dozim, (r0, r1))
    lib = load_kernels()
    quad = float(al1) == 1.0
    cf = torch.empty((3 if quad else 7, r1 - r0, w), dtype=torch.float32, device=g1s.device)
    b = torch.empty((2, r1 - r0, w), dtype=torch.float32, device=g1s.device)
    partials = torch.empty((num_partials(r1 - r0, w), 3), dtype=torch.float32,
                           device=g1s.device)
    with torch.cuda.device(g1s.device):
        status = lib.octane_assemble_pcg(
            g1s.data_ptr(), samples.data_ptr(), bc_x.data_ptr(), bc_y.data_ptr(),
            u.data_ptr(), v.data_ptr(), uhat.data_ptr(), vhat.data_ptr(),
            cf.data_ptr(), b.data_ptr(), partials.data_ptr(), c3 // 3, h, w, r0, r1,
            int(quad), int(dozim), al1, 1.0 - al1, lambdac, _inv_alpha(alpha), lam_a,
            torch.cuda.current_stream(g1s.device).cuda_stream)
    check_status(status, "octane_assemble_pcg")
    assemble_pcg.launches += 1
    return cf, b, partials


for _fn in (assemble_cf, assemble_pcg):
    _fn.launches = 0
    _fn.plain_calls = 0
