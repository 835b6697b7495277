"""Jacobi-PCG iteration passes: CUDA kernels, plain versions and the driver.

One PCG iteration is two passes (the port of ``_pass_a``/``_pass_b`` of
octane_tpu/ops/pallas/cg.py):

* ``pcg_pass_a(x, r, p, cf, ab)``: x += alpha_prev p (lagged); p' = M^-1 r
  + beta p; ap = A p' with the mirror-at-1 edges; partials of <p', ap>;
* ``pcg_pass_b(r, ap, cf, alpha)``: r -= alpha ap; partials of <r, M^-1 r>
  and <r, r>.

x, r, p, ap are (2, h, w) float32 (u then v); ``cf`` is (3, h, w)
[a1, a4, a2] for the quadratic GNC step (off-diagonals are the scalar -1)
or (7, h, w) [a1, a4, a2, a5, a6, a7, a8]; ``ab`` = [alpha_prev, beta] and
``alpha`` stay on the device.  The partials are one per 32 x 8 block of
pixels, in the kernels' summation order (``block_partials``), so the plain
versions give the kernels' results bit for bit; the driver sums them with
``torch.sum``.

On a CUDA tensor a pass launches ``csrc/pcg.cu``; on a CPU tensor it runs
the plain version in this module.  ``pcg_pass_a.launches`` /
``.plain_calls`` (and the same on ``pcg_pass_b``) count them.

``pcg_pass_a_band(x, r, p, cf, ab, gr, gp, gd, row0, true_h)`` is pass A's
band form for the mesh path (parallel.cg): x, r, p, cf are the band's rows
[row0, row0 + hb) of a true_h-row image, and gr, gp, gd (2, 2, w) hold r,
p and the diagonals [a1, a4] of the global rows row0 - 1 and row0 + hb
(where the band touches the image's edge, finite values that are not
read).  Its outputs equal the
whole-image pass's rows bit for bit; its partials are the band's blocks.
On a CUDA tensor it launches ``octane_pcg_pass_a_band`` of ``csrc/pcg.cu``,
on a CPU tensor ``pcg_pass_a_band_plain``.  Pass B needs no ghost rows and
runs unchanged on each band.

``pcg_solve_fused`` is the driver (cg.py:271): stop when ||r||^2 <= tol or
after ``iters`` iterations, then the deferred x += alpha p.  The stopping
test is read on the host once per iteration; ``pcg_solve_fused.host_syncs``
counts those reads.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.core.bc import mirror_shift
from octane_tpu_torch.ops.build import check_status, load_kernels


BLOCK_X, BLOCK_Y = 32, 8        # csrc/pcg.cu, assemble.cu, sor.cu: kBX, kBY


def num_partials(h: int, w: int) -> int:
    """Number of 32 x 8 blocks of an (h, w) plane: the kernels' partials."""
    return -(-h // BLOCK_Y) * -(-w // BLOCK_X)


def block_partials(part: torch.Tensor) -> torch.Tensor:
    """Sums of an (h, w) plane over 32 x 8 blocks, flattened row-major:
    the partials of csrc/pcg.cu, assemble.cu and sor.cu, added in their
    order.  A block row is one
    warp, reduced by the shuffle tree (lane l adds lane l + 16, then + 8,
    ..., + 1); the block adds its 8 warp sums in warp order.  The ragged
    edge is padded with zeros, as the kernel's idle threads add 0."""
    h, w = part.shape
    gh, gw = -(-h // BLOCK_Y), -(-w // BLOCK_X)
    x = torch.nn.functional.pad(part, (0, gw * BLOCK_X - w, 0, gh * BLOCK_Y - h))
    x = x.reshape(gh, BLOCK_Y, gw, BLOCK_X)
    n = BLOCK_X
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:2 * n]
    x = x[..., 0]                          # (gh, BLOCK_Y, gw) warp sums
    s = x[:, 0]
    for k in range(1, BLOCK_Y):
        s = s + x[:, k]
    return s.reshape(-1)


def _offdiag(f, cf, rows=slice(None)):
    """Off-diagonal part of A f for one (h, w) component, at ``rows`` of f
    (the rows of cf)."""
    wv, ev = mirror_shift(f, -1, -1)[rows], mirror_shift(f, 1, -1)[rows]
    nv, sv = mirror_shift(f, -1, -2)[rows], mirror_shift(f, 1, -2)[rows]
    if cf.shape[0] == 3:
        return -(wv + ev + nv + sv)
    return cf[3] * wv + cf[5] * ev + cf[4] * nv + cf[6] * sv


def pcg_pass_a_plain(x, r, p, cf, ab):
    """Plain pass A: (x + alpha_prev p, p', A p', block partials of <p', A p'>)."""
    alpha, beta = ab[0], ab[1]
    pn = (1.0 / cf[0:2]) * r + beta * p
    au = cf[0] * pn[0] + cf[2] * pn[1] + _offdiag(pn[0], cf)
    av = cf[2] * pn[0] + cf[1] * pn[1] + _offdiag(pn[1], cf)
    partials = block_partials(pn[0] * au + pn[1] * av)
    return x + alpha * p, pn, torch.stack([au, av]), partials


def pcg_pass_a_band_plain(x, r, p, cf, ab, gr, gp, gd, row0: int, true_h: int):
    """Plain band form: pass A's arithmetic on the band with its ghost rows,
    p' recomputed at the ghost rows, the outputs cropped to the band."""
    hb = x.shape[1]
    lo, hi = row0 > 0, row0 + hb < true_h

    def slab(band, ghost):
        return torch.cat(([ghost[:, :1]] if lo else []) + [band]
                         + ([ghost[:, 1:]] if hi else []), dim=1)

    alpha, beta = ab[0], ab[1]
    pn = (1.0 / slab(cf[0:2], gd)) * slab(r, gr) + beta * slab(p, gp)
    rows = slice(int(lo), int(lo) + hb)
    pb = pn[:, rows]
    au = cf[0] * pb[0] + cf[2] * pb[1] + _offdiag(pn[0], cf, rows)
    av = cf[2] * pb[0] + cf[1] * pb[1] + _offdiag(pn[1], cf, rows)
    partials = block_partials(pb[0] * au + pb[1] * av)
    return x + alpha * p, pb.contiguous(), torch.stack([au, av]), partials


def pcg_pass_b_plain(r, ap, cf, alpha):
    """Plain pass B: (r - alpha ap, (n, 2) block partials of
    [<r, M^-1 r>, <r, r>])."""
    rn = r - alpha[0] * ap
    z = (1.0 / cf[0:2]) * rn
    rz = rn[0] * z[0] + rn[1] * z[1]
    rr = rn[0] * rn[0] + rn[1] * rn[1]
    return rn, torch.stack([block_partials(rz), block_partials(rr)], dim=1)


def _check(name, planes, cf, scalars, min_rows=2):
    ref = planes[0]
    if ref.dim() != 3 or ref.shape[0] != 2:
        raise ValueError(f"{name}: state planes must be (2, h, w), got {tuple(ref.shape)}")
    if cf.dim() != 3 or cf.shape[0] not in (3, 7) or cf.shape[1:] != ref.shape[1:]:
        raise ValueError(f"{name}: coefficients must be (3|7, h, w), got {tuple(cf.shape)}")
    if ref.shape[1] < min_rows or ref.shape[2] < 2:
        raise ValueError(f"{name}: the grid needs at least {min_rows} rows and 2 columns")
    for t in (*planes, cf, *scalars):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.device != ref.device:
            raise ValueError(f"{name}: inputs on different devices")
    for t in planes[1:]:
        if t.shape != ref.shape:
            raise ValueError(f"{name}: state planes differ in shape")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {ref.device}")


def pcg_pass_a(x, r, p, cf, ab):
    """Pass A; returns (x_new, p_new, ap, block partials of <p_new, ap>)."""
    _check("pcg_pass_a", (x, r, p), cf, (ab,))
    if ab.numel() != 2:
        raise ValueError("pcg_pass_a: ab must hold [alpha_prev, beta]")
    if x.device.type == "cpu":
        pcg_pass_a.plain_calls += 1
        return pcg_pass_a_plain(x, r, p, cf, ab)
    lib = load_kernels()
    _, h, w = x.shape
    x_new, p_new, ap = (torch.empty_like(x) for _ in range(3))
    partials = torch.empty(num_partials(h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.octane_pcg_pass_a(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), cf.data_ptr(), ab.data_ptr(),
            x_new.data_ptr(), p_new.data_ptr(), ap.data_ptr(), partials.data_ptr(),
            h, w, int(cf.shape[0] == 3),
            torch.cuda.current_stream(x.device).cuda_stream)
    check_status(status, "octane_pcg_pass_a")
    pcg_pass_a.launches += 1
    return x_new, p_new, ap, partials


def pcg_pass_b(r, ap, cf, alpha):
    """Pass B; returns (r_new, (n, 2) block partials of [<r, M^-1 r>, <r, r>])."""
    _check("pcg_pass_b", (r, ap), cf, (alpha,), min_rows=1)   # no neighbours: any band
    if alpha.numel() != 1:
        raise ValueError("pcg_pass_b: alpha must be a one-element tensor")
    if r.device.type == "cpu":
        pcg_pass_b.plain_calls += 1
        return pcg_pass_b_plain(r, ap, cf, alpha)
    lib = load_kernels()
    _, h, w = r.shape
    r_new = torch.empty_like(r)
    partials = torch.empty((num_partials(h, w), 2), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        status = lib.octane_pcg_pass_b(
            r.data_ptr(), ap.data_ptr(), cf.data_ptr(), alpha.data_ptr(),
            r_new.data_ptr(), partials.data_ptr(), h, w,
            torch.cuda.current_stream(r.device).cuda_stream)
    check_status(status, "octane_pcg_pass_b")
    pcg_pass_b.launches += 1
    return r_new, partials


def pcg_pass_a_band(x, r, p, cf, ab, gr, gp, gd, row0: int, true_h: int):
    """Pass A on a band; returns (x_new, p_new, ap, block partials of
    <p_new, ap> over the band).  See the module docstring."""
    _check("pcg_pass_a_band", (x, r, p), cf, (ab, gr, gp, gd), min_rows=1)
    _, hb, w = x.shape
    if ab.numel() != 2:
        raise ValueError("pcg_pass_a_band: ab must hold [alpha_prev, beta]")
    for name, g in (("gr", gr), ("gp", gp), ("gd", gd)):
        if g.shape != (2, 2, w):
            raise ValueError(f"pcg_pass_a_band: {name} must be (2, 2, {w}), got {tuple(g.shape)}")
    if not (row0 >= 0 and row0 + hb <= true_h and true_h >= 2):
        raise ValueError(f"pcg_pass_a_band: rows [{row0}, {row0 + hb}) do not fit an image "
                         f"of {true_h} rows")
    if x.device.type == "cpu":
        pcg_pass_a_band.plain_calls += 1
        return pcg_pass_a_band_plain(x, r, p, cf, ab, gr, gp, gd, row0, true_h)
    lib = load_kernels()
    x_new, p_new, ap = (torch.empty_like(x) for _ in range(3))
    partials = torch.empty(num_partials(hb, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.octane_pcg_pass_a_band(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), cf.data_ptr(), ab.data_ptr(),
            gr.data_ptr(), gp.data_ptr(), gd.data_ptr(), x_new.data_ptr(), p_new.data_ptr(),
            ap.data_ptr(), partials.data_ptr(), hb, w, row0, true_h, int(cf.shape[0] == 3),
            torch.cuda.current_stream(x.device).cuda_stream)
    check_status(status, "octane_pcg_pass_a_band")
    pcg_pass_a_band.launches += 1
    return x_new, p_new, ap, partials


for _fn in (pcg_pass_a, pcg_pass_a_band, pcg_pass_b):
    _fn.launches = 0
    _fn.plain_calls = 0


def pcg_solve_fused(sysm, tol, iters: int, pass_a=pcg_pass_a, pass_b=pcg_pass_b):
    """Solve A x = b from x = 0 with the two passes; returns (du, dv).

    ``sysm`` is a flow.stencil.StencilSystem; a scalar ``a5`` marks the
    quadratic GNC step (off-diagonals -1).  ``pass_a``/``pass_b`` default to
    the wrappers; the solver's plain route passes the plain versions.
    """
    quad = not torch.is_tensor(sysm.a5)
    planes = [sysm.a1, sysm.a4, sysm.a2]
    if not quad:
        planes += [sysm.a5, sysm.a6, sysm.a7, sysm.a8]
    cf = torch.stack(planes)
    b = torch.stack([sysm.bu, sysm.bv])
    gamma = (torch.sum(sysm.bu * (sysm.bu / sysm.a1))
             + torch.sum(sysm.bv * (sysm.bv / sysm.a4)))
    resid = torch.sum(b * b)
    x = torch.zeros_like(b)
    p = torch.zeros_like(b)
    r = b
    alpha = torch.zeros((), dtype=torch.float32, device=b.device)
    beta = torch.zeros_like(alpha)
    tol32 = float(np.float32(tol))
    for _ in range(iters):
        pcg_solve_fused.host_syncs += 1
        if not float(resid) > tol32:
            break
        x, p, ap, pap = pass_a(x, r, p, cf, torch.stack([alpha, beta]))
        alpha = gamma / torch.sum(pap)
        r, part = pass_b(r, ap, cf, alpha.reshape(1))
        gamma_new = torch.sum(part[:, 0])
        resid = torch.sum(part[:, 1])
        beta = gamma_new / gamma
        gamma = gamma_new
    x = x + alpha * p                    # the final deferred update
    return x[0], x[1]


pcg_solve_fused.host_syncs = 0
