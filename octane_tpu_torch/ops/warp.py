"""Bilinear warp of the solver's sample stack: CUDA kernel and plain version.

``warp(fields, u, v)`` samples a (K, H, W) float32 stack at
(column + u, row + v) with the reference's conditional clamp
(oct_variational_optical_flow.cu:727-758) and returns
(samples (K, H, W), bc_x, bc_y).  On a CUDA tensor it launches
``csrc/warp.cu`` (the port of the Pallas kernels ``_kernel`` and
``_stats_kernel`` of octane_tpu/ops/pallas/warp.py); on a CPU tensor it runs
the plain PyTorch version ``warp_bilinear_dense``.  The kernel also writes
each tile's window statistics (``warp_block_stats`` is their plain version).

``warp.launches`` counts kernel launches, ``warp.plain_calls`` the calls
served by the plain version.

``warp_band(slab, u, v, s0, r0, true_h, out)`` is the band form for the
mesh path (parallel.sharded): output rows [r0, r0 + hb) of a true_h-row
image, sampled from a slab that holds global rows [s0, s0 + hs) of the
stack; its samples and flags equal the whole-image warp's rows bit for
bit.  They go into the ``out`` = (samples, bc_x, bc_y) buffers when given,
as a captured solve needs.  On a CUDA tensor it launches ``warp_band`` of
``csrc/warp.cu``, on a CPU tensor ``warp_band_plain``;
``warp_band.launches`` / ``.plain_calls`` count them.
"""

from __future__ import annotations

import torch

from octane_tpu_torch.ops.build import check_status, load_kernels

TILE_W = 128
_BIG = 1 << 30


def pick_bh(h: int) -> int:
    """Tile height: 64 rows, 32 below 64 (warp.py:_pick_bh of octane_tpu)."""
    return 64 if h >= 64 else 32


def bilinear_coefs(u: torch.Tensor, v: torch.Tensor, row0: int = 0, true_h=None):
    """Cell origins, bilinear weights and clamp flags of the warp positions.

    Returns (iv1, jv1, p1, p2, p3, p4, bc_x, bc_y) with int64 cell origins
    (octane_tpu.flow.stencil._bilinear_coefs).  ``u``/``v`` are rows
    [row0, row0 + hb) of an image of ``true_h`` rows (default: the whole
    image); positions and clamps are global.
    """
    hb, w = u.shape
    h = hb if true_h is None else true_h
    f32 = torch.float32
    ii = torch.arange(w, dtype=f32, device=u.device)[None, :]
    jj = torch.arange(row0, row0 + hb, dtype=f32, device=u.device)[:, None]
    px = ii + u
    py = jj + v
    bc_x = (px < 0.0) | (px >= w)
    bc_y = (py < 0.0) | (py >= h)
    # values in (n-1, n) pass through unchanged (oct_bc_cu)
    iv = torch.where(px < 0.0, 0.0, torch.where(px >= w, float(w - 1), px))
    jv = torch.where(py < 0.0, 0.0, torch.where(py >= h, float(h - 1), py))
    iv1 = iv.to(torch.int32).clamp_(max=w - 2)
    jv1 = jv.to(torch.int32).clamp_(max=h - 2)
    p1 = (iv1 + 1).to(f32) - iv
    p2 = iv - iv1.to(f32)
    p3 = (jv1 + 1).to(f32) - jv
    p4 = jv - jv1.to(f32)
    return iv1.long(), jv1.long(), p1, p2, p3, p4, bc_x, bc_y


def warp_bilinear_dense(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Plain version: (samples, bc_x, bc_y) by flat gathers
    (octane_tpu.flow.stencil.warp_bilinear_dense)."""
    k, h, w = fields.shape
    iv1, jv1, p1, p2, p3, p4, bc_x, bc_y = bilinear_coefs(u, v)
    flat = fields.reshape(k, -1)
    idx = (jv1 * w + iv1).reshape(-1)

    def take(off):
        return flat.index_select(1, idx + off).reshape(k, h, w)

    f11, f21, f12, f22 = take(0), take(1), take(w), take(w + 1)
    samples = p3 * (p1 * f11 + p2 * f21) + p4 * (p1 * f12 + p2 * f22)
    return samples, bc_x, bc_y


def warp_band_plain(slab: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    s0: int, r0: int, true_h: int, out=None):
    """Plain band form: ``warp_bilinear_dense``'s gathers at global
    positions, read from the slab of rows [s0, s0 + hs); written into
    ``out`` = (samples, bc_x, bc_y) when given."""
    k, hs, w = slab.shape
    hb = u.shape[0]
    iv1, jv1, p1, p2, p3, p4, bc_x, bc_y = bilinear_coefs(u, v, r0, true_h)
    flat = slab.reshape(k, -1)
    idx = ((jv1 - s0).clamp_(0, hs - 2) * w + iv1).reshape(-1)

    def take(off):
        return flat.index_select(1, idx + off).reshape(k, hb, w)

    f11, f21, f12, f22 = take(0), take(1), take(w), take(w + 1)
    samples = p3 * (p1 * f11 + p2 * f21) + p4 * (p1 * f12 + p2 * f22)
    if out is None:
        return samples, bc_x, bc_y
    return tuple(o.copy_(t) for o, t in zip(out, (samples, bc_x, bc_y)))


def warp_block_stats(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's tile statistics, (5, gh, gw) int32:
    min/max of ``jv1 + bh - lj`` over pixels whose sample row is not
    clamped, min/max of ``iv1``, and whether the tile has a row-clamped
    pixel.  These are ``_block_stats`` of octane_tpu/ops/pallas/warp.py
    without the TPU layout's column pad (its column stats are ours + CPAD).
    """
    h, w = u.shape
    bh = pick_bh(h)
    gh, gw = -(-h // bh), -(-w // TILE_W)
    hp, wp = gh * bh, gw * TILE_W
    iv1, jv1, _, _, _, _, _, bc_y = bilinear_coefs(u, v)
    dev = u.device

    def pad(a, val):
        out = torch.full((hp, wp), val, dtype=a.dtype, device=dev)
        out[:h, :w] = a
        return out

    valid = pad(torch.ones((h, w), dtype=torch.bool, device=dev), False)
    rclamp = pad(bc_y, False)
    lj = (torch.arange(hp, device=dev) % bh)[:, None]
    t_row = pad(jv1, 0) + bh - lj
    t_col = pad(iv1, 0)
    rvalid = valid & ~rclamp

    def red(x, mask, fill, fn):
        x = torch.where(mask, x, torch.full_like(x, fill))
        return fn(x.reshape(gh, bh, gw, TILE_W), dim=(1, 3))

    r_min = red(t_row, rvalid, _BIG, torch.amin)
    r_max = red(t_row, rvalid, -_BIG, torch.amax)
    c_min = red(t_col, valid, _BIG, torch.amin)
    c_max = red(t_col, valid, -_BIG, torch.amax)
    eflag = red(rclamp.long(), valid, 0, torch.amax)
    return torch.stack([r_min, r_max, c_min, c_max, eflag]).to(torch.int32)


def _check_inputs(fields, u, v):
    if fields.dim() != 3 or u.dim() != 2 or u.shape != v.shape \
            or fields.shape[1:] != u.shape:
        raise ValueError(f"warp: shapes {tuple(fields.shape)}, {tuple(u.shape)}, "
                         f"{tuple(v.shape)} are not (K, H, W), (H, W), (H, W)")
    for name, t in (("fields", fields), ("u", u), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"warp: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"warp: {name} must be contiguous")
        if t.device != fields.device:
            raise ValueError("warp: inputs on different devices")
    if min(u.shape) < 2:
        raise ValueError("warp: the grid needs at least 2 rows and 2 columns")


def warp(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
         with_stats: bool = False):
    """(samples, bc_x, bc_y); with ``with_stats`` also the (5, gh, gw) tile
    statistics."""
    _check_inputs(fields, u, v)
    if fields.device.type == "cpu":
        warp.plain_calls += 1
        out = warp_bilinear_dense(fields, u, v)
        return (*out, warp_block_stats(u, v)) if with_stats else out
    if fields.device.type != "cuda":
        raise ValueError(f"warp: unsupported device {fields.device}")
    lib = load_kernels()
    k, h, w = fields.shape
    bh = pick_bh(h)
    gh, gw = -(-h // bh), -(-w // TILE_W)
    dev = fields.device
    samples = torch.empty_like(fields)
    bc_x = torch.empty((h, w), dtype=torch.bool, device=dev)
    bc_y = torch.empty((h, w), dtype=torch.bool, device=dev)
    stats = torch.empty((5, gh, gw), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = lib.octane_warp(
            fields.data_ptr(), u.data_ptr(), v.data_ptr(), samples.data_ptr(),
            bc_x.data_ptr(), bc_y.data_ptr(), stats.data_ptr(), k, h, w, bh,
            torch.cuda.current_stream(dev).cuda_stream)
    check_status(status, "octane_warp")
    warp.launches += 1
    if with_stats:
        return samples, bc_x, bc_y, stats
    return samples, bc_x, bc_y


warp.launches = 0
warp.plain_calls = 0


def warp_band(slab: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              s0: int, r0: int, true_h: int, out=None):
    """(samples, bc_x, bc_y) of band rows [r0, r0 + hb) from the slab of
    global rows [s0, s0 + hs), in the ``out`` buffers when given; see the
    module docstring."""
    if slab.dim() != 3 or u.dim() != 2 or u.shape != v.shape or u.shape[1] != slab.shape[2]:
        raise ValueError(f"warp_band: shapes {tuple(slab.shape)}, {tuple(u.shape)}, "
                         f"{tuple(v.shape)} are not (K, hs, W), (hb, W), (hb, W)")
    k, hs, w = slab.shape
    hb = u.shape[0]
    for t in (slab, u, v):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != slab.device:
            raise ValueError("warp_band: inputs must be contiguous float32 on one device")
    if not (0 <= s0 and s0 + hs <= true_h and s0 <= r0 and r0 + hb <= true_h and hb >= 1
            and hs >= 2 and w >= 2):
        raise ValueError(f"warp_band: rows [{r0}, {r0 + hb}) and slab [{s0}, {s0 + hs}) "
                         f"do not fit an image of {true_h} rows")
    if out is not None:
        want = (((k, hb, w), torch.float32), ((hb, w), torch.bool), ((hb, w), torch.bool))
        if len(out) != 3 or any(
                o.shape != shape or o.dtype != dtype or not o.is_contiguous()
                or o.device != slab.device for o, (shape, dtype) in zip(out, want)):
            raise ValueError(f"warp_band: out must be contiguous ({k}, {hb}, {w}) float32 "
                             f"samples and two ({hb}, {w}) bool flag planes on the device "
                             "of the slab")
    if slab.device.type == "cpu":
        warp_band.plain_calls += 1
        return warp_band_plain(slab, u, v, s0, r0, true_h, out)
    if slab.device.type != "cuda":
        raise ValueError(f"warp_band: unsupported device {slab.device}")
    lib = load_kernels()
    dev = slab.device
    if out is None:
        out = (torch.empty((k, hb, w), dtype=torch.float32, device=dev),
               torch.empty((hb, w), dtype=torch.bool, device=dev),
               torch.empty((hb, w), dtype=torch.bool, device=dev))
    samples, bc_x, bc_y = out
    with torch.cuda.device(dev):
        status = lib.octane_warp_band(
            slab.data_ptr(), u.data_ptr(), v.data_ptr(), samples.data_ptr(),
            bc_x.data_ptr(), bc_y.data_ptr(), k, hb, w, hs, s0, r0, true_h, pick_bh(hb),
            torch.cuda.current_stream(dev).cuda_stream)
    check_status(status, "octane_warp_band")
    warp_band.launches += 1
    return samples, bc_x, bc_y


warp_band.launches = 0
warp_band.plain_calls = 0
