"""The SRSAL cross-bilateral smoother: CUDA kernel and plain version.

``bilateral(u, v, cth, gk, sigpix2)`` smooths the (H, W) float32 flow
(u, v) over the (2p+1) x (2p+1) window of the 2p+1 spatial taps ``gk``
(p = 18 for SRSAL), each tap weighted by gk[kc] * gk[lc] times the range
weight exp((cth_n - cth_0)^2 * sigpix2), with the reference's mixed
reflect boundary, and returns the (2, H, W) float32 (u_s, v_s)
(oct_srsal_cuda.cu:34-71).  On a CUDA tensor it launches
``csrc/bilateral.cu`` (the port of ``_kernel`` of
octane_tpu/ops/pallas/bilateral.py); on a CPU tensor it runs
``bilateral_plain``, the port of octane_tpu.post.srsal's ``_reflect_pad``
and ``_tap_loop``: a Python loop over the taps, column offset outer, on
slices of the padded planes.  The kernel sums each pixel's taps in the
plain version's order but folds the spatial weight into one base-2
exponent, 2^(log2 gk[kc] + log2 gk[lc] - k d^2), with FMAs and the card's
approximate ex2, so it agrees with the plain version within the budget of
docs/PARITY.md:91, rel <= 1e-5 (max |d| / max |plain|, each of u and v;
<= 9.7e-7 measured on an H100 at 64x80 to 5424^2), not bit for bit.
``bilateral.launches`` / ``.plain_calls`` count them.

``bilateral_band(u, v, cth, gk, sigpix2, s0, r0, hb, true_h)`` is the band
form for the mesh path (parallel.post.sharded_srsal): u, v, cth are a slab
of global rows [s0, s0 + hs) of a true_h-row image, and it returns the
smoothed (2, hb, W) rows [r0, r0 + hb), the boundary map taken in global
coordinates; the slab must hold every row the band's windows reach
(``band_slab``: the band and p rows beside it).  Its rows equal the
whole-image call's bit for bit, kernel against kernel and plain against
plain.  On a CUDA tensor it launches ``octane_bilateral_band`` of
``csrc/bilateral.cu``, on a CPU tensor ``bilateral_band_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.core.bc import reflect_index
from octane_tpu_torch.ops.build import check_status, load_kernels

MAX_P = 48      # kMaxP of csrc/bilateral.cu


def reflect_pad(a: torch.Tensor, p: int) -> torch.Tensor:
    """Pad (H, W) by p on each side with the reference's boundary map:
    index -k -> k, index n-1+k -> n-k (oct_bc_cuda; srsal._reflect_pad)."""
    a = torch.cat([a[1:p + 1].flip(0), a, a[-p:].flip(0)], dim=0)
    return torch.cat([a[:, 1:p + 1].flip(1), a, a[:, -p:].flip(1)], dim=1)


def bilateral_plain(u: torch.Tensor, v: torch.Tensor, cth: torch.Tensor,
                    gk, sigpix2: float) -> torch.Tensor:
    """Plain version: the (2, H, W) smoothed flow, tap by tap."""
    p = (len(gk) - 1) // 2
    return _tap_loop(*(reflect_pad(t, p) for t in (u, v, cth)), cth, gk, sigpix2)


def band_slab(r0: int, r1: int, true_h: int, p: int):
    """[s0, s1): the rows the windows of band rows [r0, r1) read, through
    the boundary map, of a true_h-row image."""
    return max(0, r0 - p), min(true_h, r1 + p)


def bilateral_band_plain(u, v, cth, gk, sigpix2: float, s0: int, r0: int, hb: int,
                         true_h: int) -> torch.Tensor:
    """Plain band form: the slab padded through the global boundary map
    (rows) and reflect_pad's (columns), then the tap loop."""
    p = (len(gk) - 1) // 2
    rows = reflect_index(torch.arange(r0 - p, r0 + hb + p, device=u.device), true_h) - s0

    def pad(t):
        a = t.index_select(0, rows)
        return torch.cat([a[:, 1:p + 1].flip(1), a, a[:, -p:].flip(1)], dim=1)

    return _tap_loop(pad(u), pad(v), pad(cth), cth[r0 - s0:r0 - s0 + hb], gk, sigpix2)


def _tap_loop(up, vp, cp, cth, gk, sigpix2: float) -> torch.Tensor:
    """The (2, h, w) smoothed flow from the padded planes, tap by tap, column
    offset outer (post/srsal.py _tap_loop of octane_tpu)."""
    gk = np.asarray(gk, np.float32)
    n = len(gk)
    h, w = cth.shape
    au = torch.zeros_like(cth)
    av = torch.zeros_like(cth)
    a2 = torch.zeros_like(cth)
    for kc in range(n):
        for lc in range(n):
            wt = float(gk[kc] * gk[lc])         # the float32 product
            dmc = cp[lc:lc + h, kc:kc + w] - cth
            a1 = wt * torch.exp(dmc * dmc * sigpix2)
            au = au + up[lc:lc + h, kc:kc + w] * a1
            av = av + vp[lc:lc + h, kc:kc + w] * a1
            a2 = a2 + a1
    return torch.stack([au / a2, av / a2])


def _check(u, v, cth, p):
    if u.dim() != 2:
        raise ValueError(f"bilateral: u must be (H, W), got {tuple(u.shape)}")
    for name, t in (("u", u), ("v", v), ("cth", cth)):
        if t.shape != u.shape:
            raise ValueError(f"bilateral: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(u.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"bilateral: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.device != u.device:
            raise ValueError("bilateral: inputs must be contiguous and on one device")
    if min(u.shape) < p + 1:
        raise ValueError(f"bilateral: the reflect boundary needs H, W >= {p + 1} "
                         f"for a {2 * p + 1}-tap window, got {tuple(u.shape)}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bilateral: unsupported device {u.device}")


def bilateral(u: torch.Tensor, v: torch.Tensor, cth: torch.Tensor,
              gk, sigpix2: float) -> torch.Tensor:
    """(2, H, W) smoothed (u, v); see the module docstring."""
    gk = np.ascontiguousarray(gk, np.float32)
    p = (len(gk) - 1) // 2
    if len(gk) != 2 * p + 1 or p > MAX_P:
        raise ValueError(f"bilateral: gk must hold an odd number of taps, at most "
                         f"{2 * MAX_P + 1}, got {len(gk)}")
    _check(u, v, cth, p)
    if u.device.type == "cpu":
        bilateral.plain_calls += 1
        return bilateral_plain(u, v, cth, gk, sigpix2)
    lib = load_kernels()
    h, w = u.shape
    out = torch.empty((2, h, w), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        status = lib.octane_bilateral(
            u.data_ptr(), v.data_ptr(), cth.data_ptr(), out.data_ptr(), gk.ctypes.data,
            h, w, p, sigpix2, torch.cuda.current_stream(u.device).cuda_stream)
    check_status(status, "octane_bilateral")
    bilateral.launches += 1
    return out


bilateral.launches = 0
bilateral.plain_calls = 0


def bilateral_band(u: torch.Tensor, v: torch.Tensor, cth: torch.Tensor, gk, sigpix2: float,
                   s0: int, r0: int, hb: int, true_h: int) -> torch.Tensor:
    """(2, hb, W) smoothed rows [r0, r0 + hb) from the slab of rows [s0, s0 +
    hs); see the module docstring."""
    gk = np.ascontiguousarray(gk, np.float32)
    p = (len(gk) - 1) // 2
    if len(gk) != 2 * p + 1 or p > MAX_P:
        raise ValueError(f"bilateral_band: gk must hold an odd number of taps, at most "
                         f"{2 * MAX_P + 1}, got {len(gk)}")
    _check(u, v, cth, 0)
    hs, w = u.shape
    if min(true_h, w) < p + 1:
        raise ValueError(f"bilateral_band: the reflect boundary needs H, W >= {p + 1}, got "
                         f"{(true_h, w)}")
    lo, hi = band_slab(r0, r0 + hb, true_h, p)
    if not (hb >= 1 and s0 <= lo and hi <= s0 + hs <= true_h):
        raise ValueError(f"bilateral_band: a slab of rows [{s0}, {s0 + hs}) does not hold the "
                         f"rows [{lo}, {hi}) that band rows [{r0}, {r0 + hb}) read")
    if u.device.type == "cpu":
        bilateral_band.plain_calls += 1
        return bilateral_band_plain(u, v, cth, gk, sigpix2, s0, r0, hb, true_h)
    lib = load_kernels()
    out = torch.empty((2, hb, w), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        status = lib.octane_bilateral_band(
            u.data_ptr(), v.data_ptr(), cth.data_ptr(), out.data_ptr(), gk.ctypes.data,
            hb, w, hs, s0, r0, true_h, p, sigpix2,
            torch.cuda.current_stream(u.device).cuda_stream)
    check_status(status, "octane_bilateral_band")
    bilateral_band.launches += 1
    return out


bilateral_band.launches = 0
bilateral_band.plain_calls = 0
