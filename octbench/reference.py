"""The plain reference of one GOES pair: ingest, patch-match's first guess
(hybrid configurations), coarse-to-fine solve with either relaxer, and
pix2uv's int16 winds.

Plain PyTorch on any device.  It imports neither jax, the JAX package nor
the port; it restates the semantics the port documents (OCTANE's modified
Zimmer / Brox variational flow, SURVEY.md section 8; oct_navcal_cuda.cu,
oct_patch_match_optical_flow.cc, oct_variational_optical_flow.cu,
oct_pix2uv_cuda.cu) with straightforward
reductions (``torch.sum``), so it agrees with the port to float32
round-off, not bit for bit.

Every stage runs in blocks of whole rows (``row_blocks``: ``BLOCK_PIXELS``
pixels, or ``block_rows`` rows), each with the neighbour rows its stencil
reads, so that one 21696 x 21696 pair fits one 80 GB card: a stage's
per-pixel arithmetic is that of the whole image, so its outputs are the
same bits whatever the blocks.  The relaxers' dot products are summed
block by block; a plane of up to ``BLOCK_PIXELS`` pixels (a 5424 x 5424
full disk) is one block.  The warp's samples live one block at a time,
a round's system and the relaxer's state as whole planes, and the level's
image stack and its derivatives only for their level.

``Precision`` says in which types it computes: the configuration's
(navigation float64, solve float32, the relaxers' dot products summed in
float64 so that the reference's own round-off stays below the port's) is
the reference; the next type below each (navigation float32, solve
bfloat16) is the control that the comparison has to refuse.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

DTOR = math.pi / 180.0
EARTH_RADIUS = 6371000.0
PSI_EPS = 1e-6
PASS_SWEEPS = 8             # SOR: red+black sweeps between two stopping tests
BLOCK_PIXELS = 1 << 25      # pixels of a row block: a 5424 x 5424 plane is one block


@dataclasses.dataclass(frozen=True)
class Precision:
    nav: torch.dtype = torch.float64
    solve: torch.dtype = torch.float32
    accumulate: torch.dtype = None      # the relaxers' dot products (None: the solve's type)


REFERENCE = Precision(accumulate=torch.float64)
CONTROL = Precision(nav=torch.float32, solve=torch.bfloat16)


def _f32(x: float) -> float:
    return float(np.float32(x))


def row_blocks(h: int, w: int, block_rows: int = None):
    """[(r0, r1)]: the row blocks of an (h, w) plane, ``block_rows`` rows
    each (default: ``BLOCK_PIXELS`` pixels)."""
    n = block_rows or max(1, BLOCK_PIXELS // w)
    return [(r0, min(r0 + n, h)) for r0 in range(0, h, n)]


def _slab(r0: int, r1: int, h: int, halo: int):
    """The rows [s0, s1) that a stencil of ``halo`` rows reads for the
    block [r0, r1) of h rows."""
    return max(r0 - halo, 0), min(r1 + halo, h)


class _Sum:
    """A dot product summed block by block in ``acc`` (None: the type of
    the products); one block's is torch.sum's whole-plane sum."""

    def __init__(self, acc):
        self.acc, self.total = acc, None

    def add(self, a, b):
        part = torch.sum(a * b, dtype=self.acc)
        self.total = part if self.total is None else self.total + part

    def value(self, dtype):
        return self.total.to(dtype)


# --------------------------------------------------------------------------
# ingest: navigation, calibration and normalisation (oct_navcal_cuda.cu:11-98)
# --------------------------------------------------------------------------

def normalised(counts, nav: dict, vmin: float, vmax: float, device,
               prec: Precision = REFERENCE, block_rows: int = None) -> torch.Tensor:
    """(H, W) float32 [0, 255] data of int16 counts: radiance, limb ramp
    (1 below 0.021 rad^2 from the sub-satellite point, 0 from 0.0212),
    normalised from the band's [vmin, vmax], computed in ``prec.nav``."""
    dt = prec.nav
    counts = np.asarray(counts)
    h, w = counts.shape
    out = torch.empty((h, w), device=device, dtype=torch.float32)
    x = torch.arange(w, device=device, dtype=dt) * nav["x_scale"] + nav["x_offset"]
    slope = 1.0 / (0.021 - 0.0212)
    for r0, r1 in row_blocks(h, w, block_rows):
        c = torch.as_tensor(counts[r0:r1], device=device).to(dt)
        y = torch.arange(r0, r1, device=device, dtype=dt) * nav["y_scale"] + nav["y_offset"]
        sub2 = x[None, :] * x[None, :] + y[:, None] * y[:, None]
        ramp = torch.where(sub2 < 0.021, 1.0,
                           torch.where(sub2 >= 0.0212, 0.0, slope * sub2 + (1.0 - 0.021 * slope)))
        rad = c * nav["rad_scale"][0] + nav["rad_offset"][0]
        out[r0:r1] = (ramp * ((rad - vmin) / (vmax - vmin) * 255.0)).to(torch.float32)
    return out


# --------------------------------------------------------------------------
# patch-match from a zero guess (oct_patch_match_optical_flow.cc:12-156)
# --------------------------------------------------------------------------

def spiral(srad: int):
    """[(n, m)]: the search's offsets in OCTANE's spiral visit order (:93-131),
    from (0, 0) outwards, turning where n == m, n < 0 and n == -m, or n > 0
    and n == 1 - m.  Its bounds test is always true (:102-104), so the
    (2 srad + 1)^2 steps visit the whole square."""
    n = m = 0
    dn, dm = 0, -1
    out = []
    for _ in range((2 * srad + 1) ** 2):
        out.append((n, m))
        if n == m or (n < 0 and n == -m) or (n > 0 and n == 1 - m):
            dn, dm = -dm, dn
        n, m = n + dn, m + dm
    return out


def _jsose(g1, g2, rows, cols, n, m, rad: int):
    """jsose (:12-33) at the pixels (rows, cols) for the offsets (n, m)
    (numbers or planes): the sum over k, then l, in -rad .. rad of
    (g2[j + l + m, i + k + n] - g1[j + l, i + k])^2, reads clamped to the
    image, summed in that order in the images' type."""
    h, w = g1.shape
    total = None
    for k in range(-rad, rad + 1):
        for l in range(-rad, rad + 1):
            d = g2[(rows + (l + m)).clamp(0, h - 1), (cols + (k + n)).clamp(0, w - 1)] \
                - g1[(rows + l).clamp(0, h - 1), (cols + k).clamp(0, w - 1)]
            total = d * d if total is None else total + d * d
    return total


def _search(g1, g2, rows, cols, rad: int, srad: int):
    """(n, m, cost) of each pixel's least cost over the spiral: a later
    offset wins only where its cost is strictly lower."""
    order = spiral(srad)
    best = _jsose(g1, g2, rows, cols, *order[0], rad)
    n_min = torch.zeros(best.shape, dtype=torch.int64, device=best.device)
    m_min = torch.zeros_like(n_min)
    for n, m in order[1:]:
        c = _jsose(g1, g2, rows, cols, n, m, rad)
        lower = c < best
        best = torch.where(lower, c, best)
        n_min = torch.where(lower, n, n_min)
        m_min = torch.where(lower, m, m_min)
    return n_min, m_min, best


def _vertex(centre, c0, c_plus, c_minus):
    """jquad_interp (:35-55) along one axis: the vertex of the parabola
    through (-1, c_minus), (0, c0), (1, c_plus), (c_minus - c_plus) / (2
    (c_plus + c_minus - 2 c0)) from the winner, where c0 is strictly the
    least of the three (and the parabola not flat); else the winner."""
    centre = centre.to(c0.dtype)
    denom = 2.0 * (c_plus + c_minus - 2.0 * c0)
    fit = (c0 < c_plus) & (c0 < c_minus) & (denom != 0)
    return torch.where(fit, centre + (c_minus - c_plus) / torch.where(fit, denom, 1.0), centre)


def patch_match(g1, g2, rad: int, srad: int, prec: Precision = REFERENCE,
                block_rows: int = None):
    """(u, v) float32 of OCTANE's patch-match from a zero guess of (H, W)
    images, computed in ``prec.solve``: each pixel's offset of least SSD
    over (2 rad + 1)^2 patches in the spiral of (2 srad + 1)^2 offsets, then
    the quadratic fit of the cost along each axis around it (:133-149), in
    row blocks that read the rows beside them."""
    g1, g2 = g1.to(prec.solve), g2.to(prec.solve)
    h, w = g1.shape
    u = torch.empty((h, w), dtype=torch.float32, device=g1.device)
    v = torch.empty_like(u)
    cols = torch.arange(w, device=g1.device)[None, :]
    for r0, r1 in row_blocks(h, w, block_rows):
        rows = torch.arange(r0, r1, device=g1.device)[:, None]
        n, m, c0 = _search(g1, g2, rows, cols, rad, srad)

        def cost(dn, dm):
            return _jsose(g1, g2, rows, cols, n + dn, m + dm, rad)
        u[r0:r1] = _vertex(n, c0, cost(1, 0), cost(-1, 0))
        v[r0:r1] = _vertex(m, c0, cost(0, 1), cost(0, -1))
    return u, v


# --------------------------------------------------------------------------
# the solve
# --------------------------------------------------------------------------

def _padded(a, k: int, axis: int, mode: str):
    """(..., H, W) ``a`` padded by ``k`` on both sides of ``axis`` (-1 or -2):
    "replicate" clamps, "reflect" mirrors about the edge sample."""
    x = a.reshape((-1,) + tuple(a.shape[-2:]))
    x = F.pad(x, (k, k, 0, 0) if axis == -1 else (0, 0, k, k), mode=mode)
    return x.reshape(tuple(a.shape[:-2]) + tuple(x.shape[-2:]))


def _clamped_shifts(a, k: int, axis: int):
    """shift(off) -> out[i] = a[clip(i + off, 0, n - 1)] along ``axis``, for
    |off| <= k, as views of one padded array."""
    p = _padded(a, k, axis, "replicate")
    n = a.shape[axis]
    return lambda off: p.narrow(axis, k + off, n)


def _neighbours(f, lo: int = 0, n: int = None):
    """at(di, dj) -> the neighbour (i + di, j + dj), |di|, |dj| <= 1, of
    rows [lo, lo + n) of ``f`` (a slab holding the rows next to them), with
    the solver's mirror-at-1 edges (the neighbour beyond an edge is the one
    on the other side), as views of one padded array."""
    h, w = f.shape[-2:]
    n = h - lo if n is None else n
    x = F.pad(f.reshape((-1, h, w)), (1, 1, 1, 1), mode="reflect")
    x = x.reshape(tuple(f.shape[:-2]) + (h + 2, w + 2))
    return lambda di, dj: x[..., 1 + lo + di:1 + lo + di + n, 1 + dj:1 + dj + w]


def _derivative(img, axis: int, out=None, block_rows: int = None):
    """4th-order central difference along ``axis``, clamped taps, into ``out``."""
    h, w = img.shape[-2:]
    out = torch.empty_like(img) if out is None else out
    for r0, r1 in row_blocks(h, w, block_rows):
        s0, s1 = _slab(r0, r1, h, 2)
        at = _clamped_shifts(img[..., s0:s1, :], 2, axis)
        d = (-at(2) + 8.0 * at(1) - 8.0 * at(-1) + at(-2)) / 12.0
        out[..., r0:r1, :] = d[..., r0 - s0:r1 - s0, :]
    return out


def gradients(img, block_rows: int = None):
    """4th-order central differences, clamped taps: (d/dx, d/dy)."""
    return _derivative(img, -1, block_rows=block_rows), _derivative(img, -2, block_rows=block_rows)


def zoom_size(n: int, factor: float) -> int:
    return int(float(n) * factor + 0.5)


def _blur_taps(factor: float):
    """(half-width, taps) of the pyramid's Gaussian: sigma 0.6 sqrt(1/f^2 -
    1), half-width max(trunc(2 / sqrt(2 f)), 5), normalised over 2
    half-width + 1 taps."""
    sigma = 0.6 * math.sqrt(1.0 / (factor * factor) - 1.0)
    fs = max(int(2.0 / math.sqrt(2.0 * factor)), 5)
    s = 2.0 * sigma * sigma
    x = np.arange(-fs, fs + 1, dtype=np.float64)
    k = np.exp(-(x * x) / s) / (math.pi * s)
    return fs, (k / k.sum()).astype(np.float32)


def _blur(img, factor: float):
    """The pyramid's Gaussian, of which taps -half-width .. half-width - 1
    are applied, clamped edges."""
    fs, k = _blur_taps(factor)

    def conv(a, axis):
        at = _clamped_shifts(a, fs, axis)
        out = None
        for off in range(-fs, fs):
            term = at(off) * float(k[off + fs])
            out = term if out is None else out + term
        return out
    return conv(conv(img, -1), -2)


def downsample(img, factor: float, block_rows: int = None):
    """Blur at full resolution, then sample (trunc(j / f), trunc(i / f)),
    in blocks of the input's rows."""
    h, w = img.shape[-2:]
    f = _f32(factor)
    fs, _ = _blur_taps(factor)

    def idx(n_out, n_in):
        pos = torch.arange(n_out, dtype=torch.float32, device=img.device)
        return torch.clamp(torch.trunc(pos / f).long(), 0, n_in - 1)
    ri, ci = idx(zoom_size(h, factor), h), idx(zoom_size(w, factor), w)
    out = img.new_empty(tuple(img.shape[:-2]) + (ri.numel(), ci.numel()))
    per = max(1, int((block_rows or max(1, BLOCK_PIXELS // w)) * factor))
    for o0 in range(0, ri.numel(), per):
        o1 = min(o0 + per, ri.numel())
        s0, s1 = _slab(int(ri[o0]), int(ri[o1 - 1]) + 1, h, fs)
        b = _blur(img[..., s0:s1, :], factor)
        out[..., o0:o1, :] = b.index_select(-2, ri[o0:o1] - s0).index_select(-1, ci)
    return out


def _catmull_rom(n_in: int, n_out: int, device, dtype):
    """(n_out, n_in) Catmull-Rom matrix of the half-pixel zoom in."""
    f = np.float32(n_out) / np.float32(n_in)
    p = np.arange(n_out, dtype=np.float32) / f - (np.float32(0.5) - np.float32(0.5) / f)
    m = np.zeros((n_out, n_in), np.float32)
    base = np.trunc(p).astype(np.int64)
    x = p - base.astype(np.float32)
    wts = (0.5 * (-x + 2 * x * x - x ** 3), 1.0 - 2.5 * x * x + 1.5 * x ** 3,
           0.5 * (x + 4 * x * x - 3 * x ** 3), 0.5 * (-x * x + x ** 3))
    for o, wt in zip((-1, 0, 1, 2), wts):
        cols = np.clip(np.trunc(p + np.float32(o)).astype(np.int64), 0, n_in - 1)
        np.add.at(m, (np.arange(n_out), cols), wt.astype(np.float32))
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def zoom_flow(uv, new_hw, scale_factor: float):
    """Bicubic (Catmull-Rom) zoom in of (2, h, w) at half-pixel positions,
    divided by the scale factor."""
    h, w = uv.shape[-2:]
    ry = _catmull_rom(h, new_hw[0], uv.device, uv.dtype)
    rx = _catmull_rom(w, new_hw[1], uv.device, uv.dtype)
    return torch.matmul(torch.matmul(ry, uv), rx.T) / _f32(scale_factor)


def warp(stack, u, v, r0: int = 0):
    """Bilinear samples of (K, H, W) at (i + u, j + v) of the rows [r0, r0 +
    n) that (n, W) u and v give, with the conditional clamp: positions
    outside the image are clamped to it and flagged.  Positions are float32
    whatever the type of the samples."""
    k, h, w = stack.shape
    n = u.shape[0]
    dt = stack.dtype
    px = torch.arange(w, device=u.device, dtype=torch.float32)[None, :] + u.float()
    py = torch.arange(r0, r0 + n, device=u.device, dtype=torch.float32)[:, None] + v.float()
    bc_x = (px < 0) | (px >= w)
    bc_y = (py < 0) | (py >= h)
    iv = torch.where(px < 0, 0.0, torch.where(px >= w, float(w - 1), px))
    jv = torch.where(py < 0, 0.0, torch.where(py >= h, float(h - 1), py))
    i1 = torch.clamp(iv.to(torch.int32), max=w - 2).long()
    j1 = torch.clamp(jv.to(torch.int32), max=h - 2).long()
    p1, p2 = ((i1 + 1).float() - iv).to(dt), (iv - i1.float()).to(dt)
    p3, p4 = ((j1 + 1).float() - jv).to(dt), (jv - j1.float()).to(dt)
    flat = stack.reshape(k, -1)
    idx = (j1 * w + i1).reshape(-1)

    def take(off):
        return flat[:, idx + off].reshape(k, n, w)
    return p3 * (p1 * take(0) + p2 * take(1)) + p4 * (p1 * take(w) + p2 * take(w + 1)), \
        bc_x, bc_y


def psi(x):
    return torch.rsqrt(x + PSI_EPS)


def assemble(samples, bc_x, bc_y, g1, gx1, gy1, u, v, uhat, vhat, al1, alpha, lam_a,
             lambdac, dozim, lo: int = 0):
    """The linearised Euler-Lagrange system around (u, v) of one GNC round:
    (diagonal blocks a1, a2, a4, off-diagonals [west, north, east, south]
    (-1 in the quadratic round al1 = 1), right-hand sides bu, bv).  Of the
    rows [lo, lo + n) of the slabs u and v, where the samples and the other
    planes hold those n rows."""
    c = g1.shape[0]
    n = samples.shape[-2]
    nu, nv = _neighbours(u, lo, n), _neighbours(v, lo, n)
    u, v = nu(0, 0), nv(0, 0)
    uW, uE, uN, uS = nu(0, -1), nu(0, 1), nu(-1, 0), nu(1, 0)
    vW, vE, vN, vS = nv(0, -1), nv(0, 1), nv(-1, 0), nv(1, 0)
    nsum_u, nsum_v = uW + uN + uE + uS, vW + vN + vE + vS
    quad = al1 == 1.0
    if not quad:
        uNE, uSE, uNW, uSW = nu(-1, 1), nu(1, 1), nu(-1, -1), nu(1, -1)
        vNE, vSE, vNW, vSW = nv(-1, 1), nv(1, 1), nv(-1, -1), nv(1, -1)
        sq = torch.square
        east = sq(uE - u) + sq(0.25 * ((uSE - uNE) + (uS - uN))) \
            + sq(vE - v) + sq(0.25 * ((vSE - vNE) + (vS - vN)))
        west = sq(u - uW) + sq(0.25 * ((uSW - uNW) + (uS - uN))) \
            + sq(v - vW) + sq(0.25 * ((vSW - vNW) + (vS - vN)))
        south = sq(uS - u) + sq(0.25 * ((uSE - uSW) + (uE - uW))) \
            + sq(vS - v) + sq(0.25 * ((vSE - vSW) + (vE - vW)))
        north = sq(u - uN) + sq(0.25 * ((uNE - uNW) + (uE - uW))) \
            + sq(v - vN) + sq(0.25 * ((vNE - vNW) + (vE - vW)))
        pw, pn, pe, ps = psi(west), psi(north), psi(east), psi(south)
        ptot = pw + pn + pe + ps
        wsum_u = pw * uW + pn * uN + pe * uE + ps * uS
        wsum_v = pw * vW + pn * vN + pe * vE + ps * vS
    zero = torch.zeros_like(u)
    d1 = d12 = d2 = d22 = d4 = d42 = r5 = r52 = r6 = r62 = e1 = e2 = zero
    for ch in range(c):
        it = samples[ch] - g1[ch]
        ix = torch.where(bc_x, 0.0, samples[c + ch])
        iy = torch.where(bc_y, 0.0, samples[2 * c + ch])
        ixx = torch.where(bc_x, 0.0, samples[3 * c + ch])
        ixy = torch.where(bc_x | bc_y, 0.0, samples[4 * c + ch])
        iyy = torch.where(bc_y, 0.0, samples[5 * c + ch])
        ixt, iyt = ix - gx1[ch], iy - gy1[ch]
        if dozim:
            na = 1.0 / (ix * ix + iy * iy + 1.0)
            nb = 1.0 / (ixx * ixx + ixy * ixy + 1.0)
            nc = 1.0 / (ixy * ixy + iyy * iyy + 1.0)
        else:
            na = nb = nc = 1.0
        e1 = e1 + na * it * it
        e2 = e2 + nb * ixt * ixt + nc * iyt * iyt
        d1 = d1 + na * ix * ix
        d12 = d12 + nb * ixx * ixx + nc * ixy * ixy
        d2 = d2 + na * ix * iy
        d22 = d22 + nb * ixx * ixy + nc * iyy * ixy
        d4 = d4 + na * iy * iy
        d42 = d42 + nb * ixy * ixy + nc * iyy * iyy
        r5 = r5 - na * it * ix
        r52 = r52 - (nb * ixt * ixx + nc * iyt * ixy)
        r6 = r6 - na * it * iy
        r62 = r62 - (nb * ixt * ixy + nc * iyt * iyy)
    hu, hv = lambdac * (u - uhat), lambdac * (v - vhat)
    qa1 = d1 / alpha + lam_a * d12 + lambdac + 4.0
    qa2 = d2 / alpha + lam_a * d22
    qa4 = d4 / alpha + lam_a * d42 + lambdac + 4.0
    qbu = r5 / alpha + lam_a * r52 - hu + nsum_u - 4.0 * u
    qbv = r6 / alpha + lam_a * r62 - hv + nsum_v - 4.0 * v
    if quad:
        return qa1, qa2, qa4, None, qbu, qbv
    pd1 = psi(e1) / alpha
    pd2 = lam_a * psi(e2)
    m = 1.0 - al1
    a1 = al1 * qa1 + m * (pd1 * d1 + pd2 * d12 + lambdac + ptot)
    a2 = al1 * qa2 + m * (pd1 * d2 + pd2 * d22)
    a4 = al1 * qa4 + m * (pd1 * d4 + pd2 * d42 + lambdac + ptot)
    off = [-(al1 + m * p) for p in (pw, pn, pe, ps)]
    bu = al1 * qbu + m * (pd1 * r5 + pd2 * r52 - hu + wsum_u - ptot * u)
    bv = al1 * qbv + m * (pd1 * r6 + pd2 * r62 - hv + wsum_v - ptot * v)
    return a1, a2, a4, off, bu, bv


def apply_a(sysm, x, lo: int = 0):
    """A x of the (2, H, W) iterate [u, v] with the mirror-at-1 edges: of
    the rows [lo, lo + n) of the slab ``x``, where the system holds those n
    rows."""
    a1, a2, a4, off, _, _ = sysm
    at = _neighbours(x, lo, a1.shape[-2])
    x = at(0, 0)
    if off is None:
        nb = -(at(0, -1) + at(-1, 0) + at(0, 1) + at(1, 0))
    else:
        nb = off[0] * at(0, -1) + off[1] * at(-1, 0) + off[2] * at(0, 1) + off[3] * at(1, 0)
    return torch.stack([a1 * x[0] + a2 * x[1], a2 * x[0] + a4 * x[1]]) + nb


def _rows(sysm, r0: int, r1: int):
    """The system's rows [r0, r1)."""
    a1, a2, a4, off, bu, bv = sysm
    return (a1[r0:r1], a2[r0:r1], a4[r0:r1], None if off is None else [o[r0:r1] for o in off],
            bu[r0:r1], bv[r0:r1])


def pcg(sysm, tol: float, iters: int, acc=None, block_rows: int = None):
    """Jacobi-preconditioned CG from x = 0: stop once ||r||^2 <= tol or
    after ``iters`` iterations.  Returns (du, dv, iterations).  A p is
    applied block by block twice, for <p, A p> and for the update, so
    that no plane of it is kept."""
    a1, _, a4, _, bu, bv = sysm
    h, w = bu.shape
    blocks = row_blocks(h, w, block_rows)

    def diag(r0, r1):
        return torch.stack([a1[r0:r1], a4[r0:r1]])

    def ap(r0, r1):
        s0, s1 = _slab(r0, r1, h, 1)
        return apply_a(_rows(sysm, r0, r1), p[:, s0:s1], r0 - s0)

    r = torch.stack([bu, bv])
    x = torch.zeros_like(r)
    p = torch.empty_like(r)
    rz, rr = _Sum(acc), _Sum(acc)
    for r0, r1 in blocks:
        z = r[:, r0:r1] / diag(r0, r1)
        p[:, r0:r1] = z
        rz.add(r[:, r0:r1], z)
        rr.add(r[:, r0:r1], r[:, r0:r1])
    rz, resid = rz.value(r.dtype), rr.value(r.dtype)
    k = 0
    while k < iters and float(resid) > tol:
        pap = _Sum(acc)
        for r0, r1 in blocks:
            pap.add(p[:, r0:r1], ap(r0, r1))
        step = rz / pap.value(r.dtype)
        rz_new, rr = _Sum(acc), _Sum(acc)
        for r0, r1 in blocks:
            x[:, r0:r1] = x[:, r0:r1] + step * p[:, r0:r1]
            rb = r[:, r0:r1] - step * ap(r0, r1)
            r[:, r0:r1] = rb
            rr.add(rb, rb)
            rz_new.add(rb, rb / diag(r0, r1))
        resid, rz_new = rr.value(r.dtype), rz_new.value(r.dtype)
        beta = rz_new / rz
        for r0, r1 in blocks:
            p[:, r0:r1] = r[:, r0:r1] / diag(r0, r1) + beta * p[:, r0:r1]
        rz = rz_new
        k += 1
    return x[0], x[1], k


def sor(sysm, tol: float, iters: int, omega: float, acc=None, block_rows: int = None):
    """Red-black SOR from x = 0 with the exact 2 x 2 block solve, in passes
    of up to 8 red+black sweeps (``iters`` in all): a pass runs while the
    residual that the previous pass found on entry (||b||^2 before the
    first) exceeds ``tol``.  Returns (du, dv, passes).  A half-sweep
    writes a second buffer, so every block reads the iterate it started
    from."""
    a1, a2, a4, _, bu, bv = sysm
    h, w = bu.shape
    blocks = row_blocks(h, w, block_rows)
    red = (torch.arange(h, device=bu.device)[:, None] + torch.arange(w, device=bu.device)) % 2 == 0
    b = torch.stack([bu, bv])
    rdet = torch.empty_like(bu)
    resid = _Sum(acc)
    for r0, r1 in blocks:
        rdet[r0:r1] = 1.0 / (a1[r0:r1] * a4[r0:r1] - a2[r0:r1] * a2[r0:r1])
        resid.add(b[:, r0:r1], b[:, r0:r1])
    resid = resid.value(b.dtype)
    x = torch.zeros_like(b)
    spare = torch.empty_like(x)

    def half(x, out, mask, want_resid: bool):
        total = _Sum(acc)
        for r0, r1 in blocks:
            s0, s1 = _slab(r0, r1, h, 1)
            sb = _rows(sysm, r0, r1)
            r = b[:, r0:r1] - apply_a(sb, x[:, s0:s1], r0 - s0)
            d = torch.stack([(sb[2] * r[0] - sb[1] * r[1]) * rdet[r0:r1],
                             (sb[0] * r[1] - sb[1] * r[0]) * rdet[r0:r1]])
            out[:, r0:r1] = torch.where(mask[r0:r1], x[:, r0:r1] + omega * d, x[:, r0:r1])
            if want_resid:
                total.add(r, r)
        return out, x, (total.value(b.dtype) if want_resid else None)

    s_main = min(PASS_SWEEPS, iters)
    n_main, s_rem = divmod(iters, s_main)
    sizes = [s_main] * n_main + ([s_rem] if s_rem else [])
    passes = 0
    for sweeps in sizes:
        if not float(resid) > tol:
            break
        x, spare, entry = half(x, spare, red, True)
        x, spare, _ = half(x, spare, ~red, False)
        for _ in range(sweeps - 1):
            x, spare, _ = half(x, spare, red, False)
            x, spare, _ = half(x, spare, ~red, False)
        resid = entry
        passes += 1
    return x[0], x[1], passes


def system(stack, g1, gx1, gy1, u, v, uhat, vhat, al1, alpha, lam_a, lambdac, dozim,
           block_rows: int = None):
    """``assemble`` of the warped samples, block by block: the system's
    planes (a1, a2, a4, off or None, bu, bv)."""
    h, w = u.shape
    planes = None
    for r0, r1 in row_blocks(h, w, block_rows):
        s0, s1 = _slab(r0, r1, h, 1)
        samples, bc_x, bc_y = warp(stack, u[r0:r1], v[r0:r1], r0)
        part = assemble(samples, bc_x, bc_y, g1[:, r0:r1], gx1[:, r0:r1], gy1[:, r0:r1],
                        u[s0:s1], v[s0:s1], uhat[r0:r1], vhat[r0:r1], al1, alpha, lam_a,
                        lambdac, dozim, r0 - s0)
        del samples, bc_x, bc_y
        a1, a2, a4, off, bu, bv = part
        flat = [a1, a2, a4, bu, bv] + (off or [])
        if planes is None:
            planes = [t.new_empty((h, w)) for t in flat]
        for dst, src in zip(planes, flat):
            dst[r0:r1] = src
    a1, a2, a4, bu, bv = planes[:5]
    return a1, a2, a4, (planes[5:] or None), bu, bv


def level_schedule(s: dict, h: int, w: int):
    """(k, factor, (rows, cols), lambdac_k) of each level, coarsest first."""
    for k in range(s["kiters"]):
        factor = float(np.float32(s["scale_factor"]) ** (s["kiters"] - k - 1))
        yield k, factor, (zoom_size(h, factor), zoom_size(w, factor)), \
            (s["lambdac"] / s["alpha"]) * (0.5 ** k)


def solve(geo1, geo2, u0, v0, s: dict, solver: str, dtype=torch.float32, acc=None,
          block_rows: int = None):
    """The coarse-to-fine solve of (C, H, W) float32 images from the first
    guess (u0, v0), in ``dtype``, the relaxers' dot products summed in
    ``acc`` (default: ``dtype``): (u, v) float32 and the relaxer's
    iterations (PCG) or passes (SOR)."""
    geo1, geo2, u0, v0 = (t.to(dtype) for t in (geo1, geo2, u0, v0))
    c, h, w = geo1.shape
    alpha, lam_a = _f32(s["alpha"]), _f32(s["lambda_"] / s["alpha"])
    tol = _f32(s["cg_tol"])
    work = 0
    u = v = None
    for k, factor, shape, lambdac in level_schedule(s, h, w):
        lambdac = _f32(lambdac)
        if k == s["kiters"] - 1:
            g1, g2, uhat, vhat = geo1, geo2, u0, v0
        else:
            g1, g2 = downsample(geo1, factor, block_rows), downsample(geo2, factor, block_rows)
            uhat = downsample(u0[None], factor, block_rows)[0] * _f32(factor)
            vhat = downsample(v0[None], factor, block_rows)[0] * _f32(factor)
        if k == 0:
            u, v = uhat, vhat
        else:
            uv = zoom_flow(torch.stack([u, v]), shape, s["scale_factor"])
            u, v = uv[0], uv[1]
            del uv
        gx1, gy1 = gradients(g1, block_rows)
        # the level's stack: g2 and its derivatives, each made in its slot
        stack = g2.new_empty((6 * c,) + tuple(shape))
        stack[:c] = g2
        del g2
        _derivative(stack[:c], -1, stack[c:2 * c], block_rows)
        _derivative(stack[:c], -2, stack[2 * c:3 * c], block_rows)
        _derivative(stack[c:2 * c], -1, stack[3 * c:4 * c], block_rows)
        _derivative(stack[2 * c:3 * c], -1, stack[4 * c:5 * c], block_rows)
        _derivative(stack[2 * c:3 * c], -2, stack[5 * c:], block_rows)
        for step in range(s["gnc_steps"]):
            al1 = 1.0 - 0.5 * step
            for _ in range(s["liters"]):
                sysm = system(stack, g1, gx1, gy1, u, v, uhat, vhat, al1, alpha, lam_a,
                              lambdac, s["dozim"], block_rows)
                if solver == "sor":
                    du, dv, n = sor(sysm, tol, s["cgiters"], s["sor_omega"], acc, block_rows)
                else:
                    du, dv, n = pcg(sysm, tol, s["cgiters"], acc, block_rows)
                del sysm
                u, v = u + du, v + dv
                del du, dv
                work += n
        del stack, g1, gx1, gy1
    return u.to(torch.float32), v.to(torch.float32), work


# --------------------------------------------------------------------------
# pixels -> winds (oct_pix2uv_cuda.cu:27-172, 265-370)
# --------------------------------------------------------------------------

def _latlon(x, y, nav):
    """Scan angles -> (lat, lon) degrees, -999 off the earth."""
    req, rpol = nav["req"], nav["rpol"]
    h_sat = nav["pph"] + req
    ratio = (req * req) / (rpol * rpol)
    sinx, cosx, siny, cosy = torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)
    a = sinx * sinx + cosx * cosx * (cosy * cosy + ratio * siny * siny)
    b = -2.0 * h_sat * cosx * cosy
    c = h_sat * h_sat - req * req
    d = b * b - 4.0 * a * c
    rs = (-b - torch.sqrt(torch.clamp(d, min=0.0))) / (2.0 * a)
    sx, sy, sz = rs * cosx * cosy, -rs * sinx, rs * cosx * siny
    e = (h_sat - sx) ** 2 + sy * sy
    lat = torch.atan(ratio * sz / torch.sqrt(e)) / DTOR
    lon = (nav["lpo"] * DTOR - torch.atan2(sy, h_sat - sx)) / DTOR
    bad = (d < 0) | (sz == 0) | (e <= 0)
    return torch.where(bad, -999.0, lat), torch.where(bad, -999.0, lon)


def _haversine(lat1, lon1, lat2, lon2):
    sdlat = torch.sin((lat2 - lat1) * (DTOR / 2.0))
    sdlon = torch.sin((lon2 - lon1) * (DTOR / 2.0))
    a = sdlat * sdlat + torch.cos(lat1 * DTOR) * torch.cos(lat2 * DTOR) * sdlon * sdlon
    return EARTH_RADIUS * 2.0 * torch.atan2(torch.sqrt(a), torch.sqrt(1.0 - a))


def winds(u, v, nav: dict, dt: float, prec: Precision = REFERENCE, block_rows: int = None):
    """(U, V, U_raw, V_raw) int16: trunc(100 m/s) of the zonal and
    meridional great-circle distances between each pixel and its displaced
    end point over ``dt`` s (0 off the earth and beyond the limb,
    0.021 rad^2), and trunc(100 px)."""
    t = prec.nav
    h, w = u.shape
    out = [torch.empty((h, w), device=u.device, dtype=torch.int16) for _ in range(4)]
    ii = torch.arange(w, device=u.device, dtype=t)[None, :]
    x0 = ii * nav["x_scale"] + nav["x_offset"]

    def short(a):
        return torch.trunc(100.0 * a).to(torch.int16)
    for r0, r1 in row_blocks(h, w, block_rows):
        ub, vb = u[r0:r1], v[r0:r1]
        jj = torch.arange(r0, r1, device=u.device, dtype=t)[:, None]
        y0 = jj * nav["y_scale"] + nav["y_offset"]
        x1 = (ub.to(t) + ii) * nav["x_scale"] + nav["x_offset"]
        y1 = (vb.to(t) + jj) * nav["y_scale"] + nav["y_offset"]
        lat0, lon0 = _latlon(x0.expand(r1 - r0, w), y0.expand(r1 - r0, w), nav)
        lat1, lon1 = _latlon(x1, y1, nav)
        bad = (lat0 < -998.0) | (lat1 < -998.0) | ((x0 * x0 + y0 * y0) > 0.021)
        du = _haversine(lat0, lon0, lat0, lon1)
        dv = _haversine(lat0, lon0, lat1, lon0)
        uw = torch.where(bad, 0.0, torch.where(lon1 >= lon0, du, -du) / dt)
        vw = torch.where(bad, 0.0, torch.where(lat1 >= lat0, dv, -dv) / dt)
        for dst, src in zip(out, (uw, vw, ub, vb)):
            dst[r0:r1] = short(src)
    return tuple(out)
