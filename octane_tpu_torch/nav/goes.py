"""GOES-R ABI fixed-grid navigation and calibration in float64
(counterpart of octane_tpu.nav.goes; oct_navcal_cuda.cu and the forward
navigation of oct_pix2uv_cuda.cu:222-263).

Everything runs in float64, as the reference computes navigation in
double: haversine wind differences of nearby points are
cancellation-sensitive.  The projection constants are Python floats
(double), applied to float64 tensors.

``navcal_goes`` works in blocks of whole rows of at most ``BLOCK_PIXELS``
pixels (``row_blocks``), each written into output planes allocated once,
so its float64 working set is a dozen block planes, not a dozen image
planes (a 21696 x 21696 plane is 3.77 GB in float64).  Every step is
elementwise, on each pixel's own values, so a plane's values do not
depend on the blocks; a 5424 x 5424 plane is one block.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

DTOR = math.pi / 180.0
F64 = torch.float64


BLOCK_PIXELS = 1 << 25      # the most pixels of a row block of navcal_goes and nav.winds


def row_blocks(h: int, w: int):
    """[(r0, r1)]: rows [0, h) of a w-wide plane in blocks of at most
    ``BLOCK_PIXELS`` pixels (at least one row)."""
    n = max(1, BLOCK_PIXELS // max(w, 1))
    return [(r0, min(h, r0 + n)) for r0 in range(0, h, n)]


def goes_latlon(xval: torch.Tensor, yval: torch.Tensor, nav, guard: bool = True):
    """Scan angles (rad) -> (lat, lon) degrees on the GRS80 ellipsoid
    (oct_navcal_cuda.cu:36-49; guarded variant oct_pix2uv_cuda.cu:108-140).
    ``guard=True`` gives -999 fills off the earth, otherwise NaN."""
    xval = xval.to(F64)
    yval = yval.to(F64)
    req, rpol = float(nav.req), float(nav.rpol)
    h_sat = float(nav.pph) + req
    sinx, cosx = torch.sin(xval), torch.cos(xval)
    siny, cosy = torch.sin(yval), torch.cos(yval)
    ratio = (req * req) / (rpol * rpol)
    a = sinx * sinx + cosx * cosx * (cosy * cosy + ratio * siny * siny)
    b = -2.0 * h_sat * cosx * cosy
    c = h_sat * h_sat - req * req
    d = b * b - 4.0 * a * c
    rs = (-b - torch.sqrt(torch.clamp(d, min=0.0))) / (2.0 * a)
    sx = rs * cosx * cosy
    sy = -rs * sinx
    sz = rs * cosx * siny
    hx = h_sat - sx
    e = hx * hx + sy * sy
    lat = torch.atan(ratio * sz / torch.sqrt(e)) / DTOR
    lon = (float(nav.lam0) - torch.atan2(sy, h_sat - sx)) / DTOR
    if guard:
        bad = (d < 0) | (sz == 0) | (e <= 0)
        lat = torch.where(bad, -999.0, lat)
        lon = torch.where(bad, -999.0, lon)
    else:
        nanify = torch.where(d < 0, torch.full_like(d, math.nan),
                             torch.zeros_like(d))
        lat = lat + nanify
        lon = lon + nanify
    return lat, lon


def goes_xy_from_latlon(lat_deg: torch.Tensor, lon_deg: torch.Tensor, nav):
    """(lat, lon) degrees -> scan angles (rad); -999 off the visible disk
    (octuv2xy, oct_pix2uv_cuda.cu:246-261)."""
    lat = lat_deg.to(F64) * DTOR
    lon = lon_deg.to(F64) * DTOR
    req, rpol = float(nav.req), float(nav.rpol)
    req2, rpol2 = req * req, rpol * rpol
    h_sat = float(nav.pph) + req
    ecc2 = (req2 - rpol2) / req2
    thtc = torch.atan((rpol2 / req2) * torch.tan(lat))
    cth = torch.cos(thtc)
    rc = rpol / torch.sqrt(1.0 - ecc2 * (cth * cth))
    dlon = lon - float(nav.lam0)
    sx = h_sat - rc * cth * torch.cos(dlon)
    sy = -rc * cth * torch.sin(dlon)
    sz = rc * torch.sin(thtc)
    visible = (h_sat * (h_sat - sx)) >= (sy * sy + (req2 / rpol2) * sz * sz)
    xs = torch.asin(-sy / torch.sqrt(sx * sx + sy * sy + sz * sz))
    ys = torch.atan(sz / sx)
    return torch.where(visible, xs, -999.0), torch.where(visible, ys, -999.0)


def planck_temp(rad, fk1: float, fk2: float, bc1: float, bc2: float) -> torch.Tensor:
    """Inverse Planck: radiance -> brightness temperature (K)
    (oct_navcal_cuda.cu:61-65)."""
    rad = torch.as_tensor(rad).to(F64)
    return (fk2 / torch.log(fk1 / rad + 1.0) - bc1) / bc2


def kappa_reflectance(rad, kap1: float) -> torch.Tensor:
    """Radiance -> reflectance factor (oct_navcal_cuda.cu:66-70)."""
    return torch.as_tensor(rad).to(F64) * kap1


def limb_ramp(subpoint_dist2: torch.Tensor) -> torch.Tensor:
    """Limb filter: 1 below 0.021 rad^2, 0 from 0.0212, linear between
    (oct_navcal_cuda.cu:81-92)."""
    slope = 1.0 / (0.021 - 0.0212)
    intercept = 1.0 - 0.021 * slope
    d = subpoint_dist2.to(F64)
    return torch.where(d < 0.021, 1.0,
                       torch.where(d >= 0.0212, 0.0, slope * d + intercept))


def scan_angles(x_counts: torch.Tensor, y_counts: torch.Tensor, nav):
    """The float64 scan angles (rad) of the (W,) column and (H,) row
    counts: (xval, yval)."""
    return (x_counts.to(F64) * nav.x_scale + nav.x_offset,
            y_counts.to(F64) * nav.y_scale + nav.y_offset)


def navigate_goes(x_counts: torch.Tensor, y_counts: torch.Tensor, nav):
    """(lat, lon) float64 degrees, NaN off the earth, of the (H, W) image
    of (W,) column and (H,) row scan-coordinate counts, in row blocks: the
    navigation of ``navcal_goes``."""
    xval, yval = scan_angles(x_counts, y_counts, nav)
    h, w = yval.shape[0], xval.shape[0]
    lat = torch.empty((h, w), dtype=F64, device=xval.device)
    lon = torch.empty((h, w), dtype=F64, device=xval.device)
    for r0, r1 in row_blocks(h, w):
        lat[r0:r1], lon[r0:r1] = goes_latlon(*_grid(xval, yval, r0, r1), nav, guard=False)
    return lat, lon


def _grid(xval, yval, r0: int, r1: int):
    """The (r1 - r0, W) scan angles of rows [r0, r1), as broadcast views."""
    shape = (r1 - r0, xval.shape[0])
    return xval[None, :].expand(shape), yval[r0:r1, None].expand(shape)


def navcal_goes(
    counts: torch.Tensor, x_counts: torch.Tensor, y_counts: torch.Tensor, nav,
    channel: int = 0, cal: str = "RAW", norm_min: float = 0.0, norm_max: float = 255.0,
    out_min: float = 0.0, out_max: float = 255.0, donav: bool = True,
    dtype: torch.dtype = F64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Navigation + calibration + normalisation of one GOES channel.

    counts: (H, W) raw counts; x_counts/y_counts: (W,)/(H,) scan-coordinate
    counts.  ``cal`` is "TEMP" (brightness temperature, ``planck_temp``),
    "REF" (reflectance, ``kappa_reflectance``), or "RAW" / "BRIT" (the
    radiance itself; the reader uses "RAW").  Returns (data_norm, lat,
    lon): the limb-filtered data mapped from [norm_min, norm_max] to
    [out_min, out_max] (octnavcalcuda, oct_navcal_cuda.cu:11-98), computed
    in float64 and stored as ``dtype``, and float64 lat/lon, zeros without
    ``donav`` (a broadcast zero that holds no plane).  Works in row blocks
    (``row_blocks``).
    """
    if cal not in ("TEMP", "REF", "RAW", "BRIT"):
        raise ValueError(f"navcal_goes: cal must be TEMP, REF, RAW or BRIT, got {cal!r}")
    h, w = counts.shape
    dev = counts.device
    xval, yval = scan_angles(x_counts, y_counts, nav)               # (W,), (H,)
    data = torch.empty((h, w), dtype=dtype, device=dev)
    if donav:
        lat, lon = navigate_goes(x_counts, y_counts, nav)
    else:
        lat = lon = torch.zeros((), dtype=F64, device=dev).expand(h, w)
    for r0, r1 in row_blocks(h, w):
        xg, yg = _grid(xval, yval, r0, r1)
        sub2 = xg * xg + yg * yg
        dval = counts[r0:r1].to(F64) * nav.rad_scale[channel] + nav.rad_offset[channel]
        if cal == "TEMP":
            dataf = planck_temp(dval, nav.fk1[channel], nav.fk2[channel],
                                nav.bc1[channel], nav.bc2[channel])
        elif cal == "REF":
            dataf = kappa_reflectance(dval, nav.kap1[channel])
        else:
            dataf = dval
        data[r0:r1] = limb_ramp(sub2) * ((dataf - norm_min) / (norm_max - norm_min)
                                         * (out_max - out_min) + out_min)
    return data, lat, lon
