"""Pixel displacement <-> wind (m/s) in float64 (counterpart of
octane_tpu.nav.winds; oct_pix2uv_cuda.cu).

Forward (``pix2uv``): each pixel and its displaced end point are navigated
to lat/lon (GOES fixed grid, polar or mercator); the zonal and meridional
haversine distances over the frame interval give the wind (:27-172).
Inverse (``uv2pix``, the first guess): each pixel's lat/lon is advected
along a great circle by wind * dt and navigated back to fixed-grid pixel
offsets (octuv2xy, :222-263; oct_uv2pix, :372-476).  Guards: a moved
mesoscale sector zeroes all motions (:295, 358-369); on the GOES grid
off-earth or limb pixels (subpoint distance > 0.021 rad^2) get zero winds
(:144-147), and first-guess points off the visible disk zero displacement;
shorts are trunc(100 * value).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from octane_tpu_torch.nav.goes import F64, goes_latlon, goes_xy_from_latlon, row_blocks
from octane_tpu_torch.nav.mercator import mercator_latlon
from octane_tpu_torch.nav.polar import polar_latlon

DTOR = math.pi / 180.0
EARTH_RADIUS = 6371000.0


def _short100(x: torch.Tensor) -> torch.Tensor:
    """C-style short(100*x) encoding (truncation toward zero)."""
    return torch.trunc(100.0 * x).to(torch.int16)


def haversine_m(lat1, lon1, lat2, lon2):
    """Great-circle distance in metres, inputs in degrees
    (oct_haversine_cuda, oct_pix2uv_cuda.cu:12-25)."""
    rad, rad2 = DTOR, DTOR / 2.0
    sdlat = torch.sin((lat2 - lat1) * rad2)
    sdlon = torch.sin((lon2 - lon1) * rad2)
    a = sdlat * sdlat + torch.cos(lat1 * rad) * torch.cos(lat2 * rad) * (sdlon * sdlon)
    c = 2.0 * torch.atan2(torch.sqrt(a), torch.sqrt(1.0 - a))
    return EARTH_RADIUS * c


def _sector_moved(nav) -> bool:
    return ((nav.x_offset - nav.g2x_offset) ** 2 >= 1e-5 ** 2
            or (nav.y_offset - nav.g2y_offset) ** 2 >= 1e-5 ** 2)


def _pixel_scan_positions(nav, u_pix, v_pix, row0: int = 0):
    """Scan coordinates of each pixel and of its displaced end point
    (oct_pix2uv_cuda.cu:40-44, 192): pixel indices + nav.min_x/min_y.  The
    fields are the image's rows from ``row0`` on (a band of the mesh path)."""
    h, w = u_pix.shape
    ii = torch.arange(w, dtype=F64, device=u_pix.device)[None, :] + nav.min_x
    jj = torch.arange(row0, row0 + h, dtype=F64, device=u_pix.device)[:, None] + nav.min_y
    x0 = ii * nav.x_scale + nav.x_offset
    y0 = jj * nav.y_scale + nav.y_offset
    x1 = (u_pix.to(F64) + ii) * nav.x_scale + nav.x_offset
    y1 = (v_pix.to(F64) + jj) * nav.y_scale + nav.y_offset
    return x0, y0, x1, y1


def pix2uv_ms(u_pix, v_pix, nav, dt: float, grid: str = "goes",
              row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel displacements -> float64 winds in m/s (zeros where invalid;
    flat grids have no invalid pixel); ``row0``: the global row of the
    fields' first row.  Computed in row blocks (``nav.goes.row_blocks``),
    each pixel from its own values alone."""
    uw = torch.empty(u_pix.shape, dtype=F64, device=u_pix.device)
    vw = torch.empty(u_pix.shape, dtype=F64, device=u_pix.device)
    for r0, r1 in row_blocks(*u_pix.shape):
        uw[r0:r1], vw[r0:r1] = _winds_ms(u_pix[r0:r1], v_pix[r0:r1], nav, dt, grid, row0 + r0)
    return uw, vw


def _winds_ms(u_pix, v_pix, nav, dt: float, grid: str, row0: int):
    """``pix2uv_ms`` of rows from ``row0`` on, in one piece."""
    x0, y0, x1, y1 = _pixel_scan_positions(nav, u_pix, v_pix, row0)
    if grid in ("polar", "mercator"):
        latlon = polar_latlon if grid == "polar" else mercator_latlon
        lat0, lon0 = latlon(x0, y0, nav)
        lat1, lon1 = latlon(x1, y1, nav)
        invalid = None
    else:
        lat0, lon0 = goes_latlon(x0, y0, nav, guard=True)
        lat1, lon1 = goes_latlon(x1, y1, nav, guard=True)
        limb = (x0 * x0 + y0 * y0) > 0.021      # sds[0] threshold (:144)
        invalid = (lat0 < -998.0) | (lat1 < -998.0) | limb
    du = haversine_m(lat0, lon0, lat0, lon1)
    dv = haversine_m(lat0, lon0, lat1, lon0)
    uw = torch.where(lon1 >= lon0, du, -du) / dt
    vw = torch.where(lat1 >= lat0, dv, -dv) / dt
    if invalid is None:
        return uw, vw
    return torch.where(invalid, 0.0, uw), torch.where(invalid, 0.0, vw)


def pix2uv(u_pix, v_pix, nav, dt: float, grid: str = "goes",
           pixuv: bool = False, row0: int = 0):
    """(u_wind, v_wind, u_raw, v_raw) int16: 100*m/s and 100*pixels
    (oct_pix2uv_cuda.cu:265-370); ``row0`` as in pix2uv_ms.  The float64
    winds live a row block at a time (``nav.goes.row_blocks``)."""
    u_raw = _short100(u_pix)
    v_raw = _short100(v_pix)
    if _sector_moved(nav):
        z = torch.zeros(u_pix.shape, dtype=torch.int16, device=u_pix.device)
        return z, z, z, z
    if pixuv:
        return u_raw, v_raw, u_raw, v_raw
    uw = torch.empty(u_pix.shape, dtype=torch.int16, device=u_pix.device)
    vw = torch.empty(u_pix.shape, dtype=torch.int16, device=u_pix.device)
    for r0, r1 in row_blocks(*u_pix.shape):
        ums, vms = _winds_ms(u_pix[r0:r1], v_pix[r0:r1], nav, dt, grid, row0 + r0)
        uw[r0:r1], vw[r0:r1] = _short100(ums), _short100(vms)
    return uw, vw, u_raw, v_raw


def uv2pix(u_wind, v_wind, lat, lon, x_counts, y_counts, nav, dt: float,
           grid: str = "goes") -> Tuple[torch.Tensor, torch.Tensor]:
    """Navigated winds (m/s) -> float32 pixel displacements over ``dt`` s.

    ``lat``/``lon`` are the (H, W) navigation of the image (degrees, NaN
    off the earth), ``x_counts``/``y_counts`` its (W,)/(H,) scan-coordinate
    counts.  Points that leave the visible disk and moved sectors get zero
    displacement.  ``grid`` is ignored: every grid is navigated back
    through the GOES fixed grid, as octane_tpu.nav.winds.uv2pix does."""
    if _sector_moved(nav):
        z = torch.zeros(u_wind.shape, dtype=torch.float32, device=u_wind.device)
        return z, z
    u = u_wind.to(F64)
    v = v_wind.to(F64)
    dist = torch.sqrt(u * u + v * v) * dt
    brng = (180.0 + (90.0 - torch.atan2(-v, -u) / DTOR)) * DTOR
    lat0 = lat.to(F64) * DTOR
    dr = dist / EARTH_RADIUS
    lat_new = torch.asin(torch.sin(lat0) * torch.cos(dr)
                         + torch.cos(lat0) * torch.sin(dr) * torch.cos(brng))
    lon_new = lon.to(F64) * DTOR + torch.atan2(
        torch.sin(brng) * torch.sin(dr) * torch.cos(lat0),
        torch.cos(dr) - torch.sin(lat0) * torch.sin(lat_new))
    xs, ys = goes_xy_from_latlon(lat_new / DTOR, lon_new / DTOR, nav)
    x1v = (xs - nav.x_offset) / nav.x_scale
    y1v = (ys - nav.y_offset) / nav.y_scale
    xc = x_counts.to(F64)[None, :]
    yc = y_counts.to(F64)[:, None]
    ok = xs > -998.0
    u_pix = torch.where(ok, x1v - xc, 0.0).to(torch.float32)
    v_pix = torch.where(ok, y1v - yc, 0.0).to(torch.float32)
    return u_pix, v_pix
