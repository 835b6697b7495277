"""Orthographic polar-grid inverse navigation in float64 (counterpart of
octane_tpu.nav.polar; octpolarnavcalcuda, oct_polar_navcal_cuda.cu:11-65).

The rho / c great-circle formulas on a sphere of radius ``nav.R`` about the
reference point (``nav.lat1``, ``nav.lon0_deg``), both in degrees.  Polar
grids carry no calibration: their data pass through (ref :60).
"""

from __future__ import annotations

import math

import torch

from octane_tpu_torch.nav.goes import F64

DTOR = math.pi / 180.0


def polar_latlon(xval: torch.Tensor, yval: torch.Tensor, nav):
    """Projected metres (x, y) -> float64 (lat, lon) in degrees."""
    xval = xval.to(F64)
    yval = yval.to(F64)
    lat1 = float(nav.lat1) * DTOR
    lon0 = float(nav.lon0_deg) * DTOR
    r_sphere = float(nav.R)
    rho = torch.sqrt(xval * xval + yval * yval)
    c = torch.asin(torch.clamp(rho / r_sphere, -1.0, 1.0))
    if nav.lat1 > 89.9999:
        lon = lon0 + torch.atan2(xval, -yval)
    else:
        lon = lon0 + torch.atan2(
            xval * torch.sin(c),
            rho * math.cos(lat1) * torch.cos(c) - yval * math.sin(lat1) * torch.sin(c))
    near = rho > 1e-7
    lat = torch.where(
        near,
        torch.asin(torch.cos(c) * math.sin(lat1)
                   + torch.where(near, yval * torch.sin(c) * math.cos(lat1)
                                 / torch.where(near, rho, 1.0), 0.0)),
        lat1)
    return lat / DTOR, lon / DTOR
