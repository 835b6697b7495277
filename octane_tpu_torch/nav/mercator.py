"""Spherical Mercator inverse navigation in float64 (counterpart of
octane_tpu.nav.mercator; octmercnavcalcuda, oct_merc_navcal_cuda.cu:11-49).

lon = x / R + lon1, lat = pi / 2 - 2 atan(exp(-y / R)) on a sphere of radius
``nav.R``; ``nav.lon1`` is the reference longitude in radians (the reader
converts the file's degrees, as oct_merc_navcal_cuda.cu:45 does).
"""

from __future__ import annotations

import math

import torch

from octane_tpu_torch.nav.goes import F64

DTOR = math.pi / 180.0


def mercator_latlon(xval: torch.Tensor, yval: torch.Tensor, nav):
    """Projected metres (x, y) -> float64 (lat, lon) in degrees."""
    xval = xval.to(F64)
    yval = yval.to(F64)
    r_sphere = float(nav.R)
    lon = xval / r_sphere + float(nav.lon1)
    lat = math.pi / 2.0 - 2.0 * torch.atan(torch.exp(-yval / r_sphere))
    return lat / DTOR, lon / DTOR
