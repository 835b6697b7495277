"""The GOES-R fixed grid and band calibration of a configuration, as an L1b
file gives them: int16 scan-coordinate counts x (W,) and y (H,) with their
float32 scale and offset, the imager projection and the band's count,
Planck and kappa0 constants.  A frozen copy of what the port's reader
returns for such a file (tests/torch_fixtures.goes_arrays), in plain numpy
and floats.  A reflective band's file (bands 1-6) carries kappa0 and no
usable Planck constants: a calibration without them reads 0 for each, as
the port's NavConstants defaults do.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def f32(v) -> float:
    """A float as the file stores it (float32)."""
    return float(np.float32(v))


def nav_constants(cfg: dict) -> dict:
    """The NavConstants fields of a configuration's grid and band, by the
    port's field names (tuples hold channel 1 first)."""
    cal = cfg["calibration"]
    return dict(
        grid="goes",
        x_scale=f32(cfg["x_scale"]), y_scale=f32(cfg["y_scale"]),
        x_offset=f32(cfg["x_offset"]), y_offset=f32(cfg["y_offset"]),
        req=float(cfg["req"]), rpol=float(cfg["rpol"]), pph=float(cfg["pph"]),
        lpo=float(cfg["lpo"]), lat0=0.0, gip_val=0.0,
        inverse_flattening=float(cfg["inverse_flattening"]),
        rad_scale=(f32(cal["rad_scale"]), 1.0, 1.0), rad_offset=(f32(cal["rad_offset"]), 0.0, 0.0),
        **{k: (f32(cal.get(k, 0.0)), 0.0, 0.0) for k in ("fk1", "fk2", "bc1", "bc2")},
        kap1=(f32(cal["kap1"]), 0.0, 0.0))


def scan_counts(cfg: dict):
    """(x (W,), y (H,)) int16 scan-coordinate counts, 0 .. n - 1."""
    return (np.arange(cfg["cols"], dtype=np.int16), np.arange(cfg["rows"], dtype=np.int16))


def scan_angles(cfg: dict, device, dtype=torch.float32):
    """(x (1, W), y (H, 1)) scan angles in radians."""
    nav = nav_constants(cfg)
    x = torch.arange(cfg["cols"], device=device, dtype=dtype) * nav["x_scale"] + nav["x_offset"]
    y = torch.arange(cfg["rows"], device=device, dtype=dtype) * nav["y_scale"] + nav["y_offset"]
    return x[None, :], y[:, None]


def _surface(cfg: dict, device, dtype):
    """The earth point seen at every pixel: (sx, sy, sz, on-earth mask,
    satellite distance, req^2 / rpol^2)."""
    nav = nav_constants(cfg)
    x, y = scan_angles(cfg, device, dtype)
    req, rpol = nav["req"], nav["rpol"]
    h_sat = nav["pph"] + req
    ratio = (req * req) / (rpol * rpol)
    sinx, cosx, siny, cosy = torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)
    a = sinx * sinx + cosx * cosx * (cosy * cosy + ratio * siny * siny)
    b = -2.0 * h_sat * cosx * cosy
    c = h_sat * h_sat - req * req
    d = b * b - 4.0 * a * c
    on = d >= 0
    rs = (-b - torch.sqrt(torch.clamp(d, min=0.0))) / (2.0 * a)
    return rs * cosx * cosy, -rs * sinx, rs * cosx * siny, on, h_sat, ratio


def earth_latlon(cfg: dict, device, dtype=torch.float32):
    """(lat degrees, on-earth mask) of every pixel; lat is 0 off the earth."""
    sx, sy, sz, on, h_sat, ratio = _surface(cfg, device, dtype)
    lat = torch.atan(ratio * sz / torch.sqrt((h_sat - sx) ** 2 + sy * sy)) * (180.0 / math.pi)
    return torch.where(on, lat, torch.zeros_like(lat)), on


def earth_lon(cfg: dict, device, dtype=torch.float32):
    """Longitude degrees east of every pixel; 0 off the earth."""
    sx, sy, _, on, h_sat, _ = _surface(cfg, device, dtype)
    lon = cfg["lpo"] - torch.atan2(sy, h_sat - sx) * (180.0 / math.pi)
    return torch.where(on, lon, torch.zeros_like(lon))
