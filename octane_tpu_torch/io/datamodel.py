"""In-memory data model (counterpart of octane_tpu.io.datamodel).

``Scene`` has the JAX package's fields, with tensors where that package
holds numpy arrays; ``scene_from_numpy`` carries a JAX-package scene
(``dataclasses.asdict``) over to the port.  A scene's ``lat`` and ``lon``
may be deferred (``Scene.defer_navigation``): the reader then leaves the
two float64 planes uncomputed until something reads them, which on a pair
of winds only a first guess from winds does.  Whatever reads every field
reads them too: ``dataclasses.asdict``, ``dataclasses.replace``, ``==`` and
``repr`` of a deferred scene compute its navigation (7.5 GB of float64 at
21696 x 21696).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class NavConstants:
    """Projection + calibration constants (reference GOESNAVVar, goesread.h:3-14)."""

    grid: str = "goes"                # "goes" | "polar" | "mercator"
    nx: int = 0
    ny: int = 0
    # fixed-grid projection
    x_scale: float = 0.0              # rad / count
    x_offset: float = 0.0
    y_scale: float = 0.0
    y_offset: float = 0.0
    req: float = 6378137.0            # GRS80 semi-major (m)
    rpol: float = 6356752.31414       # GRS80 semi-minor (m)
    pph: float = 35786023.0           # perspective point height (m)
    lam0: float = 0.0                 # longitude of projection origin (rad)
    lpo: float = 0.0                  # same, degrees (as read)
    lat0: float = 0.0
    inverse_flattening: float = 298.2572221
    gip_val: float = 0.0
    # second-image offsets (sector-move guard, oct_pix2uv_cuda.cu:295)
    g2x_offset: float = 0.0
    g2y_offset: float = 0.0
    # polar / mercator grids
    lat1: float = 0.0
    lon0_deg: float = 0.0
    lon1: float = 0.0
    R: float = 6371000.0
    # per-channel calibration (up to 3 channels)
    rad_scale: tuple = (1.0, 1.0, 1.0)
    rad_offset: tuple = (0.0, 0.0, 0.0)
    fk1: tuple = (0.0, 0.0, 0.0)
    fk2: tuple = (0.0, 0.0, 0.0)
    bc1: tuple = (0.0, 0.0, 0.0)
    bc2: tuple = (0.0, 0.0, 0.0)
    kap1: tuple = (0.0, 0.0, 0.0)
    # subset bookkeeping (oct_fileread.cc:266-340)
    min_x: int = 0
    min_y: int = 0
    max_x: int = 0
    max_y: int = 0
    min_xc: int = 0
    min_yc: int = 0
    max_xc: int = 0
    max_yc: int = 0
    cth_nx: int = 0
    cth_ny: int = 0


Tensor = Optional[torch.Tensor]


class _Navigation:
    """A Scene's ``lat`` or ``lon``: the tensor set, or, while the scene's
    navigation is deferred, both planes computed on the first read of
    either (``Scene.defer_navigation``), also by an operation on the whole
    dataclass (asdict, replace, ==, repr).  Its default is None."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, scene, owner=None):
        if scene is None:
            return None
        state = scene.__dict__
        navigate = state.pop("_navigate", None)
        if navigate is not None:
            state["lat"], state["lon"] = navigate()
        return state.get(self.name)

    def __set__(self, scene, value):
        scene.__dict__.pop("_navigate", None)
        scene.__dict__[self.name] = value


@dataclasses.dataclass
class Scene:
    """One satellite image + derived products (reference GOESVar).

    ``data`` is the normalised [0, 255] float32 stack (C, H, W) on the
    compute device; the other arrays are tensors on the same device.
    """

    nav: NavConstants
    data: torch.Tensor                 # (C, H, W) float32, normalised
    t: float = 0.0                     # J2000 epoch seconds (image time)
    t_units: str = ""
    band: tuple = (0, 0, 0)
    x: Tensor = None                   # (W,) int16 scan-coordinate counts
    y: Tensor = None                   # (H,) int16
    raw_counts: Tensor = None          # (C, H, W) int16 (float32 on flat grids)
    lat: Tensor = _Navigation()        # (H, W) float64 degrees
    lon: Tensor = _Navigation()
    cth: Tensor = None                 # (H, W) cloud-top height (m)
    ufg: Tensor = None                 # (H, W) first-guess winds (m/s)
    vfg: Tensor = None
    norm_ranges: tuple = ((0.0, 255.0),) * 3
    # flow products
    u_pix: Tensor = None               # (H, W) float32 pixel displacement
    v_pix: Tensor = None
    u_wind: Tensor = None              # (H, W) int16, 100 * m/s
    v_wind: Tensor = None
    u_ms: Tensor = None                # (H, W) float64 m/s (flat grids)
    v_ms: Tensor = None
    u_raw: Tensor = None               # (H, W) int16, 100 * pixels
    v_raw: Tensor = None
    ctp: Tensor = None                 # (H, W) int16 motion-vector height
    occlusion: Tensor = None           # (H, W) int16 (temporal interp)
    dt: float = 0.0                    # t2 - t1 seconds
    frdt: float = 0.0
    t_interp: float = 0.0

    def defer_navigation(self, navigate) -> None:
        """Leave ``lat`` and ``lon`` to ``navigate()`` -> (lat, lon), called
        on the first read of either; setting either drops it."""
        self.__dict__["lat"] = self.__dict__["lon"] = None
        self.__dict__["_navigate"] = navigate

    def navigation_of(self, other: "Scene") -> None:
        """Take ``other``'s lat and lon, deferred where they are deferred."""
        navigate = other.__dict__.get("_navigate")
        if navigate is None:
            self.lat, self.lon = other.lat, other.lon
        else:
            self.defer_navigation(navigate)

    @property
    def shape(self):
        return self.data.shape[-2], self.data.shape[-1]

    @property
    def nchannels(self):
        return self.data.shape[0]


def scene_from_numpy(fields: dict, device) -> Scene:
    """Port ``Scene`` from the fields of a JAX-package scene.

    ``fields`` is ``dataclasses.asdict(scene)``: numpy arrays become tensors
    on ``device``, ``nav`` (a dict or a NavConstants) becomes NavConstants,
    everything else is copied as it is.
    """
    kw = {}
    for name, val in fields.items():
        if name == "nav":
            val = val if isinstance(val, NavConstants) else NavConstants(**val)
        elif isinstance(val, np.ndarray):
            val = torch.from_numpy(np.ascontiguousarray(val)).to(device)
        kw[name] = val
    return Scene(**kw)
