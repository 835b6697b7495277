"""GOES-R L1b ingest, channel 1, with the CLAVR-x cloud-top height and the
first-guess winds (counterpart of octane_tpu.io.readers read_scene,
read_cth and read_first_guess; oct_fileread.cc:43-419, 756-868).

Each reader is split in two halves:

* the file half (``read_scene``, ``read_cth``, ``read_first_guess``) reads
  the arrays and attributes with h5py (imported on use) by the names the
  reference reads and fills ``NavConstants``;
* the array half (``scene_from_goes_arrays``, ``cth_onto_scene``,
  ``first_guess_onto_scene``) does the rest on tensors: navigation,
  calibration and normalisation (``nav.goes.navcal_goes``), the CTH regrid
  onto the image grid, so the product path also runs where h5py is missing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.normalize import band_min_max
from octane_tpu_torch.core.zoom import zoom_in_image, zoom_out_image
from octane_tpu_torch.io.datamodel import NavConstants, Scene
from octane_tpu_torch.nav.goes import navcal_goes

DTOR = math.pi / 180.0


def _scalar(ds):
    v = np.asarray(ds[()])
    return v.reshape(-1)[0] if v.ndim else v.item() if hasattr(v, "item") else v


def _attr(var, name):
    v = var.attrs[name]
    if isinstance(v, bytes):
        return v.decode()
    arr = np.asarray(v).reshape(-1)
    if arr.dtype.kind in "SU":
        s = arr[0]
        return s.decode() if isinstance(s, bytes) else str(s)
    return arr[0]


def _first(tup, val):
    """``tup`` with element 0 set to float(val)."""
    return (float(val),) + tuple(tup[1:])


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise RuntimeError("h5py is required for file ingest") from exc
    return h5py


def read_scene(path: str, cfg: OFConfig, donav: bool = True,
               device="cuda") -> Scene:
    """Read one GOES-R L1b file (channel 1) into a Scene on ``device`` (the
    card unless the caller names another device, as run_pipeline does)."""
    if cfg.grid != "goes":
        raise NotImplementedError(f"{cfg.grid!r} ingest is not ported yet")
    with _h5py().File(path, "r") as f:
        rad = f["Rad"]
        counts = np.asarray(rad[()], np.int16)
        x = np.asarray(f["x"][()], np.int16)
        y = np.asarray(f["y"][()], np.int16)
        band = int(_scalar(f["band_id"]))
        h, w = rad.shape
        nav = NavConstants(grid="goes")
        nav.rad_scale = _first(nav.rad_scale, _attr(rad, "scale_factor"))
        nav.rad_offset = _first(nav.rad_offset, _attr(rad, "add_offset"))
        nav.fk1 = _first(nav.fk1, _scalar(f["planck_fk1"]))
        nav.fk2 = _first(nav.fk2, _scalar(f["planck_fk2"]))
        nav.bc1 = _first(nav.bc1, _scalar(f["planck_bc1"]))
        nav.bc2 = _first(nav.bc2, _scalar(f["planck_bc2"]))
        nav.kap1 = _first(nav.kap1, _scalar(f["kappa0"]))
        nav.x_scale = float(_attr(f["x"], "scale_factor"))
        nav.x_offset = float(_attr(f["x"], "add_offset"))
        nav.y_scale = float(_attr(f["y"], "scale_factor"))
        nav.y_offset = float(_attr(f["y"], "add_offset"))
        gip = f["goes_imager_projection"]
        nav.gip_val = float(_scalar(gip))
        nav.lpo = float(_attr(gip, "longitude_of_projection_origin"))
        nav.req = float(_attr(gip, "semi_major_axis"))
        nav.rpol = float(_attr(gip, "semi_minor_axis"))
        nav.inverse_flattening = float(_attr(gip, "inverse_flattening"))
        nav.lat0 = float(_attr(gip, "latitude_of_projection_origin"))
        nav.pph = float(_attr(gip, "perspective_point_height"))
        t = float(_scalar(f["t"]))
        t_units = _attr(f["t"], "units")
    set_goes_grid(nav, h, w, band)
    return scene_from_goes_arrays(counts, x, y, nav, cfg, device, donav=donav,
                                  t=t, t_units=t_units, band=band)


def set_goes_grid(nav: NavConstants, h: int, w: int, band: int) -> NavConstants:
    """Grid bookkeeping the reader derives from the image size and band."""
    nav.lam0 = nav.lpo * DTOR
    nav.nx, nav.ny = w, h
    nav.min_x = nav.min_y = 0
    nav.max_x, nav.max_y = w, h
    # CLAVR-x coordinate subsetting factors (oct_fileread.cc:315-336)
    div = 4 if band == 2 else (2 if band in (1, 3) else 1)
    nav.min_xc, nav.min_yc = 0, 0
    nav.max_xc, nav.max_yc = w // div, h // div
    return nav


def scene_from_goes_arrays(counts, x, y, nav: NavConstants, cfg: OFConfig,
                           device, donav: bool = True, t: float = 0.0,
                           t_units: str = "", band: int = 13) -> Scene:
    """Channel-1 Scene from raw arrays: int16 counts (H, W), scan-coordinate
    counts x (W,) and y (H,), and the file's NavConstants."""
    counts = torch.as_tensor(np.asarray(counts, np.int16), device=device)
    x = torch.as_tensor(np.asarray(x, np.int16), device=device)
    y = torch.as_tensor(np.asarray(y, np.int16), device=device)
    # normalisation range: band table unless overridden (oct_fileread.cc:341-359)
    vmin, vmax = band_min_max(band)
    vmin = cfg.norm_min if cfg.norm_min is not None else vmin
    vmax = cfg.norm_max if cfg.norm_max is not None else vmax
    data, lat, lon = navcal_goes(counts, x, y, nav, channel=0,
                                 norm_min=vmin, norm_max=vmax, donav=donav)
    sc = Scene(nav=nav, data=data.to(torch.float32)[None].contiguous(), t=t,
               t_units=t_units, band=(float(band), 0, 0), x=x, y=y,
               raw_counts=counts[None])
    sc.norm_ranges = ((float(vmin), float(vmax)),) + tuple(sc.norm_ranges[1:])
    if donav:
        sc.lat, sc.lon = lat, lon
    return sc


def read_cth(path: str, scene: Scene, cfg: OFConfig) -> Scene:
    """CLAVR-x cloud-top height ingest (oct_clavrxread, oct_fileread.cc:
    756-816): reads Cloud_Top_Height_Effective as float32, as it is in the
    file (fill values included), and regrids it onto ``scene``."""
    with _h5py().File(path, "r") as f:
        cth = np.asarray(f["Cloud_Top_Height_Effective"][()], np.float32)
    return cth_onto_scene(cth, scene, cfg, scene.data.device)


def cth_onto_scene(cth, scene: Scene, cfg: OFConfig, device) -> Scene:
    """Set ``scene.cth`` (H, W) float32 on ``device`` from the (hs, ws) CTH
    field: zoomed in when the image is wider than the CTH grid (bicubic, or
    nearest with -nncth), as it is when the widths agree, zoomed out when
    the image is narrower.  On GOES the CTH width is w // div with div 4
    for band 2, 2 for bands 1 and 3, 1 otherwise (``set_goes_grid``)."""
    nav = scene.nav
    xs = nav.max_xc - nav.min_xc
    nav.cth_nx = xs
    nav.cth_ny = nav.max_yc - nav.min_yc
    h1, w1 = nav.ny, nav.nx
    cth = torch.as_tensor(np.asarray(cth, np.float32), device=device)
    if w1 > xs:
        scene.cth = zoom_in_image(cth, (h1, w1), cfg.interp_cth_bicubic)
    elif w1 == xs:
        scene.cth = cth
    else:
        scene.cth = zoom_out_image(cth, w1 / xs)
    return scene


def read_first_guess(path: str, scene: Scene) -> Scene:
    """First-guess winds ingest (oct_fgread, oct_fileread.cc:817-868): UFG
    and VFG, navigated winds in m/s on the image grid."""
    with _h5py().File(path, "r") as f:
        ufg = np.asarray(f["UFG"][()], np.float32)
        vfg = np.asarray(f["VFG"][()], np.float32)
    return first_guess_onto_scene(ufg, vfg, scene, scene.data.device)


def first_guess_onto_scene(ufg, vfg, scene: Scene, device) -> Scene:
    """Set ``scene.ufg`` / ``scene.vfg`` (H, W) float32 on ``device``."""
    scene.ufg = torch.as_tensor(np.asarray(ufg, np.float32), device=device)
    scene.vfg = torch.as_tensor(np.asarray(vfg, np.float32), device=device)
    return scene
