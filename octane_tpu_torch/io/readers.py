"""File ingest: GOES-R L1b channels 1-3, polar and mercator grids, the
CLAVR-x cloud-top height and the first-guess winds (counterpart of
octane_tpu.io.readers read_scene, _read_flat_grid, read_cth and
read_first_guess; oct_fileread.cc:43-868).

Each reader is split in two halves:

* the file half (``read_scene``, ``read_cth``, ``read_first_guess``) reads
  the arrays and attributes with h5py (imported on use) by the names the
  reference reads and fills ``NavConstants``;
* the array half (``scene_from_goes_arrays``, ``channel_onto_scene``,
  ``scene_from_flat_arrays``, ``cth_onto_scene``,
  ``first_guess_onto_scene``) does the rest on tensors: navigation,
  calibration and normalisation (``nav.goes.navcal_goes``), the regrid of
  channels 2/3 and of the CTH onto the channel-1 grid, flat-grid
  navigation (``nav.polar``, ``nav.mercator``), so the product path also
  runs where h5py is missing.

``row_range`` (r0, r1) restricts ingest to a row block (the multi-process
path, ``parallel.distributed``): the scene's arrays cover rows [r0, r1)
while its NavConstants keep the whole grid's dims.  An array half takes its
inputs as the file holds them (a numpy array or an h5py dataset) and reads
only the rows it needs: the block for channel 1, the flat grids and the
first guess, and for channels 2/3 and the CTH the source rows that the
block's regrid reads (``core.zoom.zoom_*_image_rows``).  The rows equal
those of the whole read bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.normalize import band_min_max
from octane_tpu_torch.core.zoom import zoom_in_image_rows, zoom_out_image_rows
from octane_tpu_torch.io.datamodel import NavConstants, Scene
from octane_tpu_torch.io.native import requantize
from octane_tpu_torch.nav.goes import F64, navcal_goes
from octane_tpu_torch.nav.mercator import mercator_latlon
from octane_tpu_torch.nav.polar import polar_latlon

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


def _tuple_set(tup, idx, val):
    """``tup`` with element ``idx`` set to float(val)."""
    lst = list(tup)
    lst[idx] = float(val)
    return tuple(lst)


_CAL_FIELDS = ("rad_scale", "rad_offset", "fk1", "fk2", "bc1", "bc2", "kap1")


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise RuntimeError("h5py is required for file ingest") from exc
    return h5py


def read_scene(path: str, cfg: OFConfig, donav: bool = True, channel: int = 1,
               scene: Scene = None, device="cuda", row_range=None) -> Scene:
    """Read one GOES-R L1b file into a Scene on ``device`` (the card unless
    the caller names another device, as run_pipeline does).

    ``channel`` 1 reads the primary grid and its navigation (into ``scene``
    when one is given, keeping its NavConstants object, as the sequence's
    roll does); channels 2/3 read an auxiliary band and regrid it onto
    ``scene``'s channel-1 grid (``channel_onto_scene``).  On polar and
    mercator grids (``cfg.grid``) the file is a flat grid and ``channel``
    and ``scene`` are ignored, as in octane_tpu.  ``row_range``: see the
    module docstring.
    """
    if cfg.grid != "goes":
        return _read_flat_grid(path, cfg, donav, device, row_range)
    if channel != 1 and scene is None:
        raise ValueError("channel 1 must be read first")
    with _h5py().File(path, "r") as f:
        rad = f["Rad"]
        x = np.asarray(f["x"][()], np.int16)
        y = np.asarray(f["y"][()], np.int16)
        band = int(_scalar(f["band_id"]))
        h, w = rad.shape
        cal = dict(rad_scale=_attr(rad, "scale_factor"), rad_offset=_attr(rad, "add_offset"),
                   fk1=_scalar(f["planck_fk1"]), fk2=_scalar(f["planck_fk2"]),
                   bc1=_scalar(f["planck_bc1"]), bc2=_scalar(f["planck_bc2"]),
                   kap1=_scalar(f["kappa0"]))
        if channel != 1:
            # the dataset itself: the regrid reads only the rows it needs
            return channel_onto_scene(rad, x, y, band, scene, cfg, channel, cal, row_range)
        nav = scene.nav if scene is not None else NavConstants(grid="goes")
        _set_cal(nav, 0, cal)
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
        sc = scene_from_goes_arrays(rad, x, y, nav, cfg, device, donav=donav, t=t,
                                    t_units=t_units, band=band, row_range=row_range)
    if scene is None:
        return sc
    # channel 1 into an existing Scene: its other channels' band and
    # normalisation entries stay, as octane_tpu's reader leaves them
    scene.nav, scene.data, scene.t, scene.t_units = nav, sc.data, t, t_units
    scene.band = _tuple_set(scene.band, 0, band)
    scene.x, scene.y, scene.raw_counts = sc.x, sc.y, sc.raw_counts
    scene.norm_ranges = sc.norm_ranges[:1] + tuple(scene.norm_ranges[1:])
    if donav:
        scene.lat, scene.lon = sc.lat, sc.lon
    return scene


def _set_cal(nav: NavConstants, ci: int, cal: dict) -> None:
    """Channel ``ci``'s calibration constants (oct_fileread.cc:107-113)."""
    for name in _CAL_FIELDS:
        setattr(nav, name, _tuple_set(getattr(nav, name), ci, cal[name]))


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


def _rows(row_range) -> slice:
    return slice(None) if row_range is None else slice(*row_range)


def scene_from_goes_arrays(counts, x, y, nav: NavConstants, cfg: OFConfig,
                           device, donav: bool = True, t: float = 0.0,
                           t_units: str = "", band: int = 13, row_range=None) -> Scene:
    """Channel-1 Scene from raw arrays: int16 counts (H, W), scan-coordinate
    counts x (W,) and y (H,), and the file's NavConstants; with
    ``row_range``, rows [r0, r1) of them."""
    rows = _rows(row_range)
    counts = torch.as_tensor(np.asarray(counts[rows], np.int16), device=device)
    x = torch.as_tensor(np.asarray(x, np.int16), device=device)
    y = torch.as_tensor(np.asarray(y[rows], np.int16), device=device)
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


def channel_onto_scene(counts, x, y, band: int, scene: Scene, cfg: OFConfig,
                       channel: int, cal: dict, row_range=None) -> Scene:
    """Add channel 2 or 3 to a channel-1 ``scene`` (oct_fileread.cc:361-380).

    ``counts`` (h, w) int16 and its scan-coordinate counts ``x`` (w,) and
    ``y`` (h,) are calibrated with ``cal`` (the file's rad_scale,
    rad_offset, fk1, fk2, bc1, bc2 and kap1, set at index ``channel - 1``
    of ``scene.nav``) and normalised with the band's range (or the
    norm_min2/3, norm_max2/3 overrides), through the channel-1 grid's scan
    scales as octane_tpu does; then regridded onto the channel-1 grid:
    bicubic zoom in when the channel is narrower, as it is when the widths
    agree, blur + bicubic zoom out when it is wider.  The regridded plane
    is appended to ``scene.data`` and its pseudo-counts (the normalisation
    inverted on the host, ``io.native.requantize``) to ``scene.raw_counts``.
    With ``row_range`` the regridded plane is the channel-1 grid's rows
    [r0, r1), from the rows of ``counts`` that they read.
    """
    ci = channel - 1
    nav = scene.nav
    dev = scene.data.device
    _set_cal(nav, ci, cal)
    vmin, vmax = band_min_max(band)
    omin, omax = getattr(cfg, f"norm_min{channel}"), getattr(cfg, f"norm_max{channel}")
    vmin = omin if omin is not None else vmin
    vmax = omax if omax is not None else vmax
    norm_used = (float(vmin), float(vmax))
    x = torch.as_tensor(np.asarray(x, np.int16), device=dev)

    def read_rows(s0, s1):
        """Calibrated, normalised rows [s0, s1) of the channel."""
        data, _, _ = navcal_goes(
            torch.as_tensor(np.asarray(counts[s0:s1], np.int16), device=dev), x,
            torch.as_tensor(np.asarray(y[s0:s1], np.int16), device=dev), nav, channel=ci,
            norm_min=vmin, norm_max=vmax, donav=False)
        return data.to(torch.float32)

    h, w = counts.shape
    h1, w1 = nav.ny, nav.nx
    rows = (0, h1) if row_range is None else tuple(row_range)
    if w1 > w:
        regridded = zoom_in_image_rows(read_rows, h, w, (h1, w1), rows, True, dev)
    elif w1 == w:
        regridded = read_rows(*rows)
    else:
        regridded = zoom_out_image_rows(read_rows, h, w, w1 / w, rows, dev)
    scene.data = torch.cat([scene.data, regridded[None]], dim=0)
    scene.band = _tuple_set(scene.band, ci, band)
    nr = list(scene.norm_ranges)
    nr[ci] = norm_used
    scene.norm_ranges = tuple(nr)
    if scene.raw_counts is not None and scene.raw_counts.shape[0] < channel:
        # pseudo-counts on the channel-1 grid: the reference stores counts of
        # the channel's own grid against channel-1 dims, which cannot round-
        # trip; octane_tpu inverts the normalisation instead
        cnt = requantize(regridded.cpu().numpy(), norm_used[0], norm_used[1],
                         nav.rad_scale[ci], nav.rad_offset[ci])
        scene.raw_counts = torch.cat([scene.raw_counts,
                                      torch.from_numpy(cnt)[None].to(dev)], dim=0)
    return scene


def _read_flat_grid(path: str, cfg: OFConfig, donav: bool, device, row_range=None) -> Scene:
    """Polar / mercator grid ingest (oct_polarread, oct_fileread.cc:421-610;
    oct_mercread, :611-754): float "Rad" data, int16 x/y with scale/offset
    attributes (projected metres), a "grid_mapping" variable with lat1,
    lon0 and R (polar, degrees) or lon1 and R (mercator, degrees, turned
    into radians here), and "t" with its units."""
    with _h5py().File(path, "r") as f:
        ds = f["Rad"]
        h, w = ds.shape
        x = np.asarray(f["x"][()], np.int16)
        y = np.asarray(f["y"][()], np.int16)
        nav = NavConstants(grid=cfg.grid)
        nav.x_scale = float(_attr(f["x"], "scale_factor"))
        nav.x_offset = float(_attr(f["x"], "add_offset"))
        nav.y_scale = float(_attr(f["y"], "scale_factor"))
        nav.y_offset = float(_attr(f["y"], "add_offset"))
        gm = f["grid_mapping"]
        nav.R = float(_attr(gm, "R"))
        if cfg.grid == "polar":
            nav.lat1 = float(_attr(gm, "lat1"))
            nav.lon0_deg = float(_attr(gm, "lon0"))
        else:
            nav.lon1 = float(_attr(gm, "lon1")) * DTOR
        t = float(_scalar(f["t"]))
        t_units = _attr(f["t"], "units") if "units" in f["t"].attrs else ""
        set_flat_grid(nav, h, w)
        return scene_from_flat_arrays(ds, x, y, nav, cfg, device, donav=donav,
                                      t=t, t_units=t_units, row_range=row_range)


def set_flat_grid(nav: NavConstants, h: int, w: int) -> NavConstants:
    """Grid bookkeeping of a polar / mercator image of h x w pixels."""
    nav.ny, nav.nx = h, w
    nav.max_x, nav.max_y = w, h
    nav.max_xc, nav.max_yc = w, h
    return nav


def scene_from_flat_arrays(data, x, y, nav: NavConstants, cfg: OFConfig, device,
                           donav: bool = True, t: float = 0.0,
                           t_units: str = "", row_range=None) -> Scene:
    """Polar / mercator Scene from raw arrays: the (H, W) data, which pass
    through as float32 with no calibration and no 0-255 normalisation (ref
    polar :60), its int16 x (W,) and y (H,) counts, and the file's
    NavConstants (grid ``cfg.grid``); with ``row_range``, rows [r0, r1) of
    them.  Lat/lon come from the float64 projected metres x * x_scale +
    x_offset, y * y_scale + y_offset."""
    rows = _rows(row_range)
    data = torch.as_tensor(np.asarray(data[rows], np.float32), device=device)
    x = torch.as_tensor(np.asarray(x, np.int16), device=device)
    y = torch.as_tensor(np.asarray(y[rows], np.int16), device=device)
    sc = Scene(nav=nav, data=data[None].contiguous(), t=t, t_units=t_units, x=x, y=y,
               raw_counts=data[None].clone())
    if donav:
        h, w = data.shape
        xv = x.to(F64) * nav.x_scale + nav.x_offset
        yv = y.to(F64) * nav.y_scale + nav.y_offset
        latlon = polar_latlon if cfg.grid == "polar" else mercator_latlon
        sc.lat, sc.lon = latlon(xv[None, :].expand(h, w), yv[:, None].expand(h, w), nav)
    return sc


def read_cth(path: str, scene: Scene, cfg: OFConfig, row_range=None) -> Scene:
    """CLAVR-x cloud-top height ingest (oct_clavrxread, oct_fileread.cc:
    756-816): reads Cloud_Top_Height_Effective as float32, as it is in the
    file (fill values included), and regrids it onto ``scene`` (rows
    [r0, r1) of its grid with ``row_range``)."""
    with _h5py().File(path, "r") as f:
        return cth_onto_scene(f["Cloud_Top_Height_Effective"], scene, cfg,
                              scene.data.device, row_range)


def cth_onto_scene(cth, scene: Scene, cfg: OFConfig, device, row_range=None) -> Scene:
    """Set ``scene.cth`` (H, W) float32 on ``device`` from the (hs, ws) CTH
    field: zoomed in when the image is wider than the CTH grid (bicubic, or
    nearest with -nncth), as it is when the widths agree, zoomed out when
    the image is narrower.  On GOES the CTH width is w // div with div 4
    for band 2, 2 for bands 1 and 3, 1 otherwise (``set_goes_grid``).  With
    ``row_range`` only the image's rows [r0, r1), from the CTH rows they
    read."""
    nav = scene.nav
    xs = nav.max_xc - nav.min_xc
    nav.cth_nx = xs
    nav.cth_ny = nav.max_yc - nav.min_yc
    h1, w1 = nav.ny, nav.nx
    hs, ws = cth.shape
    rows = (0, h1) if row_range is None else tuple(row_range)

    def read_rows(s0, s1):
        return torch.as_tensor(np.asarray(cth[s0:s1], np.float32), device=device)

    if w1 > xs:
        scene.cth = zoom_in_image_rows(read_rows, hs, ws, (h1, w1), rows,
                                       cfg.interp_cth_bicubic, device)
    elif w1 == xs:
        scene.cth = read_rows(*rows)
    else:
        scene.cth = zoom_out_image_rows(read_rows, hs, ws, w1 / xs, rows, device)
    return scene


def read_first_guess(path: str, scene: Scene, row_range=None) -> Scene:
    """First-guess winds ingest (oct_fgread, oct_fileread.cc:817-868): UFG
    and VFG, navigated winds in m/s on the image grid (rows [r0, r1) with
    ``row_range``)."""
    with _h5py().File(path, "r") as f:
        return first_guess_onto_scene(f["UFG"], f["VFG"], scene, scene.data.device, row_range)


def first_guess_onto_scene(ufg, vfg, scene: Scene, device, row_range=None) -> Scene:
    """Set ``scene.ufg`` / ``scene.vfg`` (H, W) float32 on ``device`` (their
    rows [r0, r1) with ``row_range``)."""
    rows = _rows(row_range)
    scene.ufg = torch.as_tensor(np.asarray(ufg[rows], np.float32), device=device)
    scene.vfg = torch.as_tensor(np.asarray(vfg[rows], np.float32), device=device)
    return scene
