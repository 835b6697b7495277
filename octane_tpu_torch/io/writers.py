"""Product writer (counterpart of octane_tpu.io.writers.write_product;
oct_goeswrite, oct_filewrite.cc:17-349; oct_polarwrite, :353-563;
oct_mercwrite, :565-704).

Writes the same variables and attributes as the JAX package's writer, as
HDF5 with netCDF-style dimension scales.  GOES grid: x, y (int16 +
scale/offset), t, U/V (int16, 100*m/s), U_raw/V_raw (int16, 100*pixels),
Upix/Vpix (-pd), CTP, Rad[2, 3] + planck/kappa scalars per channel,
goes_imager_projection and optical_flow_settings.  Polar and mercator
grids (``_write_flat_product``): U/V as float64 m/s, Upix/Vpix when -pd is
set or there are no m/s winds, Rad as float32, the grid's projection
variable and the flat-grid settings.  An interpolated frame's product
(``interp=True``) takes t from ``t_interp``, adds the ``frdt`` attribute
to t and the Occlusion variable (int16).  Tensors are copied to host
memory for writing.  A 2-D variable may also be a ``RowBlockSource``: the
multi-process path's row blocks in part files, which the writer streams
into the product one block at a time, so a merged product holds the
values of a whole write.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.io.datamodel import Scene


class RowBlockSource:
    """A 2-D product variable held as row blocks in part files: ``parts`` is
    [(path, row0, row1), ...] and each file holds the variable ``name`` for
    its rows (parallel.distributed writes one part per process)."""

    def __init__(self, parts, name: str, shape, dtype):
        self.parts = list(parts)
        self.name = name
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def blocks(self):
        """(row slice, block) per part, in the parts' order."""
        h5py = _h5py()
        for path, r0, r1 in self.parts:
            with h5py.File(path, "r") as f:
                yield slice(r0, r1), np.asarray(f[self.name][()], self.dtype)


class RowBlockStack:
    """The channels of ``raw_counts`` as RowBlockSources."""

    def __init__(self, sources):
        self.sources = list(sources)
        self.shape = (len(self.sources),) + self.sources[0].shape

    def __getitem__(self, c):
        return self.sources[c]


def _np(data, dtype):
    if isinstance(data, RowBlockSource):
        # its blocks cast as a whole variable is
        return RowBlockSource(data.parts, data.name, data.shape, dtype)
    if torch.is_tensor(data):
        data = data.detach().cpu().numpy()
    return np.asarray(data, dtype)


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise RuntimeError("h5py is required for product output") from exc
    return h5py


def _dimvar(f, name, data, scale, offset):
    d = f.create_dataset(name, data=data)
    d.make_scale(name)
    d.attrs["scale_factor"] = np.float32(scale)
    d.attrs["add_offset"] = np.float32(offset)
    return d


def _var2d(f, name, data, xdim, ydim, **attrs):
    if isinstance(data, RowBlockSource):
        d = f.create_dataset(name, shape=data.shape, dtype=data.dtype)
        for rows, block in data.blocks():
            d[rows] = block
    else:
        d = f.create_dataset(name, data=data)
    d.dims[0].attach_scale(ydim)
    d.dims[1].attach_scale(xdim)
    for k, v in attrs.items():
        d.attrs[k] = v
    return d


def write_product(path: str, scene: Scene, cfg: OFConfig, interp: bool = False) -> str:
    """Write the flow product for ``scene``; returns the path."""
    h5py = _h5py()
    if cfg.grid != "goes":
        return _write_flat_product(path, scene, cfg, interp)
    nav = scene.nav
    h, w = nav.ny, nav.nx
    with h5py.File(path, "w") as f:
        x = scene.x if scene.x is not None else np.arange(w, dtype=np.int16)
        y = scene.y if scene.y is not None else np.arange(h, dtype=np.int16)
        xd = _dimvar(f, "x", _np(x, np.int16), nav.x_scale, nav.x_offset)
        yd = _dimvar(f, "y", _np(y, np.int16), nav.y_scale, nav.y_offset)

        t = f.create_dataset("t", data=np.float64(scene.t_interp if interp else scene.t))
        t.attrs["standard_name"] = "time"
        t.attrs["units"] = scene.t_units
        t.attrs["axis"] = "T"
        t.attrs["bounds"] = "time_bounds"
        t.attrs["long_name"] = (
            "J2000 epoch mid-point between the start and end image scan in seconds")
        if interp:
            t.attrs["frdt"] = np.float32(scene.frdt)

        grid_map = "goes_imager_projection"
        units_uv = "meters per second" if not cfg.pixuv else "x-pixels"
        if cfg.out_nav and scene.u_wind is not None:
            _var2d(f, "U", _np(scene.u_wind, np.int16), xd, yd,
                   long_name="U", grid_mapping=grid_map,
                   scale_factor=np.float32(0.01), units=units_uv)
            _var2d(f, "V", _np(scene.v_wind, np.int16), xd, yd,
                   long_name="V", grid_mapping=grid_map,
                   scale_factor=np.float32(0.01),
                   units="meters per second" if not cfg.pixuv else "y-pixels")
        if cfg.out_raw and scene.u_raw is not None:
            _var2d(f, "U_raw", _np(scene.u_raw, np.int16), xd, yd,
                   long_name="U Raw", grid_mapping=grid_map,
                   scale_factor=np.float32(0.01), units="x-pixels")
            _var2d(f, "V_raw", _np(scene.v_raw, np.int16), xd, yd,
                   long_name="V Raw", grid_mapping=grid_map,
                   scale_factor=np.float32(0.01), units="y-pixels")
        if cfg.pixuv and scene.u_pix is not None:
            _var2d(f, "Upix", _np(scene.u_pix, np.float32), xd, yd,
                   long_name="Upix", grid_mapping=grid_map)
            _var2d(f, "Vpix", _np(scene.v_pix, np.float32), xd, yd,
                   long_name="Vpix", grid_mapping=grid_map)
        if interp and scene.occlusion is not None:
            _var2d(f, "Occlusion", _np(scene.occlusion, np.int16), xd, yd,
                   long_name="Occlusion Masks",
                   key="0 - both, 1 - only in image 1, 2 - only in image 2")
        if cfg.out_ctp and cfg.do_cth and scene.ctp is not None:
            _var2d(f, "CTP", _np(scene.ctp, np.int16), xd, yd,
                   long_name="CTP", grid_mapping=grid_map,
                   interpcth=np.float32(1.0 if cfg.interp_cth_bicubic else 0.0))
        if cfg.out_rad and scene.raw_counts is not None:
            names = ["Rad", "Rad2", "Rad3"]
            for c in range(scene.raw_counts.shape[0]):
                _var2d(f, names[c], _np(scene.raw_counts[c], np.int16),
                       xd, yd, long_name=names[c], grid_mapping=grid_map,
                       scale_factor=np.float32(nav.rad_scale[c]),
                       add_offset=np.float32(nav.rad_offset[c]))
                for nm, tup in (("planck_fk1", nav.fk1), ("planck_fk2", nav.fk2),
                                ("planck_bc1", nav.bc1), ("planck_bc2", nav.bc2),
                                ("kappa0", nav.kap1)):
                    suffix = "" if c == 0 else f"_{c + 1}"
                    f.create_dataset(nm + suffix, data=np.float32(tup[c]))

        gip = f.create_dataset(grid_map, data=np.int32(0))
        gip.attrs["long_name"] = "GOES-R ABI fixed grid projection"
        gip.attrs["grid_mapping_name"] = "geostationary"
        gip.attrs["perspective_point_height"] = np.float64(nav.pph)
        gip.attrs["semi_major_axis"] = np.float64(nav.req)
        gip.attrs["semi_minor_axis"] = np.float64(nav.rpol)
        gip.attrs["inverse_flattening"] = np.float64(nav.inverse_flattening)
        gip.attrs["latitude_of_projection_origin"] = np.float64(nav.lat0)
        gip.attrs["longitude_of_projection_origin"] = np.float64(nav.lpo)
        gip.attrs["sweep_angle_axis"] = "x"

        ofv = f.create_dataset("optical_flow_settings", data=np.int32(cfg.oftype))
        ofv.attrs["long_name"] = "Optical Flow Settings"
        ofv.attrs["key"] = ("1 = Modified Zimmer et al. (2011), 2 = Farneback, "
                            "3 = Brox (2004), 4 = Least Squares")
        ofv.attrs["Image2_xOffset"] = np.float32(nav.g2x_offset)
        ofv.attrs["Image2_yOffset"] = np.float32(nav.g2y_offset)
        nmin, nmax = scene.norm_ranges[0]
        if cfg.oftype in (1, 3):
            # the reference attr set in schema order (oct_filewrite.cc:239-251)
            ofv.attrs["lambda"] = np.float64(cfg.lambda_)
            ofv.attrs["lambdac"] = np.float64(cfg.lambdac)
            ofv.attrs["alpha"] = np.float64(cfg.alpha)
            ofv.attrs["filtsigma"] = np.float64(cfg.filtsigma)
            ofv.attrs["ScaleF"] = np.float64(cfg.scale_factor)
            ofv.attrs["K_Iterations"] = np.int32(cfg.kiters)
            ofv.attrs["L_Iterations"] = np.int32(cfg.liters)
            ofv.attrs["M_Iterations"] = np.int32(cfg.miters)
            ofv.attrs["CG_Iterations"] = np.int32(cfg.cgiters)
            ofv.attrs["NormMax"] = np.float32(nmax)
            ofv.attrs["NormMin"] = np.float32(nmin)
            ofv.attrs["dofirstguess"] = np.int32(1 if cfg.do_firstguess else 0)
            # extension beyond the reference schema: the relaxer used
            ofv.attrs["solver"] = cfg.solver
            if cfg.solver == "sor":
                ofv.attrs["sor_omega"] = np.float64(cfg.sor_omega)
        if cfg.oftype == 4:
            ofv.attrs["Rad"] = np.int32(cfg.rad)
            ofv.attrs["SRad"] = np.int32(cfg.srad)
            ofv.attrs["NormMax"] = np.float32(nmax)
            ofv.attrs["NormMin"] = np.float32(nmin)
        ofv.attrs["dt_seconds"] = np.float32(scene.dt)
    return path


def _write_flat_product(path: str, scene: Scene, cfg: OFConfig, interp: bool) -> str:
    """Polar / mercator product: U/V stored as float64 m/s ("important for
    slow motions", oct_filewrite.cc:352), Rad as float32, and the grid's
    projection variable with lon1 back in degrees."""
    nav = scene.nav
    polar = cfg.grid == "polar"
    gmap = "polar_orthonormal" if polar else "Mercator Sphere"
    with _h5py().File(path, "w") as f:
        xd = _dimvar(f, "x", _np(scene.x, np.int16), nav.x_scale, nav.x_offset)
        yd = _dimvar(f, "y", _np(scene.y, np.int16), nav.y_scale, nav.y_offset)
        t = f.create_dataset("t", data=np.float64(scene.t_interp if interp else scene.t))
        t.attrs["standard_name"] = "time"
        t.attrs["units"] = scene.t_units
        t.attrs["axis"] = "T"
        t.attrs["long_name"] = (
            "J2000 epoch mid-point between the start and end image scan in seconds")
        if interp:
            t.attrs["frdt"] = np.float32(scene.frdt)

        if scene.u_ms is not None:
            _var2d(f, "U", _np(scene.u_ms, np.float64), xd, yd,
                   long_name="U", grid_mapping=gmap,
                   units="meters per second" if not cfg.pixuv else "x-pixels")
            _var2d(f, "V", _np(scene.v_ms, np.float64), xd, yd,
                   long_name="V", grid_mapping=gmap,
                   units="meters per second" if not cfg.pixuv else "y-pixels")
        if scene.u_pix is not None and (cfg.pixuv or scene.u_ms is None):
            _var2d(f, "Upix", _np(scene.u_pix, np.float32), xd, yd,
                   long_name="Upix", grid_mapping=gmap)
            _var2d(f, "Vpix", _np(scene.v_pix, np.float32), xd, yd,
                   long_name="Vpix", grid_mapping=gmap)
        if interp and scene.occlusion is not None:
            _var2d(f, "Occlusion", _np(scene.occlusion, np.int16), xd, yd,
                   long_name="Occlusion Masks",
                   key="0 - both, 1 - only in image 1, 2 - only in image 2")
        if cfg.out_rad and scene.raw_counts is not None:
            names = ["Rad", "Rad2", "Rad3"]
            for c in range(scene.raw_counts.shape[0]):
                _var2d(f, names[c], _np(scene.raw_counts[c], np.float32), xd, yd,
                       long_name=names[c], grid_mapping=gmap)

        gname = "polar_imager_projection" if polar else "merc_imager_projection"
        gip = f.create_dataset(gname, data=np.int32(0))
        if polar:
            gip.attrs["long_name"] = "Polar_Orthonormal_Grid"
            gip.attrs["grid_mapping_name"] = "polar"
            gip.attrs["lat1"] = np.float64(nav.lat1)
            gip.attrs["lon0"] = np.float64(nav.lon0_deg)
        else:
            gip.attrs["long_name"] = "Mercator_Grid"
            gip.attrs["lon1"] = np.float64(nav.lon1 / (np.pi / 180.0))
        gip.attrs["R"] = np.float64(nav.R)

        ofv = f.create_dataset("optical_flow_settings", data=np.int32(cfg.oftype))
        ofv.attrs["long_name"] = "Optical Flow Settings"
        ofv.attrs["key"] = "1 = Modified Sun (2014), 2 = Farneback, 3 = Brox (2004)"
        if cfg.oftype in (1, 3):
            # the flat-grid twin of the GOES set (oct_filewrite.cc:475-490
            # polar, :657-670 mercator)
            nmin, nmax = scene.norm_ranges[0]
            ofv.attrs["lambda"] = np.float64(cfg.lambda_)
            ofv.attrs["lambdac"] = np.float64(cfg.lambdac)
            ofv.attrs["alpha"] = np.float64(cfg.alpha)
            ofv.attrs["filtsigma"] = np.float64(cfg.filtsigma)
            ofv.attrs["ScaleF"] = np.float64(cfg.scale_factor)
            ofv.attrs["K_Iterations"] = np.int32(cfg.kiters)
            ofv.attrs["L_Iterations"] = np.int32(cfg.liters)
            ofv.attrs["M_Iterations"] = np.int32(cfg.miters)
            ofv.attrs["CG_Iterations"] = np.int32(cfg.cgiters)
            ofv.attrs["NormMax"] = np.float32(nmax)
            ofv.attrs["NormMin"] = np.float32(nmin)
            ofv.attrs["dofirstguess"] = np.int32(1 if cfg.do_firstguess else 0)
        ofv.attrs["dt_seconds"] = np.float32(scene.dt)
    return path
