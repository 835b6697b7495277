"""Write tests/hdf5_fixtures/: small HDF5 files made by h5py, each with an
.npz of what it holds, for the port's HDF5 codec (octane_tpu_torch.io.hdf5)
to be held against where h5py is not installed (tests/test_torch_hdf5.py,
chip_smoke.py's io phase; tests/torch_fixtures.check_hdf5_fixture).

    python tools/make_hdf5_fixtures.py [--out tests/hdf5_fixtures]

The values come from a numpy seed, so every run writes the same contents.
The files:

* ``earliest``: h5py's default file (superblock 0, version-1 object
  headers, a symbol-table root group of 12 links over two symbol nodes);
  contiguous, compact, chunked, chunked + deflate + shuffle and
  + fletcher32 datasets of several integer and float types and byte
  orders, a chunked dataset with chunks never written (fill value -7),
  12 attributes on one dataset, fixed-length and variable-length strings,
  a dimension scale (REFERENCE_LIST, DIMENSION_LIST);
* ``latest_tracked``: the same with libver "latest" and track_order
  (superblock 3, version-2 object headers with continuation blocks, dense
  links and dense attributes in fractal heaps with v2 B-tree name
  indexes, layout message 4 with the fixed-array, single-chunk and
  implicit chunk indexes);
* ``netcdf_l1b``: a 64 x 48 GOES-R L1b look-alike laid out as netCDF-C
  writes one (superblock 2, creation order tracked, Rad chunked 16 x 16
  with shuffle and deflate level 1, text attributes as fixed-length
  strings, ``_Netcdf4Dimid`` and ``_NCProperties``), with every variable
  the port's ``read_scene`` reads.

In the .npz, a dataset's values are under its name, an attribute's under
``<object>@<attribute>`` (the root's object name is ""), the attribute names
of an object in order under ``<object>@`` and the dataset names in order
under ``__datasets__``.  Variable-length strings are stored as numpy
unicode, fixed-length ones as bytes; attributes the codec does not decode
(object references, compounds) appear only among the names.
"""

from __future__ import annotations

import argparse
import os

import h5py
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (37, 23)
CHUNK = (8, 6)


def _dataset_kw(kind):
    return {"contiguous": {}, "chunked": dict(chunks=CHUNK),
            "deflate_shuffle": dict(chunks=CHUNK, compression="gzip", compression_opts=4,
                                    shuffle=True),
            "fletcher32": dict(chunks=CHUNK, compression="gzip", shuffle=True,
                               fletcher32=True)}[kind]


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


def _early_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(CHUNK)
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _general(f, rng, latest):
    """The datasets and attributes of the ``earliest`` and ``latest_tracked`` files."""
    tt = dict(track_times=False)
    f.attrs["title"] = "octane hdf5 fixture"
    f.attrs["fixed"] = np.bytes_(b"fixed-length")
    f.attrs["version"] = np.int32(3)
    contig = f.create_dataset("contiguous", data=rng.integers(-30000, 30000, SHAPE)
                              .astype(np.int16), **tt)
    f.create_dataset("compact", data=rng.normal(0, 1, SHAPE).astype(np.float32),
                     dcpl=_compact_dcpl(), **tt)
    f.create_dataset("chunked", data=rng.integers(0, 65535, SHAPE).astype(np.uint16),
                     **_dataset_kw("chunked"), **tt)
    f.create_dataset("deflate_shuffle", data=rng.integers(-3000, 3000, SHAPE).astype(">i2"),
                     **_dataset_kw("deflate_shuffle"), **tt)
    f.create_dataset("fletcher32", data=rng.normal(0, 1e3, SHAPE).astype(np.float64),
                     **_dataset_kw("fletcher32"), **tt)
    part = f.create_dataset("unwritten", shape=SHAPE, dtype=np.int32, chunks=CHUNK,
                            fillvalue=-7, **tt)
    part[0:8] = rng.integers(-5, 5, (8, SHAPE[1]))
    part[24:30, 0:6] = 11
    if latest:
        f.create_dataset("single_chunk", data=rng.integers(0, 100, SHAPE).astype(np.int8),
                         chunks=SHAPE, compression="gzip", **tt)
        f.create_dataset("implicit", data=rng.integers(0, 1 << 30, SHAPE).astype(np.int32),
                         dcpl=_early_dcpl(), **tt)
    t = f.create_dataset("t", data=np.float64(650000000.0), **tt)
    t.attrs["units"] = "seconds since 2000-01-01 12:00:00"
    f.create_dataset("band_id", data=np.array([13], np.int8), **tt)
    for i in range(3):
        f.create_dataset(f"v{i}", data=np.arange(5, dtype=f"<u{2 ** i}") * (i + 1), **tt)
    x = f.create_dataset("x", data=np.arange(SHAPE[1], dtype=np.int16), **tt)
    x.make_scale("x")
    contig.dims[1].attach_scale(x)
    for k, v in (("scale_factor", np.float32(0.01)), ("add_offset", np.float32(-0.5)),
                 ("valid_range", np.array([-30000, 30000], np.int16)),
                 ("long_name", "a long name, in UTF-8: é"),
                 ("units", np.bytes_(b"mW m-2 sr-1")),
                 ("flag_meanings", np.array([b"good", b"bad"], "S4")),
                 ("count", np.int64(123456789012)), ("ratio", np.float64(1 / 3)),
                 ("u8", np.uint8(200)), ("be", np.array([1.5, -2.5], ">f4")),
                 ("u4", np.uint32(4000000000)), ("empty", "")):
        contig.attrs[k] = v


def _l1b(f, rng):
    """A GOES-R L1b look-alike as netCDF-C lays one out."""
    h, w = 64, 48
    f.attrs["_NCProperties"] = np.bytes_(b"version=2,netcdf=4.7.4,hdf5=1.10.6")
    f.attrs["title"] = np.bytes_(b"ABI L1b Radiances")
    y = f.create_dataset("y", data=np.arange(h, dtype=np.int16), track_times=False)
    x = f.create_dataset("x", data=np.arange(w, dtype=np.int16), track_times=False)
    for v, scale, n, dimid in ((x, 5.6e-05, w, 1), (y, -5.6e-05, h, 0)):
        v.make_scale(v.name[1:])
        v.attrs["scale_factor"] = np.float32(scale)
        v.attrs["add_offset"] = np.float32(-scale * (n / 2 - 0.5))
        v.attrs["units"] = np.bytes_(b"rad")
        v.attrs["_Netcdf4Dimid"] = np.int32(dimid)
    rad = f.create_dataset("Rad", data=rng.integers(0, 4095, (h, w)).astype(np.int16),
                           chunks=(16, 16), compression="gzip", compression_opts=1,
                           shuffle=True, fillvalue=np.int16(4095), track_times=False)
    rad.dims[0].attach_scale(y)
    rad.dims[1].attach_scale(x)
    rad.attrs["_FillValue"] = np.int16(4095)
    rad.attrs["long_name"] = np.bytes_(b"ABI L1b Radiances")
    rad.attrs["scale_factor"] = np.float32(0.01)
    rad.attrs["add_offset"] = np.float32(-0.5)
    rad.attrs["units"] = np.bytes_(b"mW m-2 sr-1 (cm-1)-1")
    rad.attrs["coordinates"] = np.bytes_(b"band_id t y x")
    rad.attrs["grid_mapping"] = np.bytes_(b"goes_imager_projection")
    t = f.create_dataset("t", data=np.float64(650000000.0), track_times=False)
    t.attrs["units"] = np.bytes_(b"seconds since 2000-01-01 12:00:00")
    f.create_dataset("band_id", data=np.array([13], np.int8), track_times=False)
    gip = f.create_dataset("goes_imager_projection", data=np.int32(-2147483647),
                           track_times=False)
    for k, v in (("longitude_of_projection_origin", -75.0), ("semi_major_axis", 6378137.0),
                 ("semi_minor_axis", 6356752.31414), ("inverse_flattening", 298.2572221),
                 ("latitude_of_projection_origin", 0.0),
                 ("perspective_point_height", 35786023.0)):
        gip.attrs[k] = np.float64(v)
    for k, v in (("planck_fk1", 10803.3), ("planck_fk2", 1392.74), ("planck_bc1", 0.07544),
                 ("planck_bc2", 0.99975), ("kappa0", 0.0015)):
        f.create_dataset(k, data=np.float32(v), track_times=False)


def _npz_of(path):
    """What the .npz holds for the file at ``path`` (read with h5py)."""
    out = {}
    with h5py.File(path, "r") as f:
        out["__datasets__"] = np.array(list(f.keys()))
        for name in [""] + list(f.keys()):
            obj = f[name] if name else f
            if name:
                out[name] = np.asarray(obj[()])
            out[f"{name}@"] = np.array(list(obj.attrs.keys()))
            for k in obj.attrs.keys():
                if k in ("DIMENSION_LIST", "REFERENCE_LIST"):
                    continue
                v = obj.attrs[k]
                if isinstance(v, str):
                    v = np.str_(v)
                v = np.asarray(v)
                out[f"{name}@{k}"] = v.astype(v.dtype.str)     # without h5py's metadata
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "hdf5_fixtures"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    makers = {
        "earliest": (dict(libver="earliest"), lambda f, rng: _general(f, rng, False)),
        "latest_tracked": (dict(libver="latest", track_order=True),
                           lambda f, rng: _general(f, rng, True)),
        "netcdf_l1b": (dict(libver=("v108", "latest"), track_order=True), _l1b),
    }
    for i, (name, (kw, make)) in enumerate(makers.items()):
        path = os.path.join(args.out, f"{name}.h5")
        with h5py.File(path, "w", **kw) as f:
            make(f, np.random.default_rng(20 + i))
        np.savez(os.path.join(args.out, f"{name}.npz"), **_npz_of(path))
        print(f"{path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
