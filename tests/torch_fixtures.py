"""Synthetic inputs shared by the port's tests and chip_smoke.py.

Imports numpy and, inside its functions, the port; never jax, h5py or
octane_tpu, so chip_smoke.py can use it on a machine that has neither.
The file builders (``make_goes_file``, ``make_flat_grid_file``,
``make_cth_file``, ``make_firstguess_file``) write, through the port's own
HDF5 codec, the variables and attributes that tests/synth.py's builders of
the same names write with h5py; ``make_goes_file`` can also store Rad
chunked, shuffled and deflated, as the NOAA L1b files hold it.
``check_hdf5_fixture`` holds a committed tests/hdf5_fixtures file against
its .npz.
"""

from __future__ import annotations

import os

import numpy as np

# time of the product fixture's first scan (tests/test_golden.py)
FIXTURE_T0 = 650000000.0
# Share of product_512 shorts that must match exactly (all within 1 count).
# One U_raw/V_raw count is 0.01 px; one U/V count is 0.01 m/s, i.e. ~3e-4 px
# at 2 km / 60 s.  The port's flow differs from the JAX CPU program that
# wrote the fixture by float32 round-off (~2e-6 px mean: reductions summed
# in another order), which moves ~0.5 % of U/V shorts across a count
# boundary, so U/V are held to 99 % and the pixel shorts to 99.9 %; the
# flow itself is held to JAX's at 1e-4 px (test_torch_pipeline.py).
EXACT_SHARE = {"U": 0.99, "V": 0.99, "U_raw": 0.999, "V_raw": 0.999}


def fixture_counts(sx, sy, h=512, w=512):
    """The product fixture's scene (tests/test_golden.py:116-124)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return (3000 + 8000 * np.exp(
        -(((xx - sx - w / 2) ** 2 + (yy - sy - h / 2) ** 2) / (2 * 60.0 ** 2)))
        + 1500 * np.sin((xx - sx) / 11.0) * np.cos((yy - sy) / 13.0)
    ).astype(np.int16)


def goes_arrays(counts, t):
    """What the port's reader returns for a file written by
    tests/synth.make_goes_file(path, counts, band=13, t=t) with its default
    calibration and projection: (counts, x, y, nav, t, t_units, band)."""
    from octane_tpu_torch.io.datamodel import NavConstants
    from octane_tpu_torch.io.readers import set_goes_grid

    def f32(v):
        return float(np.float32(v))

    h, w = counts.shape
    x_scale, y_scale = 5.6e-05, -5.6e-05
    nav = NavConstants(grid="goes")
    nav.rad_scale = (f32(0.01), 1.0, 1.0)
    nav.rad_offset = (f32(-0.5), 0.0, 0.0)
    nav.fk1 = (f32(10803.3), 0.0, 0.0)
    nav.fk2 = (f32(1392.74), 0.0, 0.0)
    nav.bc1 = (f32(0.07544), 0.0, 0.0)
    nav.bc2 = (f32(0.99975), 0.0, 0.0)
    nav.kap1 = (f32(0.0015), 0.0, 0.0)
    nav.x_scale, nav.y_scale = f32(x_scale), f32(y_scale)
    nav.x_offset = f32(-x_scale * (w / 2 - 0.5))
    nav.y_offset = f32(-y_scale * (h / 2 - 0.5))
    nav.gip_val, nav.lpo, nav.lat0 = 0.0, -75.0, 0.0
    nav.req, nav.rpol, nav.pph = 6378137.0, 6356752.31414, 35786023.0
    nav.inverse_flattening = 298.2572221
    set_goes_grid(nav, h, w, 13)
    return (counts, np.arange(w, dtype=np.int16), np.arange(h, dtype=np.int16),
            nav, float(t), "seconds since 2000-01-01 12:00:00", 13)


def bench_pair(h, w, seed=0, shift=2.4):
    """The synthetic pair of bench.py:62-75 (true flow: u = shift, v = 0)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def scene(s):
        return (120.0 * np.exp(-(((xx - s - w / 3) ** 2 + (yy - h / 3) ** 2)
                                 / (2 * (w / 8) ** 2)))
                + 60.0 * np.sin((xx - s) / 9.0) * np.cos(yy / 7.0)
                + 50.0 + rng.normal(0, 2.0, (h, w)).astype(np.float32))

    return scene(0.0).astype(np.float32), scene(shift).astype(np.float32)


def cth_steps(h, w, step=2000.0, seed=7):
    """A synthetic cloud-top height (m): 64-px plateaus 2 km apart plus a
    +-30 m ripple, within int16 range.  Across a step every range weight of
    SRSAL underflows; within a plateau the ripple keeps them below 1."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    levels = rng.integers(0, 6, (h // 64 + 1, w // 64 + 1)).astype(np.float32)
    plateaus = levels[(yy // 64).astype(np.int64), (xx // 64).astype(np.int64)]
    return (4000.0 + step * plateaus + 30.0 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
            ).astype(np.float32)


# the GOES-16 imager projection of tests/synth.py (synth.G16_PROJ)
G16_PROJ = dict(
    longitude_of_projection_origin=-75.0,
    semi_major_axis=6378137.0,
    semi_minor_axis=6356752.31414,
    inverse_flattening=298.2572221,
    latitude_of_projection_origin=0.0,
    perspective_point_height=35786023.0,
)


def make_goes_file(path, counts, band=13, t=650000000.0, rad_scale=0.01, rad_offset=-0.5,
                   x_scale=5.6e-05, x_offset=None, y_scale=-5.6e-05, y_offset=None,
                   chunks=None):
    """A GOES-R L1b-like file (synth.make_goes_file's variables and
    attributes) written with the port's codec.  With ``chunks`` (e.g.
    (226, 226), the NOAA files' tiling) Rad is chunked, shuffled and
    deflated at level 1."""
    from octane_tpu_torch.io import hdf5

    h, w = counts.shape
    # half-pixel offset so no scan coordinate is exactly zero (synth's note)
    if x_offset is None:
        x_offset = -x_scale * (w / 2 - 0.5)
    if y_offset is None:
        y_offset = -y_scale * (h / 2 - 0.5)
    with hdf5.File(path, "w") as f:
        packed = dict(chunks=chunks, compression="gzip", compression_opts=1,
                      shuffle=True) if chunks else {}
        d = f.create_dataset("Rad", data=np.asarray(counts, np.int16), **packed)
        d.attrs["scale_factor"] = np.float32(rad_scale)
        d.attrs["add_offset"] = np.float32(rad_offset)
        for name, n, scale, offset in (("x", w, x_scale, x_offset), ("y", h, y_scale, y_offset)):
            v = f.create_dataset(name, data=np.arange(n, dtype=np.int16))
            v.attrs["scale_factor"] = np.float32(scale)
            v.attrs["add_offset"] = np.float32(offset)
        tv = f.create_dataset("t", data=np.float64(t))
        tv.attrs["units"] = "seconds since 2000-01-01 12:00:00"
        f.create_dataset("band_id", data=np.int8(band))
        gip = f.create_dataset("goes_imager_projection", data=np.int32(0))
        for k, v in G16_PROJ.items():
            gip.attrs[k] = np.float64(v)
        f.create_dataset("planck_fk1", data=np.float32(10803.3))
        f.create_dataset("planck_fk2", data=np.float32(1392.74))
        f.create_dataset("planck_bc1", data=np.float32(0.07544))
        f.create_dataset("planck_bc2", data=np.float32(0.99975))
        f.create_dataset("kappa0", data=np.float32(0.0015))
    return path


def make_cth_file(path, cth):
    """synth.make_cth_file through the codec."""
    from octane_tpu_torch.io import hdf5

    with hdf5.File(path, "w") as f:
        f.create_dataset("Cloud_Top_Height_Effective", data=np.asarray(cth, np.float32))
    return path


def make_firstguess_file(path, ufg, vfg):
    """synth.make_firstguess_file through the codec."""
    from octane_tpu_torch.io import hdf5

    with hdf5.File(path, "w") as f:
        f.create_dataset("UFG", data=np.asarray(ufg, np.float32))
        f.create_dataset("VFG", data=np.asarray(vfg, np.float32))
    return path


def make_flat_grid_file(path, data, grid="polar", t=650000000.0, x_scale=1000.0,
                        y_scale=1000.0, lat1=90.0, lon0=0.0, lon1=0.0, R=6371000.0):
    """synth.make_flat_grid_file (a polar or mercator input) through the codec."""
    from octane_tpu_torch.io import hdf5

    h, w = data.shape
    with hdf5.File(path, "w") as f:
        f.create_dataset("Rad", data=np.asarray(data, np.float32))
        for name, n, scale in (("x", w, x_scale), ("y", h, y_scale)):
            v = f.create_dataset(name, data=np.arange(n, dtype=np.int16))
            v.attrs["scale_factor"] = np.float32(scale)
            v.attrs["add_offset"] = np.float32(-scale * n / 2)
        tv = f.create_dataset("t", data=np.float64(t))
        tv.attrs["units"] = "seconds since 2000-01-01 12:00:00"
        gm = f.create_dataset("grid_mapping", data=np.int32(0))
        gm.attrs["R"] = np.float32(R)
        if grid == "polar":
            gm.attrs["lat1"] = np.float32(lat1)
            gm.attrs["lon0"] = np.float32(lon0)
        else:
            gm.attrs["lon1"] = np.float32(lon1)
    return path


HDF5_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hdf5_fixtures")
# row slices that cut across the fixtures' chunks (their rows are chunked by 8)
FIXTURE_ROW_SLICES = ((3, 17), (8, 9), (30, 37), (0, 1))


def check_hdf5_fixture(name):
    """Read tests/hdf5_fixtures/<name>.h5 with the port's codec and hold it
    against <name>.npz: the dataset names in order, each dataset's dtype,
    shape and values (whole and in FIXTURE_ROW_SLICES), each object's
    attribute names in order and the value and Python type of every
    attribute the .npz holds.  Raises AssertionError on a difference;
    returns the number of values compared."""
    from octane_tpu_torch.io import hdf5

    want = np.load(os.path.join(HDF5_FIXTURES, f"{name}.npz"))
    n = 0
    with hdf5.File(os.path.join(HDF5_FIXTURES, f"{name}.h5")) as f:
        names = [str(s) for s in want["__datasets__"]]
        if f.keys() != names:
            raise AssertionError(f"{name}: datasets {f.keys()} != {names}")
        for obj_name in [""] + names:
            obj = f[obj_name] if obj_name else f
            if obj_name:
                got, exp = obj[()], want[obj_name]
                if got.dtype != exp.dtype or not np.array_equal(got, exp):
                    raise AssertionError(f"{name}:{obj_name}: values or dtype differ "
                                         f"({got.dtype} vs {exp.dtype})")
                n += 1
                for r0, r1 in (FIXTURE_ROW_SLICES if exp.ndim == 2 else ()):
                    if not np.array_equal(obj[r0:r1], exp[r0:r1]):
                        raise AssertionError(f"{name}:{obj_name}[{r0}:{r1}] differs")
                    n += 1
            attrs = [str(s) for s in want[f"{obj_name}@"]]
            if obj.attrs.keys() != attrs:
                raise AssertionError(f"{name}:{obj_name}: attributes {obj.attrs.keys()} "
                                     f"!= {attrs}")
            for key in want.files:
                if not key.startswith(f"{obj_name}@") or key == f"{obj_name}@":
                    continue
                got, exp = obj.attrs[key[len(obj_name) + 1:]], want[key]
                if exp.dtype.kind == "U":
                    ok = isinstance(got, str) and got == str(exp)
                elif exp.dtype.kind == "S" and exp.ndim == 0:
                    ok = isinstance(got, np.bytes_) and got == exp[()]
                else:
                    ok = (np.asarray(got).dtype == exp.dtype and np.shape(got) == exp.shape
                          and np.array_equal(got, exp))
                if not ok:
                    raise AssertionError(f"{name}:{key}: {got!r} != {exp!r}")
                n += 1
    return n
