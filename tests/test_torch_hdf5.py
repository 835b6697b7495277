"""The port's HDF5 / netCDF-4 codec (octane_tpu_torch.io.hdf5) on the CPU:

* the reader against h5py: h5py writes, the codec reads, np.array_equal
  with equal dtypes, over libver {earliest, latest} x track_order x
  storage {contiguous, compact, chunked, chunked + deflate, + shuffle,
  + fletcher32, one chunk, allocated early} x dtype, whole reads, row
  slices across the chunks and chunks never written; attributes compact
  and dense, fixed-length and variable-length strings, 3 and 40 links;
  what it does not read is named when it is asked for;
* the writer against h5py: the codec writes, h5py reads back every
  variable, attribute (value and Python type) and dimension-scale
  attachment;
* the port's product against the JAX package's writer for the same scene,
  as h5py reads both, on the GOES, polar and mercator grids;
* the committed tests/hdf5_fixtures against their .npz, and the script
  that made them;
* with h5py blocked in a subprocess, the CLI turns codec-written L1b files
  (with a CTH and a first guess) into a product, and run_sequence
  checkpoints and resumes, as the same runs do in this process.
"""

import dataclasses
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.io import hdf5
from tests import torch_fixtures as fx

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (37, 23)
CHUNK = (8, 6)
DTYPES = ["i1", "i2", ">i2", "u2", "i4", "f4", "f8"]
STORAGES = ["contiguous", "compact", "chunked", "deflate", "deflate_shuffle", "fletcher32",
            "one_chunk", "early"]
ROW_KEYS = [slice(3, 17), slice(8, 9), slice(30, 37), slice(-5, None), slice(0, 0), 5, -1]


def _values(rng, dtype, shape):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(0, 1e3, shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt.newbyteorder("="),
                        endpoint=True).astype(dt)


def _dcpl(storage):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if storage == "compact":
        dcpl.set_layout(h5py.h5d.COMPACT)
    else:
        dcpl.set_chunk(CHUNK)
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _storage_kw(storage):
    return {"contiguous": {},
            "compact": dict(dcpl=_dcpl("compact")),
            "chunked": dict(chunks=CHUNK),
            "deflate": dict(chunks=CHUNK, compression="gzip"),
            "deflate_shuffle": dict(chunks=CHUNK, compression="gzip", shuffle=True),
            "fletcher32": dict(chunks=CHUNK, compression="gzip", shuffle=True,
                               fletcher32=True),
            "one_chunk": dict(chunks=SHAPE, compression="gzip", shuffle=True),
            "early": dict(dcpl=_dcpl("early"))}[storage]


def _same_dataset(got_ds, want_ds):
    got, want = got_ds[()], want_ds[()]
    assert got_ds.shape == want_ds.shape and got_ds.dtype == want_ds.dtype
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for key in ROW_KEYS:
        a, b = got_ds[key], want_ds[key]
        assert a.dtype == b.dtype and np.array_equal(a, b), key


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("track_order", [False, True])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_reader_matches_h5py_storage(tmp_path, libver, track_order, storage, dtype):
    """A dataset in each storage and a chunked one written only in part
    (the rest of its chunks never written: the fill value) read as h5py
    reads them, whole, by row slices across the chunks and by rows."""
    rng = np.random.default_rng(DTYPES.index(dtype))
    data = _values(rng, dtype, SHAPE)
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver, track_order=track_order) as f:
        f.create_dataset("d", data=data, **_storage_kw(storage))
        if storage not in ("contiguous", "compact"):
            fill = data.flat[7]
            p = f.create_dataset("partial", shape=SHAPE, dtype=dtype, fillvalue=fill,
                                 **_storage_kw(storage))
            p[0:8] = data[0:8]
            p[24:30, 0:6] = data[24:30, 0:6]
    with h5py.File(path, "r") as f, hdf5.File(path, "r") as g:
        assert g.keys() == list(f.keys())
        for name in f:
            _same_dataset(g[name], f[name])


def _attr_values(strings, n):
    """n attributes of the types the port's files hold, cycled."""
    if strings == "fixed":
        texts = [np.bytes_(b"seconds since 2000"), np.array([b"ab", b"cde"], "S3"),
                 np.bytes_(b"")]
    else:
        texts = ["seconds since 2000", np.array(["ab", "cdé"], dtype=h5py.string_dtype()), ""]
    pool = [np.float32(0.01), np.float64(-75.0), np.int32(-7), np.int16(3), np.uint8(200),
            np.int64(1 << 40), np.array([1.5, -2.5], ">f4"), np.arange(4, dtype=np.uint16),
            np.int8(-1), np.float64(1 / 3)] + texts
    return {f"a{i:02d}": pool[i % len(pool)] for i in range(n)}


def _same_attrs(got, want):
    assert got.keys() == list(want.keys())
    for k in want.keys():
        a, b = got[k], want[k]
        assert type(a) is type(b), (k, type(a), type(b))
        if isinstance(b, np.ndarray) and b.dtype == object:
            assert a.shape == b.shape and list(a.ravel()) == list(b.ravel()), k
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("links", [3, 40])
@pytest.mark.parametrize("strings", ["fixed", "vlen"])
@pytest.mark.parametrize("attrs", ["compact", "dense"])
@pytest.mark.parametrize("track_order", [False, True])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_reader_matches_h5py_attributes_and_links(tmp_path, libver, track_order, attrs,
                                                  strings, links):
    """Links and attributes (3, or 20: dense under libver latest) in h5py's
    order, each attribute's value and Python type as h5py returns it."""
    n = 3 if attrs == "compact" else 20
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver, track_order=track_order) as f:
        for k, v in _attr_values(strings, n).items():
            f.attrs[k] = v
        for i in range(links):
            d = f.create_dataset(f"var{(i * 7) % links:02d}", data=np.arange(i + 1, dtype="f4"))
            for k, v in _attr_values(strings, n).items():
                d.attrs[k] = v
    with h5py.File(path, "r") as f, hdf5.File(path, "r") as g:
        assert g.keys() == list(f.keys()) == list(g) and len(g.keys()) == links
        _same_attrs(g.attrs, f.attrs)
        for name in f:
            assert np.array_equal(g[name][()], f[name][()])
            _same_attrs(g[name].attrs, f[name].attrs)
            assert list(g[name].attrs) == g[name].attrs.keys()


@pytest.mark.parametrize("case", ["user_block", "paged_fixed_array", "paged_partly_written"])
def test_reader_finds_user_blocks_and_pages(tmp_path, case):
    """A superblock after a 512-byte user block, and a fixed-array chunk
    index of more than 1024 chunks (paged), some of its pages never
    written (fill value)."""
    path = str(tmp_path / "f.h5")
    data = _values(np.random.default_rng(4), "i2", (64, 80))
    kw = dict(userblock_size=512) if case == "user_block" else dict(libver="latest")
    with h5py.File(path, "w", **kw) as f:
        if case == "paged_partly_written":
            d = f.create_dataset("d", shape=data.shape, dtype="i2", chunks=(1, 2), fillvalue=-5)
            d[40:47] = data[40:47]
        else:
            f.create_dataset("d", data=data, chunks=(1, 2) if case != "user_block" else None)
    with h5py.File(path, "r") as f, hdf5.File(path, "r") as g:
        _same_dataset(g["d"], f["d"])
        if case != "user_block":
            assert g["d"]._index_kind == "farray" and len(g["d"]._chunk_index()) > 0


@pytest.mark.parametrize("case", ["lzf", "extensible_array", "btree2_index", "references",
                                  "soft_link", "not_hdf5"])
def test_reader_names_what_it_does_not_read(tmp_path, case):
    """Storage, filters and attribute types outside the codec's subset raise
    HDF5Error naming them, and only when they are asked for."""
    path = str(tmp_path / "f.h5")
    if case == "not_hdf5":
        with open(path, "wb") as fh:
            fh.write(b"CDF\x01" + bytes(600))
        with pytest.raises(hdf5.HDF5Error, match="not an HDF5 file"):
            hdf5.File(path)
        return
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("ok", data=np.arange(6, dtype=np.int16))
        if case == "lzf":
            f.create_dataset("d", data=np.ones((20, 20), "f4"), chunks=(5, 5), compression="lzf")
        elif case == "extensible_array":
            f.create_dataset("d", data=np.ones((20, 20), "f4"), chunks=(5, 5),
                             maxshape=(None, 20))
        elif case == "btree2_index":
            f.create_dataset("d", data=np.ones((20, 20), "f4"), chunks=(5, 5),
                             maxshape=(None, None))
        elif case == "references":
            x = f.create_dataset("x", data=np.arange(6, dtype=np.int16))
            x.make_scale("x")
            f["ok"].dims[0].attach_scale(x)
            f["ok"].attrs["units"] = "m"
        else:
            f["d"] = h5py.SoftLink("/ok")
    what = {"lzf": "lzf", "extensible_array": "extensible array", "btree2_index": "v2 B-tree",
            "soft_link": "soft link"}
    with hdf5.File(path) as g:
        assert np.array_equal(g["ok"][()], np.arange(6, dtype=np.int16))
        if case == "references":
            assert g["ok"].attrs["units"] == "m" and "DIMENSION_LIST" in g["ok"].attrs
            with pytest.raises(hdf5.HDF5Error, match="variable-length sequence"):
                g["ok"].attrs["DIMENSION_LIST"]
            with pytest.raises(hdf5.HDF5Error, match="compound"):
                g["x"].attrs["REFERENCE_LIST"]
            assert g["x"].attrs["CLASS"] == b"DIMENSION_SCALE"
        else:
            assert "d" in g.keys()
            with pytest.raises(hdf5.HDF5Error, match=what[case]):
                g["d"][()]


WRITE_DTYPES = DTYPES + ["u1", "u4", "i8", "u8", ">f8"]


@pytest.mark.parametrize("dtype", WRITE_DTYPES)
@pytest.mark.parametrize("storage", ["data", "rows", "chunked", "deflate_shuffle"])
def test_writer_round_trip(tmp_path, storage, dtype):
    """What the codec writes, h5py and the codec read back equal: from data,
    by row blocks into a contiguous dataset, chunked with edge chunks and
    with shuffle + deflate; and a scalar."""
    data = _values(np.random.default_rng(3), dtype, SHAPE)
    path = str(tmp_path / "w.h5")
    with hdf5.File(path, "w") as f:
        if storage == "data":
            f.create_dataset("d", data=data)
        elif storage == "rows":
            d = f.create_dataset("d", shape=SHAPE, dtype=dtype)
            for r0 in range(0, SHAPE[0], 10):
                d[r0:r0 + 10] = data[r0:r0 + 10]
        else:
            kw = {"chunks": CHUNK}
            if storage != "chunked":
                kw.update(compression="gzip", compression_opts=6, shuffle=True)
            f.create_dataset("d", data=data, **kw)
        f.create_dataset("s", data=data[3, 4:5].reshape(()))
    with h5py.File(path, "r") as f, hdf5.File(path, "r") as g:
        for got in (f, g):
            assert got["d"].dtype == data.dtype and np.array_equal(got["d"][()], data)
            assert got["s"].shape == () and got["s"].dtype == data.dtype
            assert got["s"][()] == data[3, 4]
        assert f["d"].chunks == (None if storage in ("data", "rows") else CHUNK)


def test_writer_attributes_links_and_scales_open_in_h5py(tmp_path):
    """40 datasets (the root group's B-tree over several symbol nodes),
    attributes of every kind the port writes with the Python types h5py
    returns for them, x/y dimension scales attached as the HDF5
    dimension-scale convention has it, and a chunked dataset of 4900
    chunks (a three-level chunk B-tree)."""
    path = str(tmp_path / "w.h5")
    h, w = 6, 5
    attrs = {"units": "meters per second", "empty": "", "utf8": "x-pixels é",
             "fixed": np.bytes_(b"abc"), "f4": np.float32(0.01), "f8": np.float64(-75.0),
             "i4": np.int32(7), "i8": np.int64(-1 << 40), "u1": np.uint8(255),
             "pyint": 5, "pyfloat": 0.5, "arr": np.arange(3, dtype=">f4")}
    want_types = {"units": str, "empty": str, "utf8": str, "fixed": np.bytes_,
                  "f4": np.float32, "f8": np.float64, "i4": np.int32, "i8": np.int64,
                  "u1": np.uint8, "pyint": np.int64, "pyfloat": np.float64, "arr": np.ndarray}
    big = np.arange(140 * 140, dtype=np.int16).reshape(140, 140)
    with hdf5.File(path, "w") as f:
        x = f.create_dataset("x", data=np.arange(w, dtype=np.int16))
        x.make_scale("x")
        y = f.create_dataset("y", data=np.arange(h, dtype=np.int16))
        y.make_scale("y")
        for i in range(40):
            d = f.create_dataset(f"v{i:02d}", data=np.full((h, w), i, np.int16))
            d.dims[0].attach_scale(y)
            d.dims[1].attach_scale(x)
            for k, v in attrs.items():
                d.attrs[k] = v
        for k, v in attrs.items():
            f.attrs[k] = v
        f.create_dataset("big", data=big, chunks=(2, 2), compression="gzip",
                         compression_opts=1, shuffle=True)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(["x", "y", "big"] + [f"v{i:02d}" for i in range(40)])
        assert np.array_equal(f["big"][()], big)
        for obj in [f] + [f[f"v{i:02d}"] for i in range(40)]:
            for k, v in attrs.items():
                got = obj.attrs[k]
                assert type(got) is want_types[k], (k, type(got))
                assert np.array_equal(got, v if not isinstance(v, bytes) else np.bytes_(v)), k
                if isinstance(v, np.ndarray):
                    assert got.dtype == v.dtype
        for i in range(40):
            d = f[f"v{i:02d}"]
            assert np.array_equal(d[()], np.full((h, w), i, np.int16))
            assert [d.dims[0][0].name, d.dims[1][0].name] == ["/y", "/x"]
            assert h5py.h5ds.is_attached(d.id, f["y"].id, 0)
            assert h5py.h5ds.is_attached(d.id, f["x"].id, 1)
        for name, axis in (("x", 1), ("y", 0)):
            s = f[name]
            assert s.attrs["CLASS"] == b"DIMENSION_SCALE" and s.attrs["NAME"] == name.encode()
            assert h5py.h5ds.is_scale(s.id)
            refs = sorted((f[r].name, int(a)) for r, a in s.attrs["REFERENCE_LIST"])
            assert refs == [(f"/v{i:02d}", axis) for i in range(40)]
    with hdf5.File(path, "r") as g:
        assert np.array_equal(g["big"][37:101], big[37:101])
        assert g["v07"].attrs["utf8"] == "x-pixels é" and g.attrs["pyint"] == 5


def _jax_scene(grid, kind, h=24, w=20):
    """A JAX-package Scene with every product field the writers read."""
    from octane_tpu.io.datamodel import NavConstants as JaxNav
    from octane_tpu.io.datamodel import Scene as JaxScene

    rng = np.random.default_rng(11)
    nav = JaxNav(grid=grid, nx=w, ny=h, x_scale=5.6e-5, x_offset=-5.3e-4, y_scale=-5.6e-5,
                 y_offset=6.4e-4, lpo=-75.0, lat0=0.0, lat1=60.0, lon0_deg=-45.0,
                 lon1=-1.3, R=6371000.0, g2x_offset=-5.2e-4, g2y_offset=6.3e-4,
                 rad_scale=(0.01, 0.02, 0.03), rad_offset=(-0.5, -1.0, -1.5),
                 fk1=(10803.3, 2.0, 3.0), fk2=(1392.74, 5.0, 6.0), bc1=(0.07, 0.1, 0.2),
                 bc2=(0.99, 0.98, 0.97), kap1=(0.0015, 0.002, 0.003))

    def i16():
        return rng.integers(-3000, 3000, (h, w)).astype(np.int16)

    def f32():
        return rng.normal(0, 3, (h, w)).astype(np.float32)

    goes = grid == "goes"
    c = 3 if goes else 1
    raw = (np.stack([i16() for _ in range(c)]) if goes
           else rng.normal(200, 20, (1, h, w)).astype(np.float32))
    js = JaxScene(nav=nav, data=rng.random((c, h, w)).astype(np.float32), t=650000000.0,
                  t_units="seconds since 2000-01-01 12:00:00", band=(13.0, 2.0, 8.0),
                  x=np.arange(w, dtype=np.int16), y=np.arange(h, dtype=np.int16),
                  raw_counts=raw, u_pix=f32(), v_pix=f32(), u_wind=i16(), v_wind=i16(),
                  u_raw=i16(), v_raw=i16(), ctp=i16() if goes else None, dt=60.0,
                  norm_ranges=((1.0, 2.0), (3.0, 4.0), (5.0, 6.0)))
    if not goes:
        js.u_ms = rng.normal(0, 20, (h, w))
        js.v_ms = rng.normal(0, 20, (h, w))
    if kind == "interp":
        js.occlusion = rng.integers(0, 3, (h, w)).astype(np.int16)
        js.frdt, js.t_interp = 1.0 / 3.0, js.t + 20.0
    return js


def _h5py_view(path):
    """Everything h5py sees in a product: per variable its dtype, shape,
    values, attributes (value and Python type; dimension-scale
    attributes by the names they reference) and attached scales."""
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = ({k: (type(v), v) for k, v in f.attrs.items()}, None)
        for name in f:
            d = f[name]
            attrs = {}
            for k, v in d.attrs.items():
                if k == "REFERENCE_LIST":
                    v = sorted((f[r].name, int(a)) for r, a in v)
                elif k == "DIMENSION_LIST":
                    v = [[f[r].name for r in refs] for refs in v]
                attrs[k] = (type(v), v)
            scales = [[s.name for s in d.dims[i].values()] for i in range(d.ndim)]
            out[name] = (attrs, (d.dtype.str, d.shape, d[()], scales, d.chunks,
                                 d.compression))
    return out


@pytest.mark.parametrize("kind", ["plain", "pixuv", "interp", "oftype4"])
@pytest.mark.parametrize("grid", ["goes", "polar", "mercator"])
def test_product_matches_jax_writer(tmp_path, grid, kind):
    """The port's write_product and octane_tpu.io.writers.write_product for
    the same scene are equal as h5py reads them: variables, dtypes, shapes,
    values, storage, attributes with their Python types and the
    dimension-scale attachments."""
    from octane_tpu.config import OFConfig as JaxOFConfig
    from octane_tpu.io.writers import write_product as jax_write_product
    from octane_tpu_torch.io.datamodel import scene_from_numpy
    from octane_tpu_torch.io.writers import write_product

    js = _jax_scene(grid, kind)
    cfg = OFConfig(grid=grid, pixuv=kind == "pixuv", do_cth=grid == "goes", solver="sor")
    if kind == "oftype4":
        cfg = cfg.replace(algorithm="patch_match", rad=1, srad=3)
    interp = kind == "interp"
    ps = scene_from_numpy(dataclasses.asdict(js), "cpu")
    a = _h5py_view(jax_write_product(str(tmp_path / "jax.nc"), js,
                                     JaxOFConfig(**dataclasses.asdict(cfg)), interp=interp))
    b = _h5py_view(write_product(str(tmp_path / "port.nc"), ps, cfg, interp=interp))
    assert list(a) == list(b)
    for name in a:
        (aa, va), (ab, vb) = a[name], b[name]
        assert list(aa) == list(ab), name
        for k in aa:
            assert aa[k][0] is ab[k][0], (name, k, aa[k][0], ab[k][0])
            if aa[k][0] is list:
                assert aa[k][1] == ab[k][1], (name, k)
            else:
                assert np.asarray(aa[k][1]).dtype == np.asarray(ab[k][1]).dtype, (name, k)
                assert np.array_equal(aa[k][1], ab[k][1]), (name, k)
        if va is not None:
            assert va[:2] == vb[:2] and va[3:] == vb[3:], name
            assert np.array_equal(va[2], vb[2]), name


@pytest.mark.parametrize("name", ["earliest", "latest_tracked", "netcdf_l1b"])
def test_committed_fixture_matches_its_npz(name):
    assert fx.check_hdf5_fixture(name) > 10


def test_fixture_script_writes_the_committed_contents(tmp_path):
    """tools/make_hdf5_fixtures.py makes, from its seeds, the contents the
    committed .npz files hold."""
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_hdf5_fixtures.py"),
                    "--out", str(tmp_path)], check=True, capture_output=True, timeout=120)
    for name in ("earliest", "latest_tracked", "netcdf_l1b"):
        new = np.load(tmp_path / f"{name}.npz")
        old = np.load(os.path.join(fx.HDF5_FIXTURES, f"{name}.npz"))
        assert new.files == old.files
        for k in old.files:
            assert new[k].dtype == old[k].dtype and np.array_equal(new[k], old[k]), k


def test_l1b_fixture_reads_as_the_jax_reader_reads_it():
    """read_scene on the netCDF-4-laid-out L1b fixture gives the JAX
    package's reader's (h5py's) scene."""
    from octane_tpu.config import OFConfig as JaxOFConfig
    from octane_tpu.io.readers import read_scene as jax_read_scene
    from octane_tpu_torch.io.readers import read_scene

    path = os.path.join(fx.HDF5_FIXTURES, "netcdf_l1b.h5")
    got = read_scene(path, OFConfig(), device="cpu")
    want = jax_read_scene(path, JaxOFConfig())
    assert np.array_equal(got.raw_counts.numpy(), want.raw_counts)
    np.testing.assert_array_equal(got.data.numpy(), want.data)
    assert got.t == want.t and got.t_units == want.t_units and got.band == want.band
    assert dataclasses.asdict(got.nav) == dataclasses.asdict(want.nav)


_BLOCKED = """
import json, sys
sys.modules["h5py"] = None
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
args = json.loads({args!r})
from octane_tpu_torch import cli
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.sequence import run_sequence
if args["kind"] == "cli":
    assert cli.main(args["argv"]) == 0
else:
    cfg = OFConfig(kiters=2)
    files, out, ck = args["files"], args["out"], args["ckpt"]
    run_sequence(files[:3], cfg, outdir=out, checkpoint=ck, device="cpu")
    resumed = run_sequence(files, cfg, outdir=out, checkpoint=ck, device="cpu")
    assert [p.rsplit("/", 1)[1] for p in resumed] == ["outfile_002.nc"], resumed
assert sys.modules["h5py"] is None
print("ok")
"""


def _run_blocked(kind, **args):
    import json

    code = _BLOCKED.format(root=ROOT, args=json.dumps(dict(args, kind=kind)))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def _same_products(path_a, path_b):
    a, b = _h5py_view(path_a), _h5py_view(path_b)
    assert list(a) == list(b)
    for name in a:
        assert a[name][0].keys() == b[name][0].keys(), name
        if a[name][1] is not None:
            assert a[name][1][:2] == b[name][1][:2], name
            assert np.array_equal(a[name][1][2], b[name][1][2]), name


@pytest.mark.parametrize("kind", ["cli_cth_firstguess", "sequence_resume"])
def test_runs_without_h5py(tmp_path, kind):
    """With h5py blocked (sys.modules["h5py"] = None) in a subprocess, the
    CLI makes a product from codec-written 128^2 L1b files with a CTH and
    a first guess (SRSAL, -pd), and run_sequence checkpoints and resumes;
    their products equal those of the same runs in this process, read
    through h5py."""
    from octane_tpu_torch import cli
    from octane_tpu_torch.sequence import run_sequence

    if kind == "cli_cth_firstguess":
        n = 128
        f1 = fx.make_goes_file(str(tmp_path / "g1.nc"), fx.fixture_counts(0, 0, n, n),
                               chunks=(48, 40))
        f2 = fx.make_goes_file(str(tmp_path / "g2.nc"), fx.fixture_counts(2.0, -1.0, n, n),
                               t=fx.FIXTURE_T0 + 60.0, chunks=(48, 40))
        cth = fx.make_cth_file(str(tmp_path / "cth.nc"), fx.cth_steps(n, n))
        fg = fx.make_firstguess_file(str(tmp_path / "fg.nc"), np.full((n, n), 30.0, "f4"),
                                     np.full((n, n), -10.0, "f4"))
        argv = ["-i1", f1, "-i2", f2, "-i1cth", cth, "-firstguess", fg, "-srsal", "-pd",
                "-kiters", "2", "--device", "cpu"]
        _run_blocked("cli", argv=argv + ["-o", str(tmp_path / "blocked")])
        assert cli.main(argv + ["-o", str(tmp_path / "here")]) == 0
        names = ["outfile.nc"]
    else:
        files = [fx.make_goes_file(str(tmp_path / f"f{i}.nc"),
                                   fx.fixture_counts(2.0 * i, 0, 40, 40),
                                   t=fx.FIXTURE_T0 + 600.0 * i) for i in range(4)]
        _run_blocked("sequence", files=files, out=str(tmp_path / "blocked"),
                     ckpt=str(tmp_path / "ck.h5"))
        with hdf5.File(str(tmp_path / "ck.h5")) as ck:
            assert int(ck["pair_index"][()]) == 2
            assert ck.attrs["files_done"].split("\n") == files
        run_sequence(files, OFConfig(kiters=2), outdir=str(tmp_path / "here"), device="cpu")
        names = [f"outfile_{i:03d}.nc" for i in range(3)]
    for name in names:
        _same_products(str(tmp_path / "blocked" / name), str(tmp_path / "here" / name))
