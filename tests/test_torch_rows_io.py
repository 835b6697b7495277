"""Row-block ingest and part-file products of the port on the CPU (the
multi-process path's IO), against the port's whole reads and octane_tpu's
row reads.

* ``core.zoom.zoom_out_image_rows`` / ``zoom_in_image_rows`` equal the rows
  of the port's whole zooms bit for bit, and octane_tpu's ``*_rows``
  within rel 1e-5 (their budget against the whole zooms,
  test_torch_multichannel.py), mirroring tests/test_core.py:179-200;
* ``read_scene(row_range=)`` for channel 1, channels 2/3 (as wide,
  zoomed in, zoomed out), the polar and mercator grids, ``read_cth``
  (zoom in bicubic and nearest, as wide, zoom out) and
  ``read_first_guess``: each equal to the rows of the whole read bit for
  bit, and within the budgets of the whole reads against octane_tpu's row
  reads (data rel 1e-5 where regridded, else equal; lat/lon 1e-12 deg);
* the array halves given ``row_range`` equal the file halves;
* a product merged from ``RowBlockSource`` part files holds the variables
  of a whole write, values and types.
"""

import dataclasses

import h5py
import numpy as np
import pytest
import torch

from octane_tpu.config import OFConfig as JaxOFConfig
from octane_tpu.core.zoom import zoom_in_image_rows as jax_zoom_in_rows
from octane_tpu.core.zoom import zoom_out_image_rows as jax_zoom_out_rows
from octane_tpu.io.readers import read_cth as jax_read_cth
from octane_tpu.io.readers import read_first_guess as jax_read_first_guess
from octane_tpu.io.readers import read_scene as jax_read_scene
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.zoom import (zoom_in_image, zoom_in_image_rows, zoom_out_image,
                                        zoom_out_image_rows)
from octane_tpu_torch.io.readers import (channel_onto_scene, cth_onto_scene,
                                         first_guess_onto_scene, read_cth, read_first_guess,
                                         read_scene, scene_from_flat_arrays,
                                         scene_from_goes_arrays)
from octane_tpu_torch.io.writers import RowBlockSource, RowBlockStack, write_product
from octane_tpu_torch.pipeline import run_pipeline
from tests import torch_fixtures as fx
from tests.synth import (make_cth_file, make_firstguess_file, make_flat_grid_file,
                         make_goes_file)

torch.set_num_threads(2)
H, W = 64, 80
BLOCKS = ((0, 9), (16, 40), (56, 64))     # top edge, interior, bottom edge


def _jax_cfg(cfg):
    return JaxOFConfig(**dataclasses.asdict(cfg))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _src():
    rng = np.random.default_rng(0)
    return rng.normal(100, 30, (97, 130)).astype(np.float32)


# ----------------------------------------------------------------------------
# the *_rows zooms
# ----------------------------------------------------------------------------

def test_zoom_out_rows_equal_the_whole_zoom_and_jax():
    src = _src()
    f = 48 / 130
    full = zoom_out_image(torch.from_numpy(src), f)
    nyy = full.shape[0]
    for r0, r1 in ((0, 7), (5, 20), (nyy - 6, nyy)):
        blk = zoom_out_image_rows(lambda s0, s1: src[s0:s1], 97, 130, f, (r0, r1))
        assert torch.equal(blk, full[r0:r1])
        want = np.asarray(jax_zoom_out_rows(lambda s0, s1: src[s0:s1], 97, 130, f, (r0, r1)))
        assert _rel(blk.numpy(), want) <= 1e-5


@pytest.mark.parametrize("bicubic", [True, False])
def test_zoom_in_rows_equal_the_whole_zoom_and_jax(bicubic):
    src = _src()
    full = zoom_in_image(torch.from_numpy(src), (201, 260), bicubic)
    for r0, r1 in ((0, 9), (50, 101), (195, 201)):
        blk = zoom_in_image_rows(lambda s0, s1: src[s0:s1], 97, 130, (201, 260), (r0, r1),
                                 bicubic)
        assert torch.equal(blk, full[r0:r1])
        want = np.asarray(jax_zoom_in_rows(lambda s0, s1: src[s0:s1], 97, 130, (201, 260),
                                           (r0, r1), bicubic))
        if bicubic:
            assert _rel(blk.numpy(), want) <= 1e-5
        else:                       # nearest: values of the source
            np.testing.assert_array_equal(blk.numpy(), want)


# ----------------------------------------------------------------------------
# the readers' row_range
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 64 x 80 band-13 scene, channel files of bands 3 and 8 as wide,
    half as wide and twice as wide, CTH fields on the band-13 grid, a
    quarter of it (zoom in) and twice it (zoom out), first-guess winds and
    polar and mercator scenes."""
    d = tmp_path_factory.mktemp("rows")
    rng = np.random.default_rng(4)
    out = {"ch1": make_goes_file(str(d / "c1.nc"), fx.fixture_counts(0, 0, H, W), band=13)}
    for band in (3, 8):
        for k, (hh, ww) in enumerate(((H, W), (H // 2, W // 2), (2 * H, 2 * W))):
            counts = fx.fixture_counts(1.0, -0.5, hh, ww) // (2 if band == 8 else 1)
            out[(band, k)] = make_goes_file(str(d / f"b{band}_{k}.nc"), counts, band=band,
                                            rad_scale=0.02 if band == 3 else 0.0005,
                                            rad_offset=-1.0 if band == 3 else 3.0)
    for name, (hh, ww) in (("same", (H, W)), ("in", (H // 4, W // 4)),
                           ("out", (2 * H, 2 * W))):
        cth = 6000 + 2000.0 * rng.integers(0, 4, (hh, ww)) + rng.normal(0, 30, (hh, ww))
        out["cth_" + name] = make_cth_file(str(d / f"cth_{name}.nc"), cth.astype(np.float32))
    out["fg"] = make_firstguess_file(str(d / "fg.nc"), rng.normal(40, 5, (H, W)),
                                     rng.normal(10, 5, (H, W)))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    blob = 200 + 55 * np.exp(-(((xx - W / 2) ** 2 + (yy - H / 2) ** 2) / 300.0))
    out["polar"] = make_flat_grid_file(str(d / "p.nc"), blob, grid="polar", lat1=60.0)
    out["mercator"] = make_flat_grid_file(str(d / "m.nc"), blob, grid="mercator", lon1=-75.0)
    return out


@pytest.mark.parametrize("rows", BLOCKS)
def test_channel1_rows_equal_the_whole_read_and_jax(files, rows):
    cfg = OFConfig()
    whole = read_scene(files["ch1"], cfg, donav=True, device="cpu")
    blk = read_scene(files["ch1"], cfg, donav=True, device="cpu", row_range=rows)
    r = slice(*rows)
    assert (blk.nav.ny, blk.nav.nx) == (H, W)          # the nav keeps the grid's dims
    assert dataclasses.asdict(blk.nav) == dataclasses.asdict(whole.nav)
    for got, want in ((blk.data, whole.data[:, r]), (blk.raw_counts, whole.raw_counts[:, r]),
                      (blk.lat, whole.lat[r]), (blk.lon, whole.lon[r]), (blk.y, whole.y[r]),
                      (blk.x, whole.x)):
        assert torch.equal(got, want)
    js = jax_read_scene(files["ch1"], _jax_cfg(cfg), donav=True, row_range=rows)
    np.testing.assert_array_equal(blk.data.numpy(), js.data)
    np.testing.assert_array_equal(blk.raw_counts.numpy(), js.raw_counts)
    np.testing.assert_allclose(blk.lat.numpy(), js.lat, rtol=0, atol=1e-12)


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("channel,band", [(2, 3), (3, 8)])
def test_channel_rows_equal_the_whole_read_and_jax(files, channel, band, k):
    cfg, jcfg = OFConfig(), _jax_cfg(OFConfig())
    scenes = {}
    for rows in (None, *BLOCKS):
        sc = read_scene(files["ch1"], cfg, donav=False, device="cpu", row_range=rows)
        if channel == 3:
            read_scene(files[(3, 0)], cfg, donav=False, channel=2, scene=sc, row_range=rows)
        scenes[rows] = read_scene(files[(band, k)], cfg, donav=False, channel=channel,
                                  scene=sc, row_range=rows)
    whole = scenes.pop(None)
    for rows, sc in scenes.items():
        r = slice(*rows)
        assert torch.equal(sc.data, whole.data[:, r])
        assert torch.equal(sc.raw_counts, whole.raw_counts[:, r])
        js = jax_read_scene(files["ch1"], jcfg, donav=False, row_range=rows)
        if channel == 3:
            jax_read_scene(files[(3, 0)], jcfg, donav=False, channel=2, scene=js, row_range=rows)
        jax_read_scene(files[(band, k)], jcfg, donav=False, channel=channel, scene=js,
                       row_range=rows)
        if k == 0:
            np.testing.assert_array_equal(sc.data.numpy(), js.data)
        else:
            assert _rel(sc.data[-1].numpy(), js.data[-1]) <= 1e-5
        assert np.abs(sc.raw_counts.numpy().astype(np.int32) - js.raw_counts).max() <= 1


@pytest.mark.parametrize("grid", ["polar", "mercator"])
def test_flat_grid_rows_equal_the_whole_read_and_jax(files, grid):
    cfg = OFConfig(grid=grid)
    whole = read_scene(files[grid], cfg, donav=True, device="cpu")
    for rows in BLOCKS:
        blk = read_scene(files[grid], cfg, donav=True, device="cpu", row_range=rows)
        r = slice(*rows)
        assert (blk.nav.ny, blk.nav.nx) == (H, W)
        for got, want in ((blk.data, whole.data[:, r]), (blk.raw_counts, whole.raw_counts[:, r]),
                          (blk.lat, whole.lat[r]), (blk.lon, whole.lon[r])):
            assert torch.equal(got, want)
        js = jax_read_scene(files[grid], _jax_cfg(cfg), donav=True, row_range=rows)
        np.testing.assert_array_equal(blk.data.numpy(), js.data)
        np.testing.assert_allclose(blk.lat.numpy(), js.lat, rtol=0, atol=1e-12)
        np.testing.assert_allclose(blk.lon.numpy(), js.lon, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,bicubic", [("same", True), ("in", True), ("in", False),
                                          ("out", True)])
def test_cth_rows_equal_the_whole_read_and_jax(files, name, bicubic):
    cfg = OFConfig(do_cth=True, interp_cth_bicubic=bicubic)
    jcfg = _jax_cfg(cfg)
    hh, ww = {"same": (H, W), "in": (H // 4, W // 4), "out": (2 * H, 2 * W)}[name]

    def scene(rows, read, s):
        # the CLAVR-x grid of the field (its size on band 13 is the image's)
        s.nav.max_xc, s.nav.max_yc = ww, hh
        return read(files["cth_" + name], s, *((cfg,) if read is read_cth else (jcfg,)),
                    row_range=rows)

    whole = scene(None, read_cth, read_scene(files["ch1"], cfg, device="cpu"))
    for rows in BLOCKS:
        blk = scene(rows, read_cth, read_scene(files["ch1"], cfg, device="cpu", row_range=rows))
        assert blk.cth.shape == (rows[1] - rows[0], W)
        assert torch.equal(blk.cth, whole.cth[slice(*rows)])
        js = scene(rows, jax_read_cth, jax_read_scene(files["ch1"], jcfg, row_range=rows))
        if name == "same" or not bicubic:
            np.testing.assert_array_equal(blk.cth.numpy(), np.asarray(js.cth))
        else:
            assert _rel(blk.cth.numpy(), np.asarray(js.cth)) <= 1e-6


def test_first_guess_rows_equal_the_whole_read_and_jax(files):
    cfg = OFConfig(do_firstguess=True)
    whole = read_first_guess(files["fg"], read_scene(files["ch1"], cfg, device="cpu"))
    for rows in BLOCKS:
        blk = read_first_guess(files["fg"], read_scene(files["ch1"], cfg, device="cpu",
                                                       row_range=rows), row_range=rows)
        assert torch.equal(blk.ufg, whole.ufg[slice(*rows)])
        assert torch.equal(blk.vfg, whole.vfg[slice(*rows)])
        js = jax_read_first_guess(files["fg"], jax_read_scene(files["ch1"], _jax_cfg(cfg),
                                                              row_range=rows), row_range=rows)
        np.testing.assert_array_equal(blk.ufg.numpy(), js.ufg)


# ----------------------------------------------------------------------------
# the array halves with row_range
# ----------------------------------------------------------------------------

def test_array_halves_with_row_range_equal_the_file_halves(files):
    """What chip_smoke.py drives on the card (no h5py there): each array half
    given the whole arrays and ``row_range`` equals the file half's block."""
    cfg = OFConfig(do_cth=True, do_firstguess=True)
    rows = (16, 40)
    sc = read_scene(files["ch1"], cfg, donav=True, device="cpu", row_range=rows)
    read_scene(files[(3, 2)], cfg, donav=False, channel=2, scene=sc, row_range=rows)
    sc.nav.max_xc, sc.nav.max_yc = W // 4, H // 4
    read_cth(files["cth_in"], sc, cfg, row_range=rows)
    read_first_guess(files["fg"], sc, row_range=rows)

    counts, x, y, nav, t, t_units, band = fx.goes_arrays(fx.fixture_counts(0, 0, H, W), 0.0)
    sa = scene_from_goes_arrays(counts, x, y, nav, cfg, "cpu", donav=True, t=t,
                                t_units=t_units, band=band, row_range=rows)
    with h5py.File(files[(3, 2)]) as f:
        rad = f["Rad"]
        cal = dict(rad_scale=rad.attrs["scale_factor"], rad_offset=rad.attrs["add_offset"],
                   fk1=f["planck_fk1"][()], fk2=f["planck_fk2"][()], bc1=f["planck_bc1"][()],
                   bc2=f["planck_bc2"][()], kap1=f["kappa0"][()])
        ch2 = (rad[()], f["x"][()], f["y"][()])
    channel_onto_scene(*ch2, 3, sa, cfg, 2, cal, row_range=rows)
    sa.nav.max_xc, sa.nav.max_yc = W // 4, H // 4
    with h5py.File(files["cth_in"]) as f:
        cth = f["Cloud_Top_Height_Effective"][()]
    with h5py.File(files["fg"]) as f:
        ufg, vfg = f["UFG"][()], f["VFG"][()]
    cth_onto_scene(cth, sa, cfg, "cpu", row_range=rows)
    first_guess_onto_scene(ufg, vfg, sa, "cpu", row_range=rows)
    for name in ("data", "raw_counts", "lat", "lon", "y", "cth", "ufg", "vfg"):
        assert torch.equal(getattr(sa, name), getattr(sc, name)), name

    cfg = OFConfig(grid="polar")
    fl = read_scene(files["polar"], cfg, donav=True, device="cpu", row_range=rows)
    with h5py.File(files["polar"]) as f:
        data, x, y = f["Rad"][()], f["x"][()], f["y"][()]
    fa = scene_from_flat_arrays(data, x, y, fl.nav, cfg, "cpu", donav=True, t=fl.t,
                                t_units=fl.t_units, row_range=rows)
    for name in ("data", "raw_counts", "lat", "lon", "y"):
        assert torch.equal(getattr(fa, name), getattr(fl, name)), name


# ----------------------------------------------------------------------------
# part files merged by the writer
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("grid", ["goes", "polar"])
def test_row_block_merge_equals_a_whole_write(files, tmp_path, grid):
    cfg = OFConfig(pixuv=True, kiters=2, cgiters=6, grid=grid)
    src = files["ch1"] if grid == "goes" else files["polar"]
    whole_path = run_pipeline(src, src, cfg, outdir=str(tmp_path / "whole"), device="cpu")[0]
    with h5py.File(whole_path) as f:
        names = [k for k in f if f[k].ndim == 2]
        whole = {k: f[k][()] for k in names}
    # the same scene with every 2-D variable as part files of three blocks
    sc = read_scene(src, cfg, donav=True, device="cpu")
    from octane_tpu_torch.flow.dispatcher import compute_flow
    compute_flow(sc, read_scene(src, cfg, donav=False, device="cpu"), cfg)
    cuts = [(0, 20), (20, 21), (21, H)]
    parts = []
    for i, (r0, r1) in enumerate(cuts):
        path = str(tmp_path / f"part{i}.h5")
        with h5py.File(path, "w") as f:
            for k in names:
                # deliberately wider types in the parts: the writer casts
                f.create_dataset(k, data=whole[k][r0:r1].astype(np.float64))
        parts.append((path, r0, r1))
    attrs = {"Rad": "raw_counts", "U": "u_wind", "V": "v_wind", "U_raw": "u_raw",
             "V_raw": "v_raw", "Upix": "u_pix", "Vpix": "v_pix"}
    if grid != "goes":
        attrs.update(U="u_ms", V="v_ms")
    for k in names:
        source = RowBlockSource(parts, k, (H, W), np.float64)
        if k == "Rad":
            sc.raw_counts = RowBlockStack([source])
        else:
            setattr(sc, attrs[k], source)
    merged = write_product(str(tmp_path / "merged.nc"), sc, cfg)
    with h5py.File(merged) as f, h5py.File(whole_path) as g:
        assert sorted(f) == sorted(g)
        for k in names:
            assert f[k].dtype == g[k].dtype, k
            np.testing.assert_array_equal(f[k][()], whole[k], err_msg=k)
