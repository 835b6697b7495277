"""Channels 2 and 3 in the port on the CPU, against octane_tpu.

* ``io.readers.read_scene(channel=2|3, scene=...)`` (its file half, then
  ``channel_onto_scene``) against octane_tpu's, on a 64^2 channel-1 scene,
  with a channel as wide (no regrid), narrower (32^2: bicubic zoom in) and
  wider (128^2: blur + bicubic zoom out): NavConstants and the
  normalisation ranges equal, the regridded data within rel 1e-5, the
  pseudo-counts equal;
* ``run_pipeline`` with ``channel2`` and ``channel3`` against octane_tpu's:
  U_raw/V_raw within 1 count on >= 99 % of the pixels, Rad2, Rad3 and the
  per-channel planck/kappa scalars present, and the files otherwise alike;
* ``variational_flow`` at C = 2 and 3 on a 64^2 pair, each relaxer, within
  1e-4 px of octane_tpu's;
* the plain warp at K = 12 and 18 planes and the plain fused assembly at
  C = 2 and 3 against octane_tpu's XLA references (the XLA gather
  ``warp_bilinear_dense``; ``assemble`` + ``build_cf``), as
  tests/test_torch_warp.py and test_torch_assemble.py hold them at C = 1;
* the CLI's -ic21/-ic22 -ic31/-ic32 write what run_pipeline writes.
  The CUDA kernels at C = 2 and 3 are held against these plain versions on
  the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octane_tpu.config import OFConfig as JaxOFConfig
from octane_tpu.flow.stencil import assemble as jax_assemble
from octane_tpu.flow.stencil import warp_bilinear_dense as jax_warp
from octane_tpu.flow.variational import variational_flow as jax_flow
from octane_tpu.io.readers import read_scene as jax_read_scene
from octane_tpu.ops.pallas.sor import build_cf as jax_build_cf
from octane_tpu.pipeline import run_pipeline as jax_run_pipeline
from octane_tpu_torch import cli, ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core.gradients import gradient_4th
from octane_tpu_torch.flow.variational import variational_flow
from octane_tpu_torch.io.readers import channel_onto_scene, read_scene
from octane_tpu_torch.ops import assemble as asm
from octane_tpu_torch.ops.warp import warp, warp_bilinear_dense
from octane_tpu_torch.pipeline import run_pipeline
from tests import torch_fixtures as fx
from tests.synth import make_goes_file

torch.set_num_threads(2)
T0 = fx.FIXTURE_T0


def _jax_cfg(cfg):
    return JaxOFConfig(**dataclasses.asdict(cfg))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """A 64^2 band-13 channel-1 file and channel files of bands 3 and 8 at
    64^2, 32^2 and 128^2."""
    d = tmp_path_factory.mktemp("channels")
    out = {"ch1": make_goes_file(str(d / "c1.nc"), fx.fixture_counts(0, 0, 64, 64), band=13)}
    for band in (3, 8):
        for n in (64, 32, 128):
            counts = fx.fixture_counts(1.0, -0.5, n, n) // (2 if band == 8 else 1)
            out[(band, n)] = make_goes_file(str(d / f"b{band}_{n}.nc"), counts, band=band,
                                            rad_scale=0.02 if band == 3 else 0.0005,
                                            rad_offset=-1.0 if band == 3 else 3.0)
    return out


@pytest.mark.parametrize("n", [64, 32, 128])
@pytest.mark.parametrize("channel,band", [(2, 3), (3, 8)])
def test_channel_onto_scene_matches_jax(scene_files, channel, band, n):
    cfg = OFConfig(norm_min3=2.5, norm_max3=6.5)
    jcfg = _jax_cfg(cfg)
    sc = read_scene(scene_files["ch1"], cfg, donav=True, device="cpu")
    js = jax_read_scene(scene_files["ch1"], jcfg, donav=True)
    if channel == 3:
        # channel 3 after channel 2, as the pipeline reads them
        read_scene(scene_files[(3, 64)], cfg, donav=False, channel=2, scene=sc)
        jax_read_scene(scene_files[(3, 64)], jcfg, donav=False, channel=2, scene=js)
    got = read_scene(scene_files[(band, n)], cfg, donav=False, channel=channel, scene=sc)
    jax_read_scene(scene_files[(band, n)], jcfg, donav=False, channel=channel, scene=js)
    assert got is sc and sc.nchannels == js.nchannels == channel
    assert dataclasses.asdict(sc.nav) == dataclasses.asdict(js.nav)
    assert sc.band == js.band and sc.norm_ranges == js.norm_ranges
    assert sc.norm_ranges[channel - 1] == ((2.5, 6.5) if channel == 3 else (-12.03764377,
                                                                            373.16695681))
    assert sc.data.shape == (channel, 64, 64) and sc.data.dtype == torch.float32
    if n == 64:
        np.testing.assert_array_equal(sc.data.numpy(), js.data)
    else:
        np.testing.assert_array_equal(sc.data[:-1].numpy(), js.data[:-1])
        assert _rel(sc.data[-1].numpy(), js.data[-1]) <= 1e-5
    assert sc.raw_counts.dtype == torch.int16
    np.testing.assert_array_equal(sc.raw_counts.numpy(), js.raw_counts)


def test_channel_onto_scene_is_the_file_half(scene_files):
    """``read_scene(channel=2)`` = the h5py reads + ``channel_onto_scene``
    (the path on the card)."""
    cfg = OFConfig()
    sc = read_scene(scene_files[(3, 128)], cfg, donav=False, channel=2,
                    scene=read_scene(scene_files["ch1"], cfg, device="cpu"))
    with h5py.File(scene_files[(3, 128)]) as f:
        rad = f["Rad"]
        cal = dict(rad_scale=rad.attrs["scale_factor"], rad_offset=rad.attrs["add_offset"],
                   fk1=f["planck_fk1"][()], fk2=f["planck_fk2"][()], bc1=f["planck_bc1"][()],
                   bc2=f["planck_bc2"][()], kap1=f["kappa0"][()])
        counts, x, y = rad[()], f["x"][()], f["y"][()]
    sa = channel_onto_scene(counts, x, y, 3, read_scene(scene_files["ch1"], cfg, device="cpu"),
                            cfg, 2, cal)
    assert torch.equal(sa.data, sc.data) and torch.equal(sa.raw_counts, sc.raw_counts)
    assert sa.nav == sc.nav and sa.band == sc.band


def test_channel_before_channel1_is_refused(scene_files):
    with pytest.raises(ValueError, match="channel 1"):
        read_scene(scene_files[(3, 64)], OFConfig(), channel=2, device="cpu")


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    """A 64^2 pair moved (1.5, -0.75) px over 60 s in three bands: 13, and
    3 (128^2, zoomed out) and 8 (32^2, zoomed in) for channels 2 and 3."""
    d = tmp_path_factory.mktemp("pair3")
    out = {}
    for tag, band, n, t in (("a", 13, 64, T0), ("b", 13, 64, T0 + 60.0)):
        s = (0.0, 0.0) if tag == "a" else (1.5, -0.75)
        out[(1, tag)] = make_goes_file(str(d / f"c1{tag}.nc"),
                                       fx.fixture_counts(*s, 64, 64), band=13, t=t)
        # the wider channel's pixels are half as big: twice the shift
        out[(2, tag)] = make_goes_file(str(d / f"c2{tag}.nc"),
                                       fx.fixture_counts(2 * s[0], 2 * s[1], 128, 128),
                                       band=3, t=t, rad_scale=0.02, rad_offset=-1.0)
        out[(3, tag)] = make_goes_file(str(d / f"c3{tag}.nc"),
                                       fx.fixture_counts(s[0] / 2, s[1] / 2, 32, 32) // 2,
                                       band=8, t=t, rad_scale=0.0005, rad_offset=3.0)
    return out


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_three_channel_pipeline_matches_jax(pair_files, tmp_path, solver):
    f = pair_files
    cfg = OFConfig(kiters=2, solver=solver)
    kw = dict(channel2=(f[(2, "a")], f[(2, "b")]), channel3=(f[(3, "a")], f[(3, "b")]))
    ops.reset_counters()
    port = run_pipeline(f[(1, "a")], f[(1, "b")], cfg, outdir=str(tmp_path / "port"),
                        device="cpu", **kw)
    assert all(ops.counters()[k][1] > 0 for k in ops.PATHS[solver])
    jax = jax_run_pipeline(f[(1, "a")], f[(1, "b")], _jax_cfg(cfg),
                           outdir=str(tmp_path / "jax"), **kw)
    with h5py.File(port[0]) as fp, h5py.File(jax[0]) as fj:
        assert set(fp.keys()) == set(fj.keys())
        assert {"Rad2", "Rad3", "planck_fk1_2", "planck_fk1_3", "kappa0_3"} <= set(fp.keys())
        for name in fj.keys():
            a, b = np.asarray(fj[name][()]), np.asarray(fp[name][()])
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if name in ("U_raw", "V_raw", "U", "V"):
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d.max() <= 1 and (d == 0).mean() >= 0.99, name
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
        assert fp["Rad2"].shape == fp["Rad3"].shape == (64, 64)
        med = float(np.median(fp["U_raw"][()][16:-16, 16:-16]))
    assert abs(med - 150) <= 10


def _bench_stack(c, h, w, seed):
    """The bench pair with c - 1 extra channels from other seeds."""
    ims = [fx.bench_pair(h, w, seed=seed + k) for k in range(c)]
    return (np.stack([a for a, _ in ims]).astype(np.float32),
            np.stack([b for _, b in ims]).astype(np.float32))


@pytest.mark.parametrize("solver", ["pcg", "sor"])
@pytest.mark.parametrize("c", [2, 3])
def test_variational_flow_multichannel_matches_jax(c, solver):
    g1, g2 = _bench_stack(c, 64, 64, seed=3)
    cfg = OFConfig(kiters=3, solver=solver)
    z = np.zeros((64, 64), np.float32)
    u, v = variational_flow(torch.from_numpy(g1), torch.from_numpy(g2), torch.from_numpy(z),
                            torch.from_numpy(z), cfg)
    ju, jv = jax_flow(g1, g2, jnp.asarray(z), jnp.asarray(z), _jax_cfg(cfg))
    for got, want in ((u, ju), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert abs(float(u[16:-16, 16:-16].median()) - 2.4) < 0.1


def _level_inputs(c, h, w, seed):
    rng = np.random.default_rng(seed)
    g1 = torch.from_numpy(rng.normal(100, 30, (c, h, w)).astype(np.float32))
    g2 = torch.from_numpy(rng.normal(100, 30, (c, h, w)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-3, 3, (h, w)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-3, 3, (h, w)).astype(np.float32))
    gx1, gy1 = gradient_4th(g1)
    gx2, gy2 = gradient_4th(g2)
    gxx, _ = gradient_4th(gx2)
    gxy, gyy = gradient_4th(gy2)
    return (g1, g2, gx1, gy1, gx2, gy2, gxx, gxy, gyy), u, v


@pytest.mark.parametrize("c", [2, 3])
def test_plain_warp_multichannel_matches_xla(c):
    """K = 6C planes through the wrapper (plain version on the CPU)."""
    grads, u, v = _level_inputs(c, 45, 70, seed=c)
    g2, gx2, gy2, gxx, gxy, gyy = grads[1], *grads[4:]
    stack = torch.cat([g2, gx2, gy2, gxx, gxy, gyy]).contiguous()
    assert stack.shape[0] == 6 * c
    s, bx, by = warp(stack, 3.0 * u, 3.0 * v)
    js, jbx, jby = jax_warp(jnp.asarray(stack.numpy()), jnp.asarray(3.0 * u.numpy()),
                            jnp.asarray(3.0 * v.numpy()))
    np.testing.assert_array_equal(bx.numpy(), np.asarray(jbx))
    np.testing.assert_array_equal(by.numpy(), np.asarray(jby))
    # XLA may contract the bilinear multiply-adds: 1 ulp
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)


@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("c", [2, 3])
def test_plain_assembly_multichannel_matches_xla(c, al1):
    """The plain fused assembly at C = 2 and 3 against octane_tpu's
    ``assemble`` + ``build_cf`` on the same samples: |d| / (|want| + 1) <=
    2e-6 per coefficient, ||b||^2 rel <= 1e-6 (docs/PARITY.md:93)."""
    h, w = 40, 56
    grads, u, v = _level_inputs(c, h, w, seed=10 + c)
    g1, g2, gx1, gy1, gx2, gy2, gxx, gxy, gyy = grads
    stack = torch.cat([g2, gx2, gy2, gxx, gxy, gyy])
    samples, bc_x, bc_y = warp_bilinear_dense(stack, u, v)
    g1s = torch.cat([g1, gx1, gy1])
    lam_a, lambdac = float(np.float32(0.2)), float(np.float32(0.1))
    cf, partials = asm.assemble_cf(samples, bc_x, bc_y, g1s, u, v, 0.5 * u, 0.5 * v, al1,
                                   lambdac, 5.0, lam_a, True)
    smp = tuple(jnp.asarray(t.numpy()) for t in (samples, bc_x, bc_y))
    sysm = jax_assemble(*(jnp.asarray(g.numpy()) for g in grads),
                        *(jnp.asarray(t.numpy()) for t in (u, v, 0.5 * u, 0.5 * v)),
                        jnp.float32(al1), jnp.float32(5.0), jnp.float32(lam_a),
                        jnp.float32(lambdac), True, warp_fn=lambda *_: smp,
                        al1_static=1.0 if al1 == 1.0 else None)
    want = np.asarray(jax_build_cf(sysm, h, w, al1 == 1.0))
    assert float((np.abs(cf.numpy() - want) / (np.abs(want) + 1.0)).max()) <= 2e-6
    b2 = float((want[3].astype(np.float64) ** 2).sum() + (want[4].astype(np.float64) ** 2).sum())
    assert abs(float(partials.double().sum()) - b2) <= 1e-6 * b2


def test_cli_channels_are_run_pipelines(pair_files, tmp_path):
    """-ic21/-ic22 and -ic31/-ic32 reach run_pipeline's channel2/channel3."""
    f = pair_files
    assert cli.main(["-i1", f[(1, "a")], "-i2", f[(1, "b")], "-ic21", f[(2, "a")],
                     "-ic22", f[(2, "b")], "-ic31", f[(3, "a")], "-ic32", f[(3, "b")],
                     "-kiters", "2", "-o", str(tmp_path / "cli"), "--device", "cpu"]) == 0
    want = run_pipeline(f[(1, "a")], f[(1, "b")], OFConfig(kiters=2),
                        outdir=str(tmp_path / "api"), channel2=(f[(2, "a")], f[(2, "b")]),
                        channel3=(f[(3, "a")], f[(3, "b")]), device="cpu")[0]
    with h5py.File(tmp_path / "cli" / "outfile.nc") as fc, h5py.File(want) as fa:
        assert set(fc.keys()) == set(fa.keys()) and "Rad3" in fc
        for name in fa.keys():
            np.testing.assert_array_equal(fc[name][()], fa[name][()], err_msg=name)
