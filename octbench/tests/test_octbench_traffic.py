"""The generator: one stream per seed, scans of the stated properties."""

import hashlib

import numpy as np
import pytest
import torch

from octbench import grid, spec, traffic


def _small(name="goes-meso-b13", n=40, frames=3, sequences=2):
    cfg = spec.load_json(f"{spec.HERE}/configs/{name}.json")
    cfg["rows"] = cfg["cols"] = n
    tr = spec.traffic("meso-loop")
    tr.update(frames=frames, sequences=sequences)
    return cfg, tr


def test_same_seed_same_stream_other_seed_other():
    cfg, tr = _small()
    seed = 2 ** 31 + 977
    a = traffic.make_stream(cfg, tr, seed, "cpu")
    b = traffic.make_stream(cfg, tr, seed, "cpu")
    c = traffic.make_stream(cfg, tr, seed + 1, "cpu")
    for la, lb, lc in zip(a.frames, b.frames, c.frames):
        for fa, fb, fc in zip(la, lb, lc):
            assert fa.dtype == np.int16 and np.array_equal(fa, fb)
            assert not np.array_equal(fa, fc)
    assert a.times == b.times and a.pairs == b.pairs


def test_pairs_walk_each_loop_and_never_wrap():
    cfg, tr = _small(frames=4, sequences=3)
    st = traffic.make_stream(cfg, tr, 5, "cpu")
    assert st.pairs == [(s, i) for s in range(3) for i in range(3)]
    for s in range(3):
        dts = np.diff(st.times[s])
        assert np.all(dts == cfg["cadence_s"])
    for s, i in st.pairs:
        assert not np.array_equal(st.frames[s][i], st.frames[s][i + 1])


def test_full_disk_space_takes_the_space_count():
    cfg = spec.load_json(f"{spec.HERE}/configs/goes-fd-b13.json")
    # a coarse full disk: every 64th column and row of the grid
    cfg.update(rows=85, cols=85, x_scale=cfg["x_scale"] * 64, y_scale=cfg["y_scale"] * 64)
    tr = spec.traffic("fd-stream-pcg")
    tr.update(frames=2)
    st = traffic.make_stream(cfg, tr, 11, "cpu")
    _, on = grid.earth_latlon(cfg, "cpu")
    f = st.frames[0][0]
    assert np.all(f[~on.numpy()] == cfg["space_count"])
    assert f[on.numpy()].min() > cfg["space_count"]        # colder than space is not on earth
    assert 0 < st.max_px <= tr["motion"]["max_speed_ms"] * cfg["cadence_s"] / 2000 + 1e-3


def test_motion_is_capped_and_calm_somewhere():
    cfg, tr = _small(n=64)
    lat, _ = grid.earth_latlon(cfg, "cpu")
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(3)
    dc, dr, calm = traffic.motion_px(cfg, tr["motion"], lat, rng, gen, "cpu")
    cap = tr["motion"]["max_speed_ms"] * cfg["cadence_s"] / (cfg["pixel_km"] * 1000)
    speed = torch.sqrt(dc * dc + dr * dr)
    assert float(speed.max()) <= cap * (1 + 1e-5)
    assert 0.0 < calm < 1.0 and float(speed.min()) < 0.2 * float(speed.max())


def test_a_mix_lays_its_keys_over_its_base():
    # a PCG cell and its SOR twin send the same stream: only the relaxer differs
    for name, base in (("fd-stream-pcg", "fd-stream"), ("fd-stream-sor", "fd-stream"),
                       ("meso-loop-sor", "meso-loop")):
        assert {k: v for k, v in spec.traffic(name).items() if k != "solver"} == \
            spec.traffic(base)
    assert spec.traffic("fd-stream-pcg")["solver"] == "pcg"
    assert spec.traffic("fd-stream-sor")["solver"] == "sor"


@pytest.mark.parametrize("name,mix,n,seed,coarse,digest", [
    ("goes-meso-b13", "meso-loop", 48, 2 ** 31 + 977, False, "bf8a4ad3499b9a24412186ce0c8bf521"),
    ("goes-fd-b13", "fd-stream-sor", 85, 4200000001, True, "ddaa1fde0f26a64449dd8f79d961e738")])
def test_emissive_streams_are_the_first_generators(name, mix, n, seed, coarse, digest):
    # sha256 of the scans that the generator made before it learnt
    # reflective bands: a band-13 stream is the same bits
    cfg = spec.load_json(f"{spec.HERE}/configs/{name}.json")
    if coarse:
        cfg.update(rows=n, cols=n, x_scale=cfg["x_scale"] * 64, y_scale=cfg["y_scale"] * 64)
    else:
        cfg["rows"] = cfg["cols"] = n
    tr = spec.traffic(mix)
    tr.update(frames=3, sequences=2)
    st = traffic.make_stream(cfg, tr, seed, "cpu")
    h = hashlib.sha256()
    for loop in st.frames:
        for f in loop:
            h.update(np.ascontiguousarray(f).tobytes())
    assert h.hexdigest()[:32] == digest


def _band2(n=96):
    """The draft band-2 full disk seen through every 226th pixel."""
    cfg = spec.load_json(f"{spec.HERE}/rehearsal/goes-fd-b2.json")
    k = cfg["cols"] // n
    cfg.update(rows=n, cols=n, x_scale=cfg["x_scale"] * k, y_scale=cfg["y_scale"] * k)
    tr = spec.load_json(f"{spec.HERE}/rehearsal/fd-b2-stream.json")
    tr.update(frames=2)
    return cfg, tr


def test_reflective_scene_is_lit_where_the_sun_is_up_and_ingests_as_the_reference():
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.io.datamodel import NavConstants
    from octane_tpu_torch.io.readers import scene_from_goes_arrays, set_goes_grid

    from octbench import reference

    cfg, tr = _band2()
    n = cfg["rows"]
    st = traffic.make_stream(cfg, tr, 2 ** 33 + 19, "cpu")
    lat, on = grid.earth_latlon(cfg, "cpu")
    mu0 = traffic.cos_solar_zenith(tr["reflectance"], lat, grid.earth_lon(cfg, "cpu"))
    on, lit = on.numpy(), (mu0 > 0.3).numpy()
    dark = on & (mu0 == 0).numpy()
    f = st.frames[0][0]                     # the loop's first scan, not advected
    assert dark.sum() > 100 and (on & lit).sum() > 1000      # the terminator crosses the disk
    assert np.all(f[~on] == cfg["space_count"])
    # no sunlight, no radiance: the count of zero radiance, which space has
    assert np.all(f[dark] == cfg["space_count"])
    assert np.all(f[on & lit] > cfg["space_count"] + 20)
    cal = cfg["calibration"]
    refl = (f.astype(np.float64) * cal["rad_scale"] + cal["rad_offset"]) * cal["kap1"]
    assert 0.0 < refl[on & lit].min() and refl[on].max() < 0.95
    # the port's ingest of band 2 (radiance over its band table) is the reference's
    nav = grid.nav_constants(cfg)
    ocfg = OFConfig(**dict(cfg["settings"], mesh_shape=tuple(cfg["settings"]["mesh_shape"])))
    x, y = grid.scan_counts(cfg)
    for c in st.frames[0]:
        s = scene_from_goes_arrays(c, x, y, set_goes_grid(NavConstants(**nav), n, n, 2), ocfg,
                                   "cpu", donav=True, band=2)
        want = reference.normalised(c, nav, cfg["norm_min"], cfg["norm_max"], "cpu")
        assert float((s.data[0] != want).float().mean()) == 0.0     # ingest_mismatch 0


def test_a_calibration_without_planck_constants():
    cfg, _ = _band2()
    assert not {"fk1", "fk2", "bc1", "bc2"} & set(cfg["calibration"])
    nav = grid.nav_constants(cfg)
    assert nav["fk1"] == nav["bc2"] == (0.0, 0.0, 0.0)
    assert nav["kap1"][0] == grid.f32(cfg["calibration"]["kap1"])
