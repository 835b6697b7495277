"""The generator: one stream per seed, scans of the stated properties."""

import numpy as np
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
