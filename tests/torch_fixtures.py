"""Synthetic inputs shared by the port's tests and chip_smoke.py.

Imports numpy and, inside ``goes_arrays``, the port; never jax, h5py or
octane_tpu, so chip_smoke.py can use it on a machine that has neither.
"""

from __future__ import annotations

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
