"""octane_tpu_torch's banded post-processing (parallel.post) on the CPU.

* ``sharded_pix2uv`` / ``sharded_pix2uv_ms`` on a (2, 4) mesh equal the
  single-device calls bit for bit (GOES, polar, mercator; the float64
  navigation takes each band's global rows), and octane_tpu's
  ``sharded_pix2uv``;
* ``sharded_srsal`` equals the port's ``srsal_smooth`` on uneven bands
  within rel 1e-6 (the band's rows are the same taps in the same order;
  the CPU's vectorised exp may round by an ulp with the buffer), runs the
  band form on every band, and matches octane_tpu's ``sharded_srsal`` and
  ``srsal_smooth`` within 2e-6 (octane_tpu's own budget); a band thinner
  than p = 18 falls back to the single-device path, as octane_tpu's does.
"""

import numpy as np
import pytest
import torch

from octane_tpu.io.datamodel import NavConstants as JaxNavConstants
from octane_tpu.parallel.mesh import make_mesh as jax_make_mesh
from octane_tpu.parallel.post import sharded_pix2uv as jax_sharded_pix2uv
from octane_tpu.parallel.post import sharded_srsal as jax_sharded_srsal

from octane_tpu_torch import ops
from octane_tpu_torch.io.datamodel import NavConstants
from octane_tpu_torch.nav.winds import pix2uv, pix2uv_ms
from octane_tpu_torch.parallel import (make_mesh, sharded_pix2uv, sharded_pix2uv_ms,
                                       sharded_srsal)
from octane_tpu_torch.post.srsal import srsal_smooth

torch.set_num_threads(2)
CPU = torch.device("cpu")
GOES = dict(grid="goes", x_scale=5.6e-05, x_offset=-0.101332, y_scale=-5.6e-05,
            y_offset=0.128212, min_x=100.0, min_y=200.0)


def _mesh(ry, rx):
    return make_mesh((ry, rx), [CPU] * (ry * rx))


def _flow(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-3, 3, (h, w)).astype(np.float32),
            rng.uniform(-3, 3, (h, w)).astype(np.float32))


def _nav(cls, **kw):
    nav = cls(**kw)
    nav.g2x_offset, nav.g2y_offset = nav.x_offset, nav.y_offset
    return nav


@pytest.mark.parametrize("pixuv", [False, True])
def test_sharded_pix2uv_matches(pixuv):
    h, w = 21, 32                       # 3 rows a band on (2, 4), the last one 0
    u, v = _flow(h, w, 3)
    nav = _nav(NavConstants, **GOES)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    want = pix2uv(tu, tv, nav, 60.0, pixuv=pixuv)
    got = sharded_pix2uv(tu, tv, nav, 60.0, _mesh(2, 4), pixuv=pixuv)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int16 and torch.equal(g, wnt)


def test_sharded_pix2uv_matches_jax():
    h, w = 16, 32
    u, v = _flow(h, w, 4)
    got = sharded_pix2uv(torch.from_numpy(u), torch.from_numpy(v), _nav(NavConstants, **GOES),
                         60.0, _mesh(2, 4))
    want = jax_sharded_pix2uv(u, v, _nav(JaxNavConstants, **GOES), 60.0, jax_make_mesh((2, 4)))
    for g, wnt in zip(got, want):
        d = np.abs(g.numpy().astype(np.int32) - np.asarray(wnt).astype(np.int32))
        assert d.max() <= 1 and (d == 0).mean() > 0.99


@pytest.mark.parametrize("grid,extra", [("goes", {}), ("polar", dict(lat1=60.0, lon0_deg=-30.0)),
                                        ("mercator", dict(lon1=0.3))])
def test_sharded_pix2uv_ms_matches(grid, extra):
    h, w = 30, 24
    u, v = _flow(h, w, 5)
    if grid == "goes":
        nav = _nav(NavConstants, **GOES)
    else:      # the flat grids of tests/test_torch_flatgrid.py
        nav = _nav(NavConstants, grid=grid, nx=w, ny=h, x_scale=2000.0,
                   x_offset=-2000.0 * w / 2, y_scale=2000.0, y_offset=-2000.0 * h / 2,
                   R=6371000.0, **extra)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    want = pix2uv_ms(tu, tv, nav, 60.0, grid=grid)
    got = sharded_pix2uv_ms(tu, tv, nav, 60.0, _mesh(1, 4), grid=grid)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float64 and torch.equal(g, wnt)


def _srsal_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, (h, w)).astype(np.float32),
            rng.normal(0, 3, (h, w)).astype(np.float32),
            rng.normal(8000, 40, (h, w)).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 2), (1, 3)])
def test_sharded_srsal_matches_single_device(shape):
    h, w = 80, 45                       # bands of 20 / 27 rows > p = 18, the last uneven
    t = [torch.from_numpy(a) for a in _srsal_inputs(h, w, 4)]
    ops.reset_counters()
    got = sharded_srsal(*t, _mesh(*shape))
    assert ops.counters()["bilateral_band"][1] == shape[0] * shape[1]
    want = srsal_smooth(*t)
    for g, wnt in zip(got, want):
        assert g.shape == (h, w)
        np.testing.assert_allclose(g.numpy(), wnt.numpy(), rtol=1e-6, atol=1e-6)


def test_sharded_srsal_matches_jax():
    from octane_tpu.post.srsal import srsal_smooth as jax_srsal_smooth

    h, w = 48, 96
    u, v, cth = _srsal_inputs(h, w, 4)
    got = sharded_srsal(*(torch.from_numpy(a) for a in (u, v, cth)), _mesh(1, 2))
    want = jax_srsal_smooth(u, v, cth)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=2e-6, atol=2e-6)


def test_sharded_srsal_matches_jax_sharded():
    h, w = 48, 96           # octane_tpu's blocks 24 x 24 > p on (2, 4), the port's bands 24 rows
    u, v, cth = _srsal_inputs(h, w, 4)
    got = sharded_srsal(*(torch.from_numpy(a) for a in (u, v, cth)), _mesh(1, 2))
    want = jax_sharded_srsal(u, v, cth, jax_make_mesh((2, 4)))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=2e-6, atol=2e-6)


def test_sharded_srsal_thin_bands_fall_back():
    """Bands of 3 rows (24 rows on 8 bands) are thinner than p = 18: the
    single-device path runs, as octane_tpu's sharded_srsal falls back for
    its 12 x 12 blocks."""
    from octane_tpu.post.srsal import srsal_smooth as jax_srsal_smooth

    u, v, cth = _srsal_inputs(24, 48, 5)
    t = [torch.from_numpy(a) for a in (u, v, cth)]
    ops.reset_counters()
    got = sharded_srsal(*t, _mesh(2, 4))
    c = ops.counters()
    assert c["bilateral_band"] == (0, 0) and c["bilateral"][1] == 1
    assert torch.equal(got[0], srsal_smooth(*t)[0])
    jax_got = jax_sharded_srsal(u, v, cth, jax_make_mesh((2, 4)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jax_got[0]), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jax_srsal_smooth(u, v, cth)[0]),
                               rtol=2e-6, atol=2e-6)
