"""The product planes' way to the host (``io.host``, the end of
``flow.dispatcher.compute_flow``) on the CPU.

* Planes made on the CPU stay ordinary, unpinned CPU tensors, with no CUDA
  call, and ``ops.counters()``' ``host_planes`` / ``host_plane_bytes`` stay
  0: on one device and on a mesh of four CPU bands, on the GOES grid and on
  a flat grid (whose float64 winds are products too).
* On a mesh of four CPU bands the products equal the single-device
  ``pix2uv`` / ``pix2uv_ms`` of the same flow.

On the card (test_torch_cuda.py) the planes are page-locked host tensors.
"""

import numpy as np
import pytest
import torch

from octane_tpu_torch import ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow.dispatcher import PRODUCTS, compute_flow
from octane_tpu_torch.io.datamodel import NavConstants
from octane_tpu_torch.io.readers import scene_from_flat_arrays, scene_from_goes_arrays
from octane_tpu_torch.nav.winds import pix2uv, pix2uv_ms
# by its module name (pytest puts tests/ on the path)
from torch_fixtures import FIXTURE_T0, fixture_counts, goes_arrays

H, W = 48, 40


def _goes_pair(cfg):
    """The two-scan GOES fixture (+1.2, -0.6 px over 60 s), scene 1 navigated."""
    scenes = []
    for shift, t, donav in (((0, 0), FIXTURE_T0, True), ((1.2, -0.6), FIXTURE_T0 + 60, False)):
        counts, x, y, nav, t, _, _ = goes_arrays(fixture_counts(*shift, H, W), t)
        scenes.append(scene_from_goes_arrays(counts, x, y, nav, cfg, "cpu", donav=donav, t=t))
    return scenes


def _polar_pair(cfg):
    """A blob 2 px to the east over 600 s on a polar grid at 60 N."""
    nav = dict(grid="polar", nx=W, ny=H, x_scale=2000.0, x_offset=-2000.0 * W / 2,
               y_scale=2000.0, y_offset=-2000.0 * H / 2, R=6371000.0, lat1=60.0,
               lon0_deg=-30.0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    x, y = np.arange(W, dtype=np.int16), np.arange(H, dtype=np.int16)
    return [scene_from_flat_arrays(
        200 * np.exp(-(((xx - cx) ** 2 + (yy - H / 2) ** 2) / 32.0)) + 20, x, y,
        NavConstants(**nav), cfg, "cpu", t=t) for cx, t in ((18.0, 0.0), (20.0, 600.0))]


PAIRS = {"goes": _goes_pair, "polar": _polar_pair}


@pytest.mark.parametrize("mesh", [(1, 1), (4, 1)])
@pytest.mark.parametrize("grid", ["goes", "polar"])
def test_cpu_products_stay_ordinary_host_tensors(monkeypatch, grid, mesh):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call for planes on the CPU")

    for name in ("current_stream", "synchronize", "device_count", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    cfg = OFConfig(kiters=2, grid=grid, mesh_shape=mesh)
    s1, s2 = PAIRS[grid](cfg)
    ops.reset_counters()
    compute_flow(s1, s2, cfg)
    made = [name for name in PRODUCTS if getattr(s1, name) is not None]
    want = ["u_wind", "v_wind", "u_raw", "v_raw"] + (["u_ms", "v_ms"] if grid == "polar" else [])
    assert made == want
    for name in made:
        plane = getattr(s1, name)
        assert plane.device.type == "cpu" and not plane.is_pinned(), name
    c = ops.counters()
    assert c["host_planes"] == 0 and c["host_plane_bytes"] == 0


@pytest.mark.parametrize("grid,pixuv", [("goes", False), ("goes", True), ("polar", False)])
def test_cpu_mesh_products_equal_the_single_device_call(grid, pixuv):
    cfg = OFConfig(kiters=2, grid=grid, pixuv=pixuv, mesh_shape=(4, 1))
    s1, s2 = PAIRS[grid](cfg)
    compute_flow(s1, s2, cfg)
    dt = s2.t - s1.t
    want = pix2uv(s1.u_pix, s1.v_pix, s1.nav, dt, grid=grid, pixuv=pixuv)
    for name, plane in zip(("u_wind", "v_wind", "u_raw", "v_raw"), want):
        assert torch.equal(getattr(s1, name), plane), name
    assert int(s1.u_raw.abs().max()) > 50 and int(s1.u_wind.abs().max()) > 0
    if grid == "polar":
        ums, vms = pix2uv_ms(s1.u_pix, s1.v_pix, s1.nav, dt, grid=grid)
        assert torch.equal(s1.u_ms, ums) and torch.equal(s1.v_ms, vms)
