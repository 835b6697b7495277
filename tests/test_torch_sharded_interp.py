"""The banded interpolation and patch-match of the port on the CPU.

* ``parallel.post.sharded_interpolate_frame`` equals the port's
  ``interpolate_frame`` bit for bit, on bands that take the banded path
  (a splat margin e = 4 * max_disp + 8 below the band height: 2, 3 and 4
  bands, uneven, strong flow at the image's edges) and on bands that take
  the whole frame; against octane_tpu the occlusion is equal and the image
  within rtol 1e-6 / atol 1e-5: tests/test_sharded.py:205-260's two cases
  on its (2, 4) mesh, and the banded cases against octane_tpu's
  ``interpolate_frame`` (its ``sharded_interpolate_frame`` on a mesh whose
  blocks take the banded path compiles for ~80 s on this CPU: slow);
* ``flow.patch_match.patch_match_flow_sharded`` equals ``patch_match_flow``
  bit for bit on 2, 3, 4 and 8 bands, a 35 x 61 shape that divides no band
  count included (tests/test_patch_match.py:60-95), and octane_tpu's
  ``patch_match_flow`` within atol 1e-5 (its ``patch_match_flow_sharded``
  compiles for ~180 s at rad = srad = 1: slow, as its own tests are);
  past the block-size branch (``FIRST_GUESS_MAX_PIXELS`` lowered) a band
  on the per-tap form equals the whole image on the factored form;
* ``-mesh`` runs both on the bands (the dispatcher's patch-match and the
  pipeline's frames).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octane_tpu.flow.patch_match import patch_match_flow as jax_patch_match_flow
from octane_tpu.parallel.mesh import make_mesh as jax_make_mesh
from octane_tpu.parallel.post import sharded_interpolate_frame as jax_sharded_interpolate
from octane_tpu.post.temporal import interpolate_frame as jax_interpolate_frame
from octane_tpu_torch import pipeline
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow import patch_match as pm
from octane_tpu_torch.flow.dispatcher import compute_flow
from octane_tpu_torch.io.readers import scene_from_goes_arrays
from octane_tpu_torch.parallel import make_mesh, post
from octane_tpu_torch.post.temporal import interpolate_frame
from tests import torch_fixtures as fx

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _mesh(ry, rx):
    return make_mesh((ry, rx), [CPU] * (ry * rx))


def _blobs(h, w):
    """test_sharded.py's smooth case: a blob moved (4, -2) px with noisy flow."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    im1 = (100 * np.exp(-(((xx - 40) ** 2 + (yy - 32) ** 2) / 300.0))
           + 20 * np.sin(xx / 5.0) + 40).astype(np.float32)[None]
    im2 = (100 * np.exp(-(((xx - 44) ** 2 + (yy - 30) ** 2) / 300.0))
           + 20 * np.sin((xx - 4) / 5.0) + 40).astype(np.float32)[None]
    rng = np.random.default_rng(6)
    u = (4.0 + rng.normal(0, 0.3, (h, w))).astype(np.float32)
    v = (-2.0 + rng.normal(0, 0.3, (h, w))).astype(np.float32)
    return u, v, im1, im2


def _edges(h, w, c=1):
    """test_sharded.py's global-edge case: flow that varies strongly along
    the image's edges, noise images shifted (-2, 5)."""
    rng = np.random.default_rng(21)
    im1 = rng.normal(100, 30, (c, h, w)).astype(np.float32)
    im2 = np.roll(im1, (0, -2, 5), axis=(0, 1, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = (5.0 + 3.0 * np.sin(yy / 3.0)).astype(np.float32)
    v = (-2.0 + 2.0 * np.cos(xx / 4.0)).astype(np.float32)
    return u, v, im1, im2


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close_to(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case,frac,max_disp", [(_blobs, 0.4, 6), (_edges, 0.5, 9)])
def test_interpolate_mirrors_jax_sharded(case, frac, max_disp):
    """tests/test_sharded.py:205-260 on its (2, 4) mesh and 64 x 128 pairs."""
    inputs = case(64, 128)
    got = post.sharded_interpolate_frame(*_t(*inputs), frac, _mesh(2, 4), max_disp=max_disp)
    want = interpolate_frame(*_t(*inputs), frac)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _close_to(got, jax_sharded_interpolate(*inputs, frac, jax_make_mesh((2, 4)),
                                           max_disp=max_disp))


@pytest.mark.parametrize("hw,shape,max_disp,case", [
    ((128, 128), (1, 2), 6, _blobs),     # 2 bands of 64 rows, e = 32
    ((128, 128), (1, 2), 9, _edges),     # e = 44: sources and cost reads 44 rows away
    ((200, 96), (1, 3), 8, _edges),      # 3 bands of 72, 72, 56 rows
    ((301, 64), (2, 2), 8, _blobs),      # 4 bands of 80 rows, the last 61
])
def test_banded_interpolate_equals_the_whole_frame_and_jax(hw, shape, max_disp, case):
    inputs = case(*hw)
    mesh = _mesh(*shape)
    assert post.splat_margin(max_disp) < -(-hw[0] // mesh.n)      # the banded path
    got = post.sharded_interpolate_frame(*_t(*inputs), 0.5, mesh, max_disp=max_disp)
    want = interpolate_frame(*_t(*inputs), 0.5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    u, v, im1, im2 = (jnp.asarray(a) for a in inputs)
    _close_to(got, jax_interpolate_frame(u, v, im1, im2, 0.5))


def test_banded_interpolate_three_channels():
    inputs = _edges(160, 48, c=3)
    got = post.sharded_interpolate_frame(*_t(*inputs), 0.25, _mesh(1, 2), max_disp=8)
    want = interpolate_frame(*_t(*inputs), 0.25)
    assert got[0].shape == (3, 160, 48)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.slow
def test_banded_interpolate_matches_jax_sharded_banded():
    """octane_tpu's banded path itself: (2, 2) blocks of 64 x 64 with e = 32."""
    inputs = _blobs(128, 128)
    got = post.sharded_interpolate_frame(*_t(*inputs), 0.4, _mesh(1, 2), max_disp=6)
    _close_to(got, jax_sharded_interpolate(*inputs, 0.4, jax_make_mesh((2, 2),
                                                                       jax.devices()[:4]),
                                           max_disp=6))


# ----------------------------------------------------------------------------
# patch-match on bands
# ----------------------------------------------------------------------------

def _pm_pair(h, w, seed=17):
    rng = np.random.default_rng(seed)
    im1 = rng.normal(100, 25, (h, w)).astype(np.float32)
    im2 = np.roll(im1, (1, -1), axis=(0, 1)) + rng.normal(0, 0.4, (h, w)).astype(np.float32)
    return im1, im2


@pytest.mark.parametrize("hw,rad,srad", [((32, 64), 1, 1), ((35, 61), 1, 1),
                                         ((35, 61), 2, 2), ((50, 40), 2, 3)])
def test_patch_match_sharded_equals_single_device_and_jax(hw, rad, srad):
    im1, im2 = _pm_pair(*hw)
    want = pm.patch_match_flow(*_t(im1, im2), rad=rad, srad=srad, device="cpu")
    for n in (2, 3, 4, 8):
        got = pm.patch_match_flow_sharded(*_t(im1, im2), _mesh(1, n), rad=rad, srad=srad)
        assert got[0].shape == hw
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), n
    ju, jv = jax_patch_match_flow(im1, im2, None, None, rad=rad, srad=srad)
    np.testing.assert_allclose(want[0].numpy(), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(want[1].numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_patch_match_bands_across_the_block_size_branch(monkeypatch):
    """With the branch lowered to 1000 pixels the whole 48 x 64 image takes
    the factored form and bands of 8 rows the per-tap form with gather
    probes: the flows are equal."""
    monkeypatch.setattr(pm, "FIRST_GUESS_MAX_PIXELS", 1000)
    im1, im2 = _pm_pair(48, 64, seed=3)
    want = pm.patch_match_flow(*_t(im1, im2), device="cpu")
    for n in (2, 6):
        got = pm.patch_match_flow_sharded(*_t(im1, im2), _mesh(1, n))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), n


@pytest.mark.slow
def test_patch_match_sharded_matches_jax_sharded():
    from octane_tpu.flow.patch_match import patch_match_flow_sharded as jax_sharded

    im1, im2 = _pm_pair(35, 61)
    got = pm.patch_match_flow_sharded(*_t(im1, im2), _mesh(2, 4), rad=1, srad=1)
    ju, jv = jax_sharded(im1, im2, jax_make_mesh((2, 4)), rad=1, srad=1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jv), rtol=0, atol=1e-5)


# ----------------------------------------------------------------------------
# -mesh runs them on the bands
# ----------------------------------------------------------------------------

def test_mesh_runs_patch_match_and_frames_on_the_bands(monkeypatch, tmp_path):
    calls = []
    for mod, name in ((pm, "_patch_match_local"), (post, "interpolate_bands")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    h = w = 96
    c1, c2 = fx.fixture_counts(0, 0, h, w), fx.fixture_counts(1.5, -0.75, h, w)
    cfg = OFConfig(algorithm="hybrid", kiters=2, cgiters=6, solver="sor", mesh_shape=(1, 2),
                   do_interp=True, deltat=30.0)
    s1 = scene_from_goes_arrays(*fx.goes_arrays(c1, 0.0)[:4], cfg, "cpu", t=0.0)
    s2 = scene_from_goes_arrays(*fx.goes_arrays(c2, 60.0)[:4], cfg, "cpu", donav=False,
                                t=60.0)
    compute_flow(s1, s2, cfg)
    assert calls == ["_patch_match_local"] * 2                 # once per band
    monkeypatch.setattr(pipeline, "write_product", lambda path, *a, **k: path)
    frames = pipeline.interpolate_sequence(s1, s2, cfg, str(tmp_path))
    assert len(frames) == 1 and calls[2:] == ["interpolate_bands"]
