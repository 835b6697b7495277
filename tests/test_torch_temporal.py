"""octane_tpu_torch.post.temporal against octane_tpu.post.temporal and the
serial splat oracle ``reference_impl.warpflow`` on the CPU.

* ``forward_splat`` within 1e-5 of both (tests/test_post.py's tolerance);
* ``fill_holes`` equal to octane_tpu's; an all-hole field stops after
  exactly ``max_iters`` steps;
* ``interpolate_frame`` against octane_tpu's: the image within 1e-4, the
  occlusion mask equal;
* tests/test_post.py's static-scene and midpoint cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_impl as ref
from octane_tpu.post import temporal as jt
from octane_tpu_torch.post import temporal as tt
from octane_tpu_torch.post import fill_holes, forward_splat, interpolate_frame

torch.set_num_threads(2)


def _fields(seed, h=24, w=28, c=1):
    rng = np.random.default_rng(seed)
    im1 = rng.normal(120, 20, (c, h, w)).astype(np.float32)
    im2 = rng.normal(120, 20, (c, h, w)).astype(np.float32)
    u = rng.normal(0, 1.5, (h, w)).astype(np.float32)
    v = rng.normal(0, 1.5, (h, w)).astype(np.float32)
    return u, v, im1, im2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("time", [0.5, 1.0 / 3.0, 1.0])
def test_forward_splat_matches_jax_and_oracle(time):
    u, v, im1, im2 = _fields(13)
    got = forward_splat(_t(u), _t(v), _t(im1[0]), _t(im2[0]),
                        torch.tensor(time, dtype=torch.float32))
    want_j = jt.forward_splat(jnp.asarray(u), jnp.asarray(v), jnp.asarray(im1[0]),
                              jnp.asarray(im2[0]), jnp.float32(time))
    want_r = ref.warpflow(u, v, im1[0], im2[0], np.float32(time))
    assert (got[0] < -998).any()              # the case has holes to fill
    for g, j, r in zip(got, want_j, want_r):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [13, 21])
def test_fill_holes_matches_jax(seed):
    u, v, im1, im2 = _fields(seed)
    ut, vt = forward_splat(_t(u), _t(v), _t(im1[0]), _t(im2[0]),
                           torch.tensor(0.5, dtype=torch.float32))
    # a block of holes that needs several steps to close
    ut[4:12, 6:16] = -999.0
    vt[4:12, 6:16] = -999.0
    want = jt.fill_holes(jnp.asarray(ut.numpy()), jnp.asarray(vt.numpy()))
    got = fill_holes(ut, vt)
    assert not (got[0] < -998).any()
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_fill_holes_completes():
    ut = torch.full((8, 8), -999.0)
    ut[4, 4] = 2.0
    fu, _ = fill_holes(ut, ut.clone())
    assert (fu > -998).all()
    np.testing.assert_allclose(fu.numpy(), 2.0, atol=1e-5)


def test_all_hole_field_stops_at_max_iters(monkeypatch):
    steps = []
    real = tt.fill_step
    monkeypatch.setattr(tt, "fill_step", lambda uv: steps.append(1) or real(uv))
    hole = torch.full((6, 7), -999.0)
    fu, fv = fill_holes(hole, hole, max_iters=10)
    assert len(steps) == 10
    assert (fu == -999.0).all() and (fv == -999.0).all()


@pytest.mark.parametrize("frac,channels", [(1.0 / 3.0, 1), (2.0 / 3.0, 1), (0.5, 2)])
def test_interpolate_frame_matches_jax(frac, channels):
    u, v, im1, im2 = _fields(17, c=channels)
    img, occ = interpolate_frame(_t(u), _t(v), _t(im1), _t(im2), frac)
    jimg, jocc = jt.interpolate_frame(jnp.asarray(u), jnp.asarray(v), jnp.asarray(im1),
                                      jnp.asarray(im2), frac)
    assert img.shape == (channels, *u.shape) and occ.dtype == torch.int16
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert set(np.unique(occ.numpy())) == {0, 1, 2}


def test_static_scene_identity():
    rng = np.random.default_rng(17)
    im = _t(rng.uniform(0, 255, (1, 16, 16)).astype(np.float32))
    z = torch.zeros((16, 16))
    img, occ = interpolate_frame(z, z, im, im, 0.5)
    # the reference's clamp rewrites the last row/column from n - 2
    np.testing.assert_allclose(img[:, :-1, :-1].numpy(), im[:, :-1, :-1].numpy(), atol=1e-3)
    np.testing.assert_allclose(img[:, -1, :-1].numpy(), im[:, -2, :-1].numpy(), atol=1e-3)
    assert not occ.any()


def test_translation_midpoint():
    h = w = 32
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def blob(cx):
        return (200 * np.exp(-(((xx - cx) ** 2 + (yy - 16) ** 2) / 18.0))).astype(np.float32)

    u = torch.full((h, w), 4.0)
    img, _ = interpolate_frame(u, torch.zeros((h, w)), _t(blob(12)[None]),
                               _t(blob(16)[None]), 0.5)
    err = np.abs(img[0, 4:-4, 4:-4].numpy() - blob(14)[4:-4, 4:-4]).max()
    assert err < 12.0      # sub-pixel blend error only
