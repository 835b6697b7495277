"""ops.warp: the plain warp and tile statistics against octane_tpu.

* the plain version against ``warp_bilinear_dense`` (XLA gather), including
  +-40 px flow and clamped edges: within 1 ulp, flags exact;
* ``warp_block_stats`` against ``_sample_indices`` + ``_block_stats`` and
  against the Pallas stats kernel in interpret mode: exact integers (the TPU
  column statistic carries the window pad CPAD, which the port drops);
* one 64x128 case against ``make_pallas_warp`` in interpret mode;
* the wrapper's dispatch on a CPU tensor and its input checks.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from octane_tpu.flow.stencil import warp_bilinear_dense as jax_warp
from octane_tpu_torch.ops import warp as warpmod

torch.set_num_threads(2)


def _flow(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    if kind == "small":
        u, v = rng.uniform(-5, 5, (h, w)), rng.uniform(-5, 5, (h, w))
    elif kind == "jet":       # sheared +-40 px jet, rows/cols pushed off the edges
        u = 40.0 * np.tanh((yy - h / 2) / 6.0) + rng.uniform(-1, 1, (h, w))
        u = u + 8.0 * (xx > w - 5) - 8.0 * (xx < 4)
        v = 3.0 * np.sin(xx / 17.0) - 6.0 * (yy < 8) + 6.0 * (yy > h - 9)
    else:                     # values landing in (n-1, n) and on exact edges
        u = np.where(rng.uniform(size=(h, w)) < 0.5, (w - 1) - xx + 0.5,
                     -xx - 0.0)
        v = np.where(rng.uniform(size=(h, w)) < 0.5, (h - 1) - yy + 0.25, -yy)
    return u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("kind", ["small", "jet", "edges"])
@pytest.mark.parametrize("hw", [(64, 128), (45, 70)])
def test_plain_warp_matches_xla(kind, hw):
    h, w = hw
    u, v = _flow(kind, h, w, seed=1)
    fields = np.random.default_rng(2).normal(0, 1, (6, h, w)).astype(np.float32)
    s, bx, by = warpmod.warp_bilinear_dense(torch.from_numpy(fields),
                                            torch.from_numpy(u), torch.from_numpy(v))
    js, jbx, jby = jax_warp(jnp.asarray(fields), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(bx.numpy(), np.asarray(jbx))
    np.testing.assert_array_equal(by.numpy(), np.asarray(jby))
    # XLA may contract the bilinear multiply-adds: 1 ulp
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)


def _jax_stats(u, v):
    import octane_tpu.ops.pallas.warp as wm

    h, w = u.shape
    bh = wm._pick_bh(h, wm._round_dv(wm.DV))
    hp, wp = -(-h // bh) * bh, -(-w // wm.BW) * wm.BW
    jv1, iv1, up, vp = wm._sample_indices(jnp.asarray(u), jnp.asarray(v), h, w, hp, wp)
    stats = [np.asarray(a) for a in wm._block_stats(jv1, iv1, vp, h, w, hp, wp, bh)]
    stats[2] = stats[2] - wm.CPAD           # the port has no column pad
    stats[3] = stats[3] - wm.CPAD
    return np.stack(stats), (h, w, h, w, bh, hp, wp), (up, vp)


@pytest.mark.parametrize("kind", ["small", "jet", "edges"])
@pytest.mark.parametrize("hw", [(100, 130), (64, 128), (40, 300)])
def test_block_stats_match_xla(kind, hw):
    u, v = _flow(kind, *hw, seed=3)
    got = warpmod.warp_block_stats(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    want, _, _ = _jax_stats(u, v)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def interpret_pallas(monkeypatch):
    import octane_tpu.ops.pallas.warp as wm

    monkeypatch.setenv("OCTANE_PALLAS_INTERPRET", "1")
    wm._build.cache_clear()
    wm._stats_build.cache_clear()
    yield
    wm._build.cache_clear()
    wm._stats_build.cache_clear()


def test_against_pallas_warp_interpret(interpret_pallas):
    """The 64x128 tile against the Pallas warp and its stats kernel, both in
    interpret mode."""
    import octane_tpu.ops.pallas.warp as wm

    h, w = 64, 128
    u, v = _flow("small", h, w, seed=4)
    fields = np.random.default_rng(5).normal(0, 1, (6, h, w)).astype(np.float32)
    got, bx, by, stats = warpmod.warp(
        torch.from_numpy(fields), torch.from_numpy(u), torch.from_numpy(v),
        with_stats=True)
    pw = wm.make_pallas_warp((h, w))
    ps, pbx, pby = pw(jnp.asarray(fields), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(bx.numpy(), np.asarray(pbx))
    np.testing.assert_array_equal(by.numpy(), np.asarray(pby))
    # interpret mode is not bit-exact even against XLA (test_warp_kernel.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(ps), rtol=0, atol=1e-5)
    want, args, (up, vp) = _jax_stats(u, v)
    pstats = np.stack([np.asarray(a) for a in wm._stats_build(*args)(up, vp)])
    pstats[2:4] -= wm.CPAD
    np.testing.assert_array_equal(stats.numpy(), pstats)


def test_wrapper_dispatch_and_checks():
    f = torch.zeros((6, 8, 9))
    u = torch.zeros((8, 9))
    before = (warpmod.warp.launches, warpmod.warp.plain_calls)
    s, bx, by = warpmod.warp(f, u, u)
    assert s.shape == (6, 8, 9) and bx.dtype == torch.bool
    assert (warpmod.warp.launches, warpmod.warp.plain_calls) == (before[0], before[1] + 1)
    with pytest.raises(TypeError):
        warpmod.warp(f.double(), u, u)
    with pytest.raises(ValueError):
        warpmod.warp(f, u[:, :5], u[:, :5])
    with pytest.raises(ValueError):
        warpmod.warp(f[:, :, ::2], u[:, ::2], u[:, ::2])
    assert warpmod.pick_bh(64) == 64 and warpmod.pick_bh(63) == 32


def test_warp_band_out_buffers():
    """warp_band writes into ``out`` = (samples, bc_x, bc_y) what it returns
    without it (the plain route on the CPU), and refuses buffers of another
    shape, type or layout."""
    h, w, s0, r0, hb = 40, 24, 6, 10, 12
    u, v = _flow("jet", hb, w, 8)
    slab = torch.from_numpy(np.random.default_rng(9).normal(0, 1, (6, 20, w)).astype(np.float32))
    args = (slab, torch.from_numpy(u) * 0.1, torch.from_numpy(v) * 0.1, s0, r0, h)
    want = warpmod.warp_band(*args)
    out = (torch.empty((6, hb, w)), torch.empty((hb, w), dtype=torch.bool),
           torch.empty((hb, w), dtype=torch.bool))
    got = warpmod.warp_band(*args, out=out)
    assert all(g is o and torch.equal(g, wt) for g, o, wt in zip(got, out, want))
    for bad in ((torch.empty((6, hb, w + 1)), *out[1:]),
                (out[0].double(), *out[1:]),
                (out[0], out[1].float(), out[2]),
                (torch.empty((6, hb, 2 * w))[:, :, ::2], *out[1:]),
                out[:2]):
        with pytest.raises(ValueError, match="out"):
            warpmod.warp_band(*args, out=bad)
