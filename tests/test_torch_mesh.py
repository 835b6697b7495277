"""The row-banded mesh path of octane_tpu_torch (parallel/) on the CPU: the
exchange, the band forms' plain versions, the banded solvers and warp.

* the exchange against ``np.pad`` (edge), the reference's reflect map and a
  constant, over uneven bands (octane_tpu's tests/test_sharded.py:27-50);
* each band form's plain version against the single-device plain version
  on the same rows: the warp bit-exact, samples pushed into the right and
  bottom extrapolation bands included (test_sharded_pallas.py:131-155),
  the SOR pass bit-exact, PCG pass A bit-exact;
* the banded SOR solve bit-exact against the single-device solve at 8
  and 13 iterations, and against octane_tpu's ``make_sharded_fused_sor``
  in interpret mode within rel 2e-5 (its CPU budget); the banded PCG
  solve within rel 2e-5 of the single-device one and rel 1e-4 of
  octane_tpu's ``make_sharded_fused_cg``, quad and robust;
* the warp's reach test warps every band again from the whole field when
  a jet exceeds ``halo_warp - 2`` and stays exact; ``make_sharded_warp`` against
  octane_tpu's on the (2, 4) CPU mesh within 1e-4 (its halo-frame shift
  is off by an ulp).

Inputs are made from seeds with numpy; bands live on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from octane_tpu.flow.stencil import StencilSystem as JaxStencilSystem
from octane_tpu.flow.stencil import warp_bilinear_dense as jax_warp
from octane_tpu.parallel.mesh import make_mesh as jax_make_mesh
from octane_tpu.parallel.sharded import make_sharded_warp as jax_make_sharded_warp

from octane_tpu_torch import ops
from octane_tpu_torch.core.bc import reflect_index
from octane_tpu_torch.flow.stencil import StencilSystem
from octane_tpu_torch.ops.pcg import (block_partials, pcg_pass_a_band, pcg_pass_a_plain,
                                      pcg_solve_fused)
from octane_tpu_torch.ops.sor import build_cf, sor_pass_band, sor_pass_plain, sor_solve_fused
from octane_tpu_torch.ops.warp import warp_band, warp_bilinear_dense
from octane_tpu_torch.parallel import LocalExchange, band_rows, make_mesh, make_sharded_warp
from octane_tpu_torch.parallel import cg as band_cg
from octane_tpu_torch.parallel import sor as band_sor
from octane_tpu_torch.parallel.sharded import guard_reads

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _mesh(ry, rx):
    return make_mesh((ry, rx), [CPU] * (ry * rx))


def _parts(a, splits):
    t = torch.from_numpy(a)
    return [(r0, t[..., r0:r1, :]) for r0, r1 in zip(splits[:-1], splits[1:]) if r1 > r0]


@pytest.fixture
def interpret_pallas(monkeypatch):
    """octane_tpu's Pallas kernels in interpret mode (its
    tests/test_sharded_pallas.py fixture)."""
    import octane_tpu.ops.pallas.cg as cgmod
    import octane_tpu.ops.pallas.sor as sormod
    import octane_tpu.ops.pallas.warp as warpmod
    import octane_tpu.parallel.sharded as sh

    monkeypatch.setenv("OCTANE_PALLAS_INTERPRET", "1")

    def clear():
        cgmod._build.cache_clear()
        sormod._build.cache_clear()
        warpmod._build.cache_clear()
        warpmod._stats_build.cache_clear()
        sh._warp_cache.clear()
        sh._sharded_program_cache.clear()

    clear()
    yield
    clear()


# ----------------------------------------------------------------------------
# mesh and exchange
# ----------------------------------------------------------------------------

def test_make_mesh_and_band_rows():
    mesh = _mesh(2, 4)
    assert mesh.shape == (2, 4) and mesh.n == 8
    with pytest.raises(ValueError):
        make_mesh((2, 2), [CPU] * 3)
    # ceiling division, as octane_tpu's host_row_block, rounded up to the
    # 8 rows of a reduction block: 27 rows on 8 bands, 5424 on 4
    rows = [band_rows(27, 8, i) for i in range(8)]
    assert rows == [(0, 8), (8, 16), (16, 24), (24, 27)] + [(27, 27)] * 4
    assert [band_rows(5424, 4, i) for i in range(4)] == [(0, 1360), (1360, 2720),
                                                         (2720, 4080), (4080, 5424)]


@pytest.mark.parametrize("splits", [(0, 8, 16), (0, 3, 4, 11, 16), (0, 1, 2, 16)])
def test_exchange_edge_matches_np_pad(splits):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 16, 12)).astype(np.float32)
    halo = 3
    want = np.pad(x, ((0, 0), (halo, halo), (0, 0)), mode="edge")
    parts = _parts(x, splits)
    ex = LocalExchange()
    for r0, r1 in zip(splits[:-1], splits[1:]):
        got = ex.rows(parts, r0 - halo, r1 + halo, CPU)
        np.testing.assert_array_equal(got.numpy(), want[:, r0:r1 + 2 * halo])


@pytest.mark.parametrize("splits", [(0, 20, 40), (0, 5, 33, 40)])
def test_exchange_reflect_and_constant(splits):
    rng = np.random.default_rng(1)
    h, p = 40, 18
    x = rng.normal(0, 1, (h, 7)).astype(np.float32)
    parts = _parts(x, splits)
    ex = LocalExchange()
    # the reference's map: index -k -> k, h-1+k -> h-k (octane_tpu's
    # parallel/post.py _reflect_fix_axis)
    want = x[[reflect_index(i, h) for i in range(-p, h + p)]]
    np.testing.assert_array_equal(ex.rows(parts, -p, h + p, CPU, fill="reflect").numpy(), want)
    got = ex.rows(parts, -2, h + 1, CPU, fill="constant", value=-999.0).numpy()
    np.testing.assert_array_equal(got[2:-1], x)
    assert (got[:2] == -999.0).all() and (got[-1] == -999.0).all()
    with pytest.raises(ValueError):
        ex.rows(parts, 0, 4, CPU, fill="wrap")


# ----------------------------------------------------------------------------
# the band forms' plain versions against the single-device plain versions
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("splits", [(0, 16, 32, 48, 64), (0, 5, 40, 64)])
def test_warp_band_matches_single_device_rows(splits):
    h, w = 64, 96
    rng = np.random.default_rng(5)
    fields = torch.from_numpy(rng.normal(0, 1, (6, h, w)).astype(np.float32))
    u = rng.uniform(-5, 5, (h, w)).astype(np.float32)
    v = rng.uniform(-5, 5, (h, w)).astype(np.float32)
    u[:, -1] = 0.7          # px in (w - 1, w): the right extrapolation band
    v[-1, :] = 0.4          # py in (h - 1, h): the bottom one
    u, v = torch.from_numpy(u), torch.from_numpy(v)
    want = warp_bilinear_dense(fields, u, v)
    for r0, r1 in zip(splits[:-1], splits[1:]):
        s0, s1 = max(0, r0 - 8), min(h, r1 + 8)
        got = warp_band(fields[:, s0:s1].contiguous(), u[r0:r1], v[r0:r1], s0, r0, h)
        for g, wnt in zip(got, want):
            assert torch.equal(g, wnt[..., r0:r1, :])


def _system(h, w, quad, seed=1):
    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (h, w)).astype(np.float32))

    offd = (-1.0,) * 4 if quad else tuple(-arr(0.3, 1.0) for _ in range(4))
    return StencilSystem(arr(4.5, 9.0), arr(-0.2, 0.2), arr(4.5, 9.0), *offd,
                         arr(-100, 100), arr(-100, 100))


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("sweeps", [8, 5, 1])
def test_sor_pass_band_matches_single_device_rows(quad, sweeps):
    h, w = 70, 48
    cf = build_cf(_system(h, w, quad))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 3, (2, h, w)).astype(np.float32))
    want, _ = sor_pass_plain(x, cf, sweeps)
    g = 2 * sweeps
    for r0, r1 in ((0, 20), (20, 21), (21, 55), (55, 70)):
        t0, t1 = max(0, r0 - g), min(h, r1 + g)
        out = torch.empty((2, r1 - r0, w))
        got, part = sor_pass_band(x[:, t0:t1].contiguous(), cf[:, t0:t1].contiguous(), sweeps,
                                  1.9, t0, h, r0 - t0, r1 - t0, out=out)
        assert got is out and torch.equal(got, want[:, r0:r1])
        assert part.numel() == ops.pcg.num_partials(r1 - r0, w)
    with pytest.raises(ValueError, match="ghost"):
        sor_pass_band(x[:, 10:30].contiguous(), cf[:, 10:30].contiguous(), sweeps, 1.9, 10, h,
                      1, 19)


@pytest.mark.parametrize("quad", [True, False])
def test_pcg_pass_a_band_matches_single_device_rows(quad):
    h, w = 50, 40
    s = _system(h, w, quad)
    planes = [s.a1, s.a4, s.a2] + ([] if quad else [s.a5, s.a6, s.a7, s.a8])
    cf = torch.stack(planes)
    rng = np.random.default_rng(3)
    x, r, p = (torch.from_numpy(rng.normal(0, 10, (2, h, w)).astype(np.float32))
               for _ in range(3))
    ab = torch.tensor([0.37, 0.81])
    want = pcg_pass_a_plain(x, r, p, cf, ab)
    for r0, r1 in ((0, 1), (1, 17), (17, 49), (49, 50)):
        def band(t):
            return t[:, r0:r1].contiguous()

        def ghost(t):
            return torch.stack([t[:, max(r0 - 1, 0)], t[:, min(r1, h - 1)]], dim=1)
        got = pcg_pass_a_band(band(x), band(r), band(p), band(cf), ab, ghost(r), ghost(p),
                              ghost(cf[0:2]), r0, h)
        for g, wnt in zip(got[:3], want[:3]):
            assert torch.equal(g, wnt[:, r0:r1])
        pn, ap = want[1][:, r0:r1], want[2][:, r0:r1]      # the band's own 32 x 8 blocks
        assert torch.equal(got[3], block_partials(pn[0] * ap[0] + pn[1] * ap[1]))


# ----------------------------------------------------------------------------
# the banded solvers
# ----------------------------------------------------------------------------

def _jax_system(s):
    def j(t):
        return jnp.asarray(t.numpy()) if torch.is_tensor(t) else jnp.float32(t)
    return JaxStencilSystem(*(j(t) for t in s))


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("iters", [8, 13])
def test_banded_sor_matches_single_device_and_jax(interpret_pallas, quad, iters):
    from octane_tpu.parallel.sor import make_sharded_fused_sor as jax_sor

    h, w = 256, 256
    s = _system(h, w, quad)
    want = sor_solve_fused(s, 1e-8, iters)
    got = band_sor.make_sharded_fused_sor(_mesh(2, 4))(s, 1e-8, iters)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    ju, jv = jax.jit(lambda s: jax_sor(jax_make_mesh((2, 4)))(s, jnp.float32(1e-8), iters))(
        _jax_system(s))
    scale = float(want[0].abs().max())
    d = max(float(np.abs(np.asarray(ju) - got[0].numpy()).max()),
            float(np.abs(np.asarray(jv) - got[1].numpy()).max()))
    assert d / scale < 2e-5, f"rel {d / scale:.2e}"


@pytest.mark.parametrize("quad", [True, False])
def test_banded_pcg_matches_single_device_and_jax(interpret_pallas, quad):
    from octane_tpu.parallel.cg import make_sharded_fused_cg as jax_cg

    h, w = 128, 256
    s = _system(h, w, quad)
    ops.reset_counters()
    want = pcg_solve_fused(s, 1e-8, 10)
    got = band_cg.make_sharded_fused_cg(_mesh(2, 4))(s, 1e-8, 10)
    c = ops.counters()
    assert c["pcg_pass_a_band"][1] == 8 * 10 and c["pcg_pass_a"][1] == 10
    scale = float(want[0].abs().max())
    d = max(float((g - wnt).abs().max()) for g, wnt in zip(got, want))
    assert d / scale < 2e-5, f"rel {d / scale:.2e} vs the single-device solve"
    ju, jv = jax.jit(lambda s: jax_cg(jax_make_mesh((2, 4)))(s, jnp.float32(1e-8), 10))(
        _jax_system(s))
    d = max(float(np.abs(np.asarray(ju) - got[0].numpy()).max()),
            float(np.abs(np.asarray(jv) - got[1].numpy()).max()))
    assert d / scale < 1e-4, f"rel {d / scale:.2e} vs octane_tpu's banded PCG"


def test_banded_sor_uneven_bands_equal_one_band():
    """A mesh of 3 bands of 43 rows and one of 1 (129 rows) solves as one."""
    s = _system(129, 64, False, seed=4)
    want = sor_solve_fused(s, 1e-8, 13)
    got = band_sor.make_sharded_fused_sor(_mesh(1, 4))(s, 1e-8, 13)
    assert all(torch.equal(g, wnt) for g, wnt in zip(got, want))


# ----------------------------------------------------------------------------
# the warp over bands: reach test, against octane_tpu's sharded warp
# ----------------------------------------------------------------------------

def test_reach_guard_widens_the_slab_and_stays_exact():
    h, w = 64, 48
    rng = np.random.default_rng(7)
    fields = torch.from_numpy(rng.normal(0, 1, (6, h, w)).astype(np.float32))
    yy = np.mgrid[0:h, 0:w][0].astype(np.float32)
    u = torch.from_numpy(rng.uniform(-2, 2, (h, w)).astype(np.float32))
    # a jet of +-20 rows: beyond the reach halo - 2 = 6 of an 8-row halo
    v = torch.from_numpy((20.0 * np.tanh((yy - h / 2) / 4.0)).astype(np.float32))
    warp = make_sharded_warp(_mesh(1, 4), (h, w), halo=8)
    guard_reads.reads = 0
    got = warp(fields, u, v)
    want = warp_bilinear_dense(fields, u, v)
    assert guard_reads.reads == 1
    assert all(torch.equal(g, wnt) for g, wnt in zip(got, want))


def test_make_sharded_warp_matches_jax():
    h, w = 64, 128
    rng = np.random.default_rng(5)
    fields = rng.normal(0, 1, (3, h, w)).astype(np.float32)
    u = rng.uniform(-5, 5, (h, w)).astype(np.float32)
    v = rng.uniform(-5, 5, (h, w)).astype(np.float32)
    u[:, -1] = 0.7
    v[-1, :] = 0.4
    jw = jax_make_sharded_warp(jax_make_mesh((2, 4)), (h, w), halo=8)
    want = jw(jnp.asarray(fields), jnp.asarray(u), jnp.asarray(v))
    got = make_sharded_warp(_mesh(2, 4), (h, w), halo=8)(
        *(torch.from_numpy(a) for a in (fields, u, v)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    for g, wnt in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    # and bit-exact against the dense sampler (octane_tpu's own budget is 1e-4)
    dense = jax_warp(jnp.asarray(fields), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(dense[0]), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="padded"):
        make_sharded_warp(_mesh(2, 4), (h, w), halo=8, true_hw=(h - 1, w))
