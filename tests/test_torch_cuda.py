"""CUDA kernels of octane_tpu_torch against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present.  Run them on
the GPU with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Budgets: the warp is bit-exact (samples, flags and tile statistics), at
K = 6, 12 and 18 planes (C = 1, 2, 3 channels); so are the PCG passes, the
fused assembly (C = 1, 2, 3) and the SOR pass kernel, block
partials included (the plain versions sum in the kernels' order), and the
PCG and SOR solves; a 30-iteration PCG solve agrees to rel 5e-4 with the
reference loop flow.cg.pcg_solve, a 30-sweep SOR solve to rel 2e-5 with
flow.cg.sor_solve, and the SRSAL bilateral smoother, whose weights are one
base-2 exponent on the card's approximate ex2, to rel 1e-5 with its plain
version (docs/PARITY.md).  Patch-match and the interpolated frame, plain
PyTorch without a kernel, equal the CPU's results on the card (the image
within 1e-4).  The band forms of the mesh path (warp, SOR pass, PCG pass A,
bilateral) equal their plain versions and the whole-image kernels' rows bit
for bit (the bilateral: rel 1e-5 to its plain version), and the banded
pair on a mesh of cuda:0 bands agrees with the single-device pair within
1e-3 px.  Two processes (``parallel.distributed``: gloo on cuda:0, or
nccl one per card where there are two) solve the 512^2 fixture pair, each
its row block, equal to the single-process banded flow's rows.
"""

import numpy as np
import pytest
import torch

from octane_tpu_torch.core.gradients import gradient_4th
from octane_tpu_torch.flow.cg import pcg_solve, sor_solve
from octane_tpu_torch.flow.stencil import StencilSystem, apply_stencil
from octane_tpu_torch.core.gaussian import gaussian_kernel_1d
from octane_tpu_torch.ops import assemble, bilateral, pcg, sor, warp
# by its module name (pytest puts tests/ on the path): an installed package
# named ``tests`` would shadow ``tests.torch_fixtures``
from torch_fixtures import cth_steps

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("spread", [2.0, 40.0, "jet40"])
@pytest.mark.parametrize("hw", [(256, 384), (250, 131), (40, 70)])
def test_warp_kernel_bit_exact(dev, hw, spread):
    """Random flow of +-2 and +-40 px, and ``jet40``: a smooth +-40 px
    shear of v across rows, the large reach that no shared-memory window
    of a tile would hold."""
    h, w = hw
    rng = np.random.default_rng(0)
    fields = torch.from_numpy(rng.normal(0, 1, (6, h, w)).astype(np.float32)).to(dev)
    if spread == "jet40":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        u_np = 2.0 + np.sin(xx / 17.0)
        v_np = 40.0 * np.tanh((yy - h / 2) / 6.0) + 0.5 * np.cos(xx / 11.0)
    else:
        u_np = rng.uniform(-spread, spread, (h, w))
        v_np = rng.uniform(-spread, spread, (h, w))
    u = torch.from_numpy(u_np.astype(np.float32)).to(dev)
    v = torch.from_numpy(v_np.astype(np.float32)).to(dev)
    before = warp.warp.launches
    s, bx, by, stats = warp.warp(fields, u, v, with_stats=True)
    assert warp.warp.launches == before + 1
    ps, pbx, pby = warp.warp_bilinear_dense(fields, u, v)
    assert torch.equal(s, ps) and torch.equal(bx, pbx) and torch.equal(by, pby)
    assert torch.equal(stats, warp.warp_block_stats(u, v))


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("hw", [(256, 384), (250, 131), (40, 70)])
def test_warp_kernel_bit_exact_multichannel(dev, hw, c):
    """The 6C-plane sample stack of C = 2 and 3 channels, +-40 px flow."""
    h, w = hw
    rng = np.random.default_rng(10 + c)
    fields = torch.from_numpy(rng.normal(0, 1, (6 * c, h, w)).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.uniform(-40, 40, (h, w)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.uniform(-40, 40, (h, w)).astype(np.float32)).to(dev)
    s, bx, by, stats = warp.warp(fields, u, v, with_stats=True)
    ps, pbx, pby = warp.warp_bilinear_dense(fields, u, v)
    assert s.shape == (6 * c, h, w)
    assert torch.equal(s, ps) and torch.equal(bx, pbx) and torch.equal(by, pby)
    assert torch.equal(stats, warp.warp_block_stats(u, v))


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("hw", [(256, 384), (97, 131)])
def test_pcg_kernels_match_plain(dev, hw, quad):
    h, w = hw
    rng = np.random.default_rng(1)

    def arr(lo, hi, shape=(h, w)):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

    s = StencilSystem(arr(4.5, 9.0), arr(-0.2, 0.2), arr(4.5, 9.0),
                      *((-1.0,) * 4 if quad else [-arr(0.3, 1.0) for _ in range(4)]),
                      arr(-100, 100), arr(-100, 100))
    cf = torch.stack([s.a1, s.a4, s.a2] + ([] if quad else [s.a5, s.a6, s.a7, s.a8]))
    x, r, p = (arr(-10, 10, (2, h, w)) for _ in range(3))
    ab = torch.tensor([0.4, 0.9], device=dev)
    ka = pcg.pcg_pass_a(x, r, p, cf, ab)
    pa = pcg.pcg_pass_a_plain(x, r, p, cf, ab)
    for k, q in zip(ka, pa):
        assert torch.equal(k, q)
    kb = pcg.pcg_pass_b(r, ka[2], cf, ab[:1].clone())
    pb = pcg.pcg_pass_b_plain(r, ka[2], cf, ab[:1].clone())
    assert torch.equal(kb[0], pb[0]) and torch.equal(kb[1], pb[1])
    fu, fv = pcg.pcg_solve_fused(s, 1e-8, 30)
    gu, gv = pcg.pcg_solve_fused(s, 1e-8, 30, pcg.pcg_pass_a_plain, pcg.pcg_pass_b_plain)
    assert torch.equal(fu, gu) and torch.equal(fv, gv)
    ru, rv = pcg_solve(lambda a, b: apply_stencil(s, a, b), s.a1, s.a4, s.bu, s.bv,
                       1e-8, 30)
    assert max(_rel(fu, ru), _rel(fv, rv)) <= 5e-4


# odd sizes and the 2-row / 2-column minimum: the mirror-at-1 neighbour
# across an edge is the other colour's cell
SHAPES = [(256, 384), (133, 257), (40, 70), (2, 7), (5, 2)]


@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("hw", SHAPES)
def test_assemble_kernel_bit_exact(dev, hw, al1):
    _check_assembly(dev, hw, al1, 1)


@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("hw", [(256, 384), (133, 257), (5, 2)])
def test_assemble_kernel_bit_exact_multichannel(dev, hw, c, al1):
    """C = 2 and 3: 9C + 4 input planes, the channels summed in ascending
    order as the plain version sums them."""
    _check_assembly(dev, hw, al1, c)


def _check_assembly(dev, hw, al1, c):
    h, w = hw
    rng = np.random.default_rng(2 + 10 * (c - 1))

    def arr(*shape, lo=-3.0, hi=3.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

    g1, g2 = arr(c, h, w, lo=0, hi=255), arr(c, h, w, lo=0, hi=255)
    gx1, gy1 = gradient_4th(g1)
    gx2, gy2 = gradient_4th(g2)
    gxx, _ = gradient_4th(gx2)
    gxy, gyy = gradient_4th(gy2)
    u, v = arr(h, w), arr(h, w)
    stack = torch.cat([g2, gx2, gy2, gxx, gxy, gyy]).contiguous()
    samples, bc_x, bc_y = warp.warp_bilinear_dense(stack, u, v)
    g1s = torch.cat([g1, gx1, gy1]).contiguous()
    args = (samples, bc_x, bc_y, g1s, u, v, 0.5 * u, 0.5 * v, al1, 0.05, 5.0, 0.2, True)
    before = assemble.assemble_cf.launches
    kcf, kpart = assemble.assemble_cf(*args)
    assert assemble.assemble_cf.launches == before + 1
    pcf, ppart = assemble.assemble_cf_plain(*args)
    assert kcf.shape[0] == (6 if al1 == 1.0 else 10)
    assert torch.equal(kcf, pcf) and torch.equal(kpart, ppart)


def _sor_system(h, w, quad, dev, seed=3):
    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (h, w)).astype(np.float32)).to(dev)

    offd = (-1.0,) * 4 if quad else tuple(-arr(0.2, 1.2) for _ in range(4))
    return StencilSystem(arr(4.5, 9.0), arr(-0.4, 0.4), arr(4.5, 9.0), *offd,
                         arr(-1, 1), arr(-1, 1))


@pytest.mark.parametrize("sweeps", [1, 6, 8])
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("hw", [(512, 512), (500, 372), (19, 40)])
def test_sor_pass_kernel_bit_exact(dev, hw, quad, sweeps):
    """One launch of the temporally blocked pass against 2 * sweeps plain
    half-sweeps: the iterate and the residual partials bit for bit, and x
    left as it was."""
    h, w = hw
    cf = sor.build_cf(_sor_system(h, w, quad, dev))
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 0.3, (2, h, w))
                         .astype(np.float32)).to(dev)
    x0 = x.clone()
    before = sor.sor_pass.launches
    kx, kpart = sor.sor_pass(x, cf, sweeps, 1.9)
    assert sor.sor_pass.launches == before + 1
    px, ppart = sor.sor_pass_plain(x, cf, sweeps, 1.9)
    assert torch.equal(kx, px) and torch.equal(kpart, ppart)
    assert torch.equal(x, x0)


@pytest.mark.parametrize("strip,seg", [(32, 8), (64, 24), (128, 40), (96, 512)])
def test_sor_pass_kernel_geometries(dev, strip, seg):
    """Strips and segments of other sizes give the same pass."""
    cf = sor.build_cf(_sor_system(133, 257, False, dev))
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 0.3, (2, 133, 257))
                         .astype(np.float32)).to(dev)
    k = 4 if strip == 128 else 8
    kx, kpart = sor._launch_pass(x, cf, k, 1.9, strip=strip, seg=seg)
    px, ppart = sor.sor_pass_plain(x, cf, k, 1.9)
    assert torch.equal(kx, px) and torch.equal(kpart, ppart)


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("hw", SHAPES)
def test_sor_driver_kernels_match_plain(dev, hw, quad):
    s = _sor_system(*hw, quad, dev)
    ku, kv = sor.sor_solve_fused(s, 1e-8, 30)
    pu, pv = sor.sor_solve_fused(s, 1e-8, 30, pass_fn=sor.sor_pass_plain)
    assert torch.equal(ku, pu) and torch.equal(kv, pv)
    tu, tv = sor_solve(s, 1e-8, 30)
    assert max(_rel(ku, tu), _rel(kv, tv)) <= 2e-5


@pytest.mark.parametrize("p", [18, 6])
@pytest.mark.parametrize("cth", ["uniform", "steps", "ripple"])
@pytest.mark.parametrize("hw", [(512, 512), (500, 372), (64, 80), (19, 19)])
def test_bilateral_kernel_within_budget(dev, hw, cth, p):
    """The kernel within rel 1e-5 of its plain version, each of u and v.
    Ragged tiles (500 x 372), reflect edges in every tile (64 x 80), the
    19-px minimum; ``steps``: 2-km plateaus of 8 px, so the range weight
    bites; ``ripple``: the smoke's 2-km plateaus of 64 px with a +-30 m
    ripple, where every weight across a step underflows; p = 6 runs the
    run-time-p instantiation."""
    h, w = hw
    rng = np.random.default_rng(5)
    u, v = (torch.from_numpy(rng.normal(0, 2, hw).astype(np.float32)).to(dev)
            for _ in range(2))
    if cth == "uniform":
        c = rng.uniform(0, 12000, hw)
    elif cth == "steps":
        c = 5000.0 + 2000.0 * np.kron(rng.integers(0, 6, (h // 8 + 1, w // 8 + 1)),
                                      np.ones((8, 8)))[:h, :w]
    else:
        c = cth_steps(h, w)
    c = torch.from_numpy(c.astype(np.float32)).to(dev)
    gk = gaussian_kernel_1d(p / 2.0, p)
    before = bilateral.bilateral.launches
    k = bilateral.bilateral(u, v, c, gk, -1.0 / 800.0)
    assert bilateral.bilateral.launches == before + 1
    q = bilateral.bilateral_plain(u, v, c, gk, -1.0 / 800.0)
    assert k.shape == (2, h, w) and torch.isfinite(k).all()
    assert max(_rel(k[0], q[0]), _rel(k[1], q[1])) <= 1e-5


@pytest.mark.parametrize("form", ["sector", "factored", "first_guess"])
def test_patch_match_card_equals_cpu(dev, monkeypatch, form):
    """patch_match_flow has no kernel of its own: plain PyTorch on the card
    gives the CPU's flow (no FMA contraction in eager ops)."""
    from octane_tpu_torch.flow import patch_match as pm

    if form == "factored":
        monkeypatch.setattr(pm, "FIRST_GUESS_MAX_PIXELS", 1000)
    rng = np.random.default_rng(5)
    im1 = rng.normal(100, 25, (96, 120)).astype(np.float32)
    im2 = (np.roll(im1, (1, 2), axis=(0, 1)) + rng.normal(0, 0.5, im1.shape)).astype(np.float32)
    guess = (None, None)
    if form == "first_guess":
        guess = (np.full(im1.shape, 1.4, np.float32), np.full(im1.shape, 0.6, np.float32))
    got = pm.patch_match_flow(im1, im2, *guess, device=dev)
    want = pm.patch_match_flow(im1, im2, *guess, device="cpu")
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


def test_interpolate_frame_card_equals_cpu(dev):
    from octane_tpu_torch.post.temporal import interpolate_frame

    rng = np.random.default_rng(13)
    h, w = 200, 176
    arrs = (rng.normal(2.4, 1.5, (h, w)), rng.normal(0, 1.5, (h, w)),
            rng.normal(120, 20, (1, h, w)), rng.normal(120, 20, (1, h, w)))
    cpu = [torch.from_numpy(a.astype(np.float32)) for a in arrs]
    for frac in (1.0 / 3.0, 2.0 / 3.0):
        img, occ = interpolate_frame(*[t.to(dev) for t in cpu], frac)
        pimg, pocc = interpolate_frame(*cpu, frac)
        assert torch.equal(occ.cpu(), pocc)
        assert float((img.cpu() - pimg).abs().max()) <= 1e-4


BAND_SPLITS = [(0, 40, 41, 97, 130), (0, 65, 130)]


@pytest.mark.parametrize("splits", BAND_SPLITS)
def test_warp_band_kernel_bit_exact(dev, splits):
    h, w = 130, 200
    rng = np.random.default_rng(31)
    fields = torch.from_numpy(rng.normal(0, 1, (6, h, w)).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.uniform(-6, 6, (h, w)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.uniform(-6, 6, (h, w)).astype(np.float32)).to(dev)
    whole = warp.warp(fields, u, v)
    for r0, r1 in zip(splits[:-1], splits[1:]):
        s0, s1 = max(0, r0 - 8), min(h, r1 + 8)
        args = (fields[:, s0:s1].contiguous(), u[r0:r1], v[r0:r1], s0, r0, h)
        k, q = warp.warp_band(*args), warp.warp_band_plain(*args)
        for a, b, c in zip(k, q, whole):
            assert torch.equal(a, b) and torch.equal(a, c[..., r0:r1, :])


@pytest.mark.parametrize("sweeps", [8, 3])
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("splits", BAND_SPLITS)
def test_sor_pass_band_kernel_bit_exact(dev, splits, quad, sweeps):
    h, w = 130, 200
    rng = np.random.default_rng(32)
    cf = sor.build_cf(_sor_system(h, w, quad, dev))
    x = torch.from_numpy(rng.normal(0, 3, (2, h, w)).astype(np.float32)).to(dev)
    whole, _ = sor.sor_pass(x, cf, sweeps)
    for r0, r1 in zip(splits[:-1], splits[1:]):
        t0, t1 = max(0, r0 - 2 * sweeps), min(h, r1 + 2 * sweeps)
        args = (x[:, t0:t1].contiguous(), cf[:, t0:t1].contiguous(), sweeps, 1.9, t0, h,
                r0 - t0, r1 - t0)
        (kx, kp), (px, pp) = sor.sor_pass_band(*args), sor.sor_pass_band_plain(*args)
        assert torch.equal(kx, px) and torch.equal(kp, pp) and torch.equal(kx, whole[:, r0:r1])


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("splits", BAND_SPLITS)
def test_pcg_pass_a_band_kernel_bit_exact(dev, splits, quad):
    h, w = 130, 200
    rng = np.random.default_rng(33)
    s = _sor_system(h, w, quad, dev)
    cf = torch.stack([s.a1, s.a4, s.a2] + ([] if quad else [s.a5, s.a6, s.a7, s.a8]))
    x, r, p = (torch.from_numpy(rng.normal(0, 10, (2, h, w)).astype(np.float32)).to(dev)
               for _ in range(3))
    ab = torch.tensor([0.37, 0.81], device=dev)
    whole = pcg.pcg_pass_a(x, r, p, cf, ab)
    for r0, r1 in zip(splits[:-1], splits[1:]):
        def ghost(t):
            return torch.stack([t[:, max(r0 - 1, 0)], t[:, min(r1, h - 1)]], dim=1).contiguous()
        args = (*(t[:, r0:r1].contiguous() for t in (x, r, p, cf)), ab, ghost(r), ghost(p),
                ghost(cf[0:2]), r0, h)
        k, q = pcg.pcg_pass_a_band(*args), pcg.pcg_pass_a_band_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(k, q))
        assert all(torch.equal(a, c[:, r0:r1]) for a, c in zip(k[:3], whole[:3]))


@pytest.mark.parametrize("splits", BAND_SPLITS)
def test_bilateral_band_kernel_within_budget(dev, splits):
    h, w = 130, 90
    rng = np.random.default_rng(34)
    u, v = (torch.from_numpy(rng.normal(0, 3, (h, w)).astype(np.float32)).to(dev)
            for _ in range(2))
    cth = torch.from_numpy(cth_steps(h, w)).to(dev)
    gk = gaussian_kernel_1d(9.0, 18)
    whole = bilateral.bilateral(u, v, cth, gk, -1.0 / 800.0)
    for r0, r1 in zip(splits[:-1], splits[1:]):
        s0, s1 = bilateral.band_slab(r0, r1, h, 18)
        args = (u[s0:s1], v[s0:s1], cth[s0:s1], gk, -1.0 / 800.0, s0, r0, r1 - r0, h)
        k, q = bilateral.bilateral_band(*args), bilateral.bilateral_band_plain(*args)
        assert max(_rel(k[i], q[i]) for i in (0, 1)) <= 1e-5
        assert torch.equal(k, whole[:, r0:r1])


@pytest.mark.parametrize("solver", ["sor", "pcg"])
def test_banded_flow_on_the_card(dev, solver):
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.variational import variational_flow
    from octane_tpu_torch.parallel import make_mesh, sharded_variational_flow
    from torch_fixtures import bench_pair

    im1, im2 = (torch.from_numpy(a).to(dev) for a in bench_pair(256, 256))
    z = torch.zeros((256, 256), device=dev)
    cfg = OFConfig(kiters=3, solver=solver)
    u1, v1 = variational_flow(im1, im2, z, z, cfg)
    ops.reset_counters()
    u2, v2 = sharded_variational_flow(im1, im2, z, z, cfg, make_mesh((1, 4), [dev] * 4))
    c = ops.counters()
    assert all(c[k][0] > 0 and c[k][1] == 0 for k in ops.PATHS[f"mesh_{solver}"])
    assert max(float((u1 - u2).abs().max()), float((v1 - v2).abs().max())) <= 1e-3


@pytest.mark.parametrize("solver", ["sor", "pcg"])
def test_two_processes_on_the_card(dev, tmp_path, solver):
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.io.readers import scene_from_goes_arrays
    from octane_tpu_torch.parallel import make_mesh, sharded_variational_flow
    from torch_dist_worker import card_flow, spawn
    from torch_fixtures import FIXTURE_T0, fixture_counts, goes_arrays

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    out = str(tmp_path / "flow")
    spawn(card_flow, [(r, f"file://{tmp_path / 'store'}", backend, out, solver)
                      for r in range(2)], 300)
    cfg = OFConfig(kiters=3, solver=solver)
    s1, s2 = (scene_from_goes_arrays(*goes_arrays(fixture_counts(*shift), t)[:4], cfg, dev,
                                     donav=False, t=t)
              for shift, t in (((0, 0), FIXTURE_T0), ((3.0, -1.5), FIXTURE_T0 + 60.0)))
    z = torch.zeros((512, 512), device=dev)
    u, v = sharded_variational_flow(s1.data, s2.data, z, z, cfg, make_mesh((1, 2), [dev] * 2))
    for r in range(2):
        got = np.load(f"{out}.{r}.npz")
        r0, r1 = got["rows"]
        assert (r0, r1) == ((0, 256) if r == 0 else (256, 512))
        np.testing.assert_array_equal(got["u"], u[r0:r1].cpu().numpy())
        np.testing.assert_array_equal(got["v"], v[r0:r1].cpu().numpy())
        assert (got["launches"] > 0).all() and not got["plain"].any()
