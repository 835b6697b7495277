"""CUDA kernels of octane_tpu_torch against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present.  Run them on
the GPU with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Budgets: the warp is bit-exact (samples, flags and tile statistics), at
K = 6, 12 and 18 planes (C = 1, 2, 3 channels); so are the PCG passes, the
fused assembly (C = 1, 2, 3) in both layouts (the PCG form also on row
ranges) and the SOR pass kernel, block
partials included (the plain versions sum in the kernels' order), and the
PCG and SOR solves; a 30-iteration PCG solve agrees to rel 5e-4 with the
reference loop flow.cg.pcg_solve, a 30-sweep SOR solve to rel 2e-5 with
flow.cg.sor_solve, and the SRSAL bilateral smoother, whose weights are one
base-2 exponent on the card's approximate ex2, to rel 1e-5 with its plain
version (docs/PARITY.md).  Patch-match's zero-guess search kernel
(ops.patch_match) equals its plain version on the card bit for bit, at
its instances' radii and beyond them, on whole images and bands; patch-match (the search
kernel, and the first-guess path in plain PyTorch) and the interpolated
frame, plain PyTorch without a kernel, equal the CPU's results on the card
(the image within 1e-4).  The band forms of the mesh path (warp, SOR pass, PCG pass A,
bilateral) equal their plain versions and the whole-image kernels' rows bit
for bit (the bilateral: rel 1e-5 to its plain version), and the banded
pair on a mesh of cuda:0 bands agrees with the single-device pair within
1e-3 px.  A level of the solver pyramid (ops.pyramid) equals its plain
version bit for bit, on whole images and band slabs, and a 256^2 pair
through its program equals the internal plain route.  Two processes
(``parallel.distributed``: gloo on cuda:0, or nccl one per card where
there are two) solve the 512^2 fixture pair, each
its row block, equal to the single-process banded flow's rows.  The flow
program's replay equals the eager kernel route bit for bit, with the same
count of relaxer iterations, at a tolerance that stops the relaxer early
too, for a second replay on other inputs as well, and raises nothing
under ``torch.cuda.set_sync_debug_mode("error")``; so does the banded
program's replay on a (1, 4) mesh of cuda:0, against the eager and plain
banded routes, with and without the reach test's wide body, and, where the
machine has 2 cards or more, the banded program captured across the cards
(band i on cuda:i) and each process's program over NCCL (skipped below 2
cards).  A traced program (utils.profiling) writes its stamps in order and
on the host clock and counts its rounds; an untraced one launches the same
kernels and no stamp.  compute_flow's product planes are page-locked host
tensors bit-equal to pix2uv on the card, a pair's planes outlive the next
pair unchanged and are counted, and on a mesh of four cards each band's
rows go to the host from its own card.
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
from torch_fixtures import bench_pair, cth_steps

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


# the 2-row / 2-column minimum; widths one short of and past a partial block
# (32 columns) and pass A's tile (64); heights one short of and past one and
# two of pass A's tiles (16 rows, csrc/pcg.cu); the ragged rows and columns
# of the 1356 and 678 pyramid levels
PCG_SHAPES = [(256, 384), (97, 131), (2, 2), (40, 31), (40, 33), (40, 63), (40, 65), (15, 70),
              (17, 70), (31, 70), (33, 70), (1356, 678)]


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("hw", PCG_SHAPES)
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
    args = _assembly_args(dev, hw, al1, c)
    before = assemble.assemble_cf.launches
    kcf, kpart = assemble.assemble_cf(*args)
    assert assemble.assemble_cf.launches == before + 1
    pcf, ppart = assemble.assemble_cf_plain(*args)
    assert kcf.shape[0] == (6 if al1 == 1.0 else 10)
    assert torch.equal(kcf, pcf) and torch.equal(kpart, ppart)


def _assembly_args(dev, hw, al1, c):
    """One GNC round's assembly arguments on random images and flow."""
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
    return (samples, bc_x, bc_y, g1s, u, v, 0.5 * u, 0.5 * v, al1, 0.05, 5.0, 0.2, True)


@pytest.mark.parametrize("al1", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("hw", [(512, 512), (500, 372), (19, 40)])
def test_assemble_pcg_kernel_bit_exact(dev, hw, c, al1):
    """The PCG form (cf, b and the (n, 3) first-sum partials) against its
    plain version bit for bit, on the whole image and on row ranges of the
    image and of a band's slab (its rows and a ghost row beside each cut):
    three bands aligned to the 8-row blocks and one unaligned range; a
    band's rows equal the whole image's."""
    h = hw[0]
    args = _assembly_args(dev, hw, al1, c)
    fields, scalars = args[:8], args[8:]
    before = assemble.assemble_pcg.launches
    whole = assemble.assemble_pcg(*args)
    assert assemble.assemble_pcg.launches == before + 1
    assert whole[0].shape[0] == (3 if al1 == 1.0 else 7)
    assert all(torch.equal(k, p) for k, p in zip(whole, assemble.assemble_pcg_plain(*args)))
    cuts = sorted({0, 8 * -(-h // 24), 8 * -(-2 * h // 24), h})
    ranges = list(zip(cuts[:-1], cuts[1:])) + [(3, h - 2)]
    for r0, r1 in ranges:
        a0, a1 = max(0, r0 - 1), min(h, r1 + 1)
        slab = tuple(t[..., a0:a1, :].contiguous() for t in fields)
        for inputs, rows in ((slab, (r0 - a0, r1 - a0)), (fields, (r0, r1))):
            k = assemble.assemble_pcg(*inputs, *scalars, rows)
            q = assemble.assemble_pcg_plain(*inputs, *scalars, rows)
            assert all(torch.equal(a, b) for a, b in zip(k, q))
            assert torch.equal(k[0], whole[0][:, r0:r1]) and torch.equal(k[1], whole[1][:, r0:r1])


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
    """patch_match_flow on the card (the search kernel from a zero guess,
    plain PyTorch from a first guess) gives the CPU's flow (no FMA
    contraction in the kernel or in eager ops)."""
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


@pytest.mark.parametrize("radii", [(2, 2), (1, 1), (2, 3), (2, 1), (1, 3), (3, 4), (1, 5)])
@pytest.mark.parametrize("hw,rows", [((96, 120), None), ((97, 131), None), ((3, 131), None),
                                     ((300, 211), (71, 190)), ((300, 211), (250, 300))])
def test_patch_match_search_kernel_bit_exact(dev, hw, rows, radii):
    """One launch a block, its u and v equal to the plain version's bits, on
    a whole image or a band of its rows (edge rows beyond the image)."""
    import torch.nn.functional as F

    from octane_tpu_torch.ops import patch_match as kpm

    (h, w), (rad, srad) = hw, radii
    r0, r1 = rows or (0, h)
    rng = np.random.default_rng(h + rad)
    im1 = rng.normal(100, 25, hw).astype(np.float32)
    im2 = (np.roll(im1, (2, -3), axis=(0, 1)) + rng.normal(0, 0.5, hw)).astype(np.float32)
    blocks = []
    for im, p in ((im1, rad), (im2, rad + srad + 1)):
        g = torch.from_numpy(im).to(dev)[torch.arange(r0 - p, r1 + p).clamp(0, h - 1)]
        blocks.append(F.pad(g[None, None], (p, p, 0, 0), mode="replicate")[0, 0])
    before = kpm.patch_match_search.launches
    got = kpm.patch_match_search(*blocks, rad, srad, h, w, r0)
    assert kpm.patch_match_search.launches == before + 1
    want = kpm.patch_match_search_plain(*blocks, rad, srad, h, w, r0)
    for g, p in zip(got, want):
        assert g.shape == (r1 - r0, w) and g.device.type == "cuda"
        assert _same_bits(g, p)


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


def _same_bits(a, b):
    return torch.equal(a, b) and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("factor", [0.5, 0.25, 0.125, 1 / 32, 1 / 64])
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("hw", [(1001, 777), (256, 384), (4, 9)])
def test_pyramid_level_kernel_bit_exact(dev, hw, n, factor):
    from octane_tpu_torch.core import zoom
    from octane_tpu_torch.ops import pyramid

    h, w = hw
    img = torch.from_numpy(np.random.default_rng(n).uniform(0, 255, (n, h, w))
                           .astype(np.float32)).to(dev)
    rows = (0, zoom.zoom_size(h, factor))
    launches = pyramid.pyramid_level.launches
    got = pyramid.pyramid_level(img, 0, h, factor, rows)
    want = pyramid.pyramid_level_plain(img, 0, h, factor, rows)
    assert got.shape == (n, rows[1], zoom.zoom_size(w, factor))
    # one launch for the planes; none for a level with no pixel
    assert pyramid.pyramid_level.launches == launches + (got.numel() > 0)
    assert _same_bits(got, want) and _same_bits(got, zoom.pyramid_downsample(img, factor))


@pytest.mark.parametrize("factor", [0.5, 0.125, 1 / 32])
@pytest.mark.parametrize("band", ["top", "middle", "bottom"])
def test_pyramid_level_band_kernel_bit_exact(dev, band, factor):
    from octane_tpu_torch.core import zoom
    from octane_tpu_torch.ops import pyramid

    h, w = 2000, 611
    img = torch.from_numpy(np.random.default_rng(3).uniform(0, 255, (4, h, w))
                           .astype(np.float32)).to(dev)
    nyy = zoom.zoom_size(h, factor)
    rows = {"top": (0, nyy // 4 + 3), "middle": (nyy // 4 - 3, nyy // 2 + 3),
            "bottom": (3 * nyy // 4 - 3, nyy)}[band]
    s0, s1 = zoom.pyramid_rows(h, factor, rows)
    slab = img[:, s0:s1].contiguous()
    got = pyramid.pyramid_level(slab, s0, h, factor, rows)
    whole = pyramid.pyramid_level(img, 0, h, factor, (0, nyy))
    assert _same_bits(got, pyramid.pyramid_level_plain(slab, s0, h, factor, rows))
    assert _same_bits(got, whole[:, rows[0]:rows[1]])


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_program_pair_equals_the_plain_route(dev, solver):
    """A 256^2 pair through its program (eager call, capture, replays)
    equals the internal plain route bit for bit, with one pyramid launch a
    coarse level and no plain call."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow import variational as fv

    im1, im2 = (torch.from_numpy(a[None]).to(dev) for a in bench_pair(256, 256))
    z = torch.zeros((256, 256), device=dev)
    cfg = OFConfig(kiters=4, solver=solver)
    pu, pv = fv._coarse_to_fine(im1, im2, z, z, cfg, plain=True)
    prog = fv.flow_program(cfg, (256, 256), 1, dev)
    try:
        for _ in range(3):                  # the eager call, the capture, a replay
            ops.reset_counters()
            u, v = prog(im1, im2, z, z)
            assert torch.equal(u, pu) and torch.equal(v, pv)
            assert ops.counters()["pyramid_level"] == (cfg.kiters - 1, 0)
        assert prog.graph is not None
    finally:
        fv.clear_program_cache()


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
@pytest.mark.parametrize("splits", BAND_SPLITS + [(0, 1, 8, 17, 130), (0, 7, 16, 121, 129, 130),
                                                  (0, 15, 32, 97, 130)])
def test_pcg_pass_a_band_kernel_bit_exact(dev, splits, quad):
    """Bands of 1, 7, 8 and 9 rows beside longer ones, and bands that end one
    short of and one past a tile of pass A."""
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


def test_band_kernels_past_2_31_elements(dev):
    """The band forms on stacks of more than 2^31 elements, at the band-2
    full disk's width (21696): the warp from a whole 21696^2 level's
    6-plane sample stack (2.82e9 elements; a band of the last rows, its
    taps in the stack's last rows), and PCG pass A (quadratic, 3 planes) on
    a band of 33008 rows (2.15e9 elements of coefficients).  Each equals its
    plain version on rows near the end, partials included (~43 GB at the
    most)."""
    w, big = 21696, 1 << 31
    gen = torch.Generator(device=dev).manual_seed(35)

    def uniform(shape, lo, hi):
        return torch.empty(shape, device=dev).uniform_(lo, hi, generator=gen)

    stack = uniform((6, w, w), -1.0, 1.0)
    assert stack.numel() > big
    hb, r0 = 64, w - 64
    u, v = uniform((hb, w), -40.0, 40.0), uniform((hb, w), -40.0, 40.0)
    args = (stack, u, v, 0, r0, w)
    for a, b in zip(warp.warp_band(*args), warp.warp_band_plain(*args)):
        assert torch.equal(a, b)
    del stack, args

    hb, row0, true_h = 33008, 100, 33208
    cf = torch.cat([uniform((2, hb, w), 1.0, 2.0), uniform((1, hb, w), -0.5, 0.5)])
    assert cf.numel() > big
    x, r, p = (uniform((2, hb, w), -10.0, 10.0) for _ in range(3))
    gr, gp, gd = uniform((2, 2, w), -10.0, 10.0), uniform((2, 2, w), -10.0, 10.0), \
        uniform((2, 2, w), 1.0, 2.0)
    ab = torch.tensor([0.37, 0.81], device=dev)
    got = pcg.pcg_pass_a_band(x, r, p, cf, ab, gr, gp, gd, row0, true_h)
    n = 16                                   # the last rows: two whole blocks of partials
    a = hb - n

    def ghost(t, g):
        return torch.stack([t[:, a - 1], g[:, 1]], dim=1).contiguous()

    want = pcg.pcg_pass_a_band_plain(*(t[:, a:].contiguous() for t in (x, r, p, cf)), ab,
                                     ghost(r, gr), ghost(p, gp), ghost(cf[0:2], gd),
                                     row0 + a, true_h)
    assert all(torch.equal(g[:, a:], q) for g, q in zip(got[:3], want[:3]))
    nbx = -(-w // 32)
    assert torch.equal(got[3][-2 * nbx:], want[3])


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


@pytest.mark.parametrize("solver,early_tol,most", [("pcg", 1e-1, 3 * 9 * 30),
                                                   ("sor", 10.0, 3 * 9 * 4)])
@pytest.mark.parametrize("hw", [(512, 512), (500, 372)])
def test_program_replay_equals_the_eager_route(dev, hw, solver, early_tol, most):
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow import variational as fv

    h, w = hw
    key = "pcg_iterations" if solver == "pcg" else "sor_passes"
    im1, im2 = (torch.from_numpy(a[None]).to(dev) for a in bench_pair(h, w))
    z = torch.zeros((h, w), device=dev)
    rng = np.random.default_rng(1)
    u1 = torch.from_numpy(rng.uniform(-1, 3, (h, w)).astype(np.float32)).to(dev)
    v1 = torch.from_numpy(rng.uniform(-2, 2, (h, w)).astype(np.float32)).to(dev)
    try:
        for tol in (OFConfig().cg_tol, early_tol):
            cfg = OFConfig(kiters=3, solver=solver, cg_tol=tol)
            prog = fv.flow_program(cfg, (h, w), 1, dev)
            for args in ((im1, im2, z, z), (im2, im1, u1, v1)):
                ops.reset_counters()
                eu, ev = fv._coarse_to_fine(*args, cfg)
                e = ops.counters()
                while prog.graph is None:           # the eager call, then the capture
                    wu, wv = prog(*args)
                    assert torch.equal(wu, eu) and torch.equal(wv, ev)
                ops.reset_counters()
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    gu, gv = prog(*args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                c = ops.counters()
                assert torch.equal(gu, eu) and torch.equal(gv, ev)
                assert c[key] == e[key] and c[f"{solver}_host_syncs"] == 0
                # a replay's launches, from its device count, are the eager route's
                assert all(c[name][0] == e[name][0] for name in ops.WRAPPERS)
                if tol == early_tol:
                    assert e[key] < most
    finally:
        fv.clear_program_cache()


@pytest.mark.parametrize("solver", ["sor", "pcg"])
@pytest.mark.parametrize("reach", ["in", "beyond"])
def test_banded_program_replay_equals_the_eager_route(dev, solver, reach):
    """The banded program on a (1, 4) mesh of cuda:0 (``-mesh`` on one card):
    its first call runs the banded solve eagerly, its second captures; the
    replay is torch.equal to the eager and plain banded routes, with the
    same device count, the same launches, and no host read (sync-debug
    "error").  ``beyond``: a 12-px first guess with halo_warp 4 (reach 2;
    the guess is 3 px at the coarsest level) and a hint weight that holds v
    near it runs the reach test's wide body at every level."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow import variational as fv
    from octane_tpu_torch.parallel import LocalExchange, make_mesh, sharded

    h = w = 256
    key = "pcg_iterations" if solver == "pcg" else "sor_passes"
    im1, im2 = (torch.from_numpy(a[None]).to(dev) for a in bench_pair(h, w))
    z = torch.zeros((h, w), device=dev)
    v0 = torch.full((h, w), 12.0, device=dev) if reach == "beyond" else z
    cfg = OFConfig(kiters=3, solver=solver, halo_warp=4 if reach == "beyond" else 8,
                   lambdac=5.0 if reach == "beyond" else OFConfig().lambdac)
    mesh = make_mesh((1, 4), [dev] * 4)
    args = (im1, im2, z, v0)
    try:
        prog = sharded.sharded_flow_program(cfg, (h, w), 1, mesh)
        assert sharded.last_program_info["route"] == "graph"
        ops.reset_counters()
        eu, ev = sharded._coarse_to_fine_banded(*args, cfg, mesh, LocalExchange())
        e = ops.counters()
        pu, pv = sharded._coarse_to_fine_banded(*args, cfg, mesh, LocalExchange(), plain=True)
        assert torch.equal(eu, pu) and torch.equal(ev, pv)
        while prog.graph is None:               # the eager call, then the capture
            wu, wv = prog(*args)
            assert torch.equal(wu, eu) and torch.equal(wv, ev)
        ops.reset_counters()
        sharded.guard_reads.reads = 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gu, gv = prog(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        c = ops.counters()
        assert torch.equal(gu, eu) and torch.equal(gv, ev)
        assert c[key] == e[key] and c[f"{solver}_host_syncs"] == 0
        assert sharded.guard_reads.reads == 0
        assert all(c[name][0] == e[name][0] for name in ops.WRAPPERS)
        slabs = 4 * cfg.kiters * cfg.gnc_steps * cfg.liters   # every band's warp per round
        assert (c["warp_band"][0] > slabs) == (reach == "beyond")
    finally:
        fv.clear_program_cache()


@pytest.mark.parametrize("solver", ["sor", "pcg"])
@pytest.mark.parametrize("reach", ["in", "beyond"])
def test_several_card_program_replay_equals_the_eager_route(dev, solver, reach):
    """The banded program with band i on cuda:i (``-mesh`` over every card,
    one capture begun on cuda:0): at 1024^2 its first call runs the banded
    solve eagerly and equals the eager and plain banded routes, its second
    captures; the replay is torch.equal to them with the same device count,
    the same launches and no host read (sync-debug "error").  ``beyond``:
    the reach test's wide body runs at every level, on every card."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow import variational as fv
    from octane_tpu_torch.parallel import LocalExchange, make_mesh, sharded

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 CUDA devices")
    h = w = 1024
    key = "pcg_iterations" if solver == "pcg" else "sor_passes"
    im1, im2 = (torch.from_numpy(a[None]).to(dev) for a in bench_pair(h, w))
    z = torch.zeros((h, w), device=dev)
    v0 = torch.full((h, w), 20.0, device=dev) if reach == "beyond" else z
    cfg = OFConfig(kiters=4, solver=solver, halo_warp=4 if reach == "beyond" else 8,
                   lambdac=5.0 if reach == "beyond" else OFConfig().lambdac)
    cards = [torch.device("cuda", i) for i in range(n)]
    mesh = make_mesh((1, n), cards)
    args = (im1, im2, z, v0)
    try:
        prog = sharded.sharded_flow_program(cfg, (h, w), 1, mesh)
        assert sharded.last_program_info["route"] == "graph" and list(prog.devices) == cards
        ops.reset_counters()
        eu, ev = sharded._coarse_to_fine_banded(*args, cfg, mesh, LocalExchange())
        e = ops.counters()
        pu, pv = sharded._coarse_to_fine_banded(*args, cfg, mesh, LocalExchange(), plain=True)
        assert torch.equal(eu, pu) and torch.equal(ev, pv)
        while prog.graph is None:               # the eager call, then the capture
            wu, wv = prog(*args)
            assert torch.equal(wu, eu) and torch.equal(wv, ev)
        ops.reset_counters()
        sharded.guard_reads.reads = 0
        for c in cards:
            torch.cuda.synchronize(c)
        torch.cuda.set_sync_debug_mode("error")
        try:
            gu, gv = prog(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        c = ops.counters()
        assert torch.equal(gu, eu) and torch.equal(gv, ev)
        assert c[key] == e[key] and c[f"{solver}_host_syncs"] == 0
        assert sharded.guard_reads.reads == 0
        assert all(c[name][0] == e[name][0] for name in ops.WRAPPERS)
        slabs = n * cfg.kiters * cfg.gnc_steps * cfg.liters   # every band's warp per round
        assert (c["warp_band"][0] > slabs) == (reach == "beyond")
    finally:
        fv.clear_program_cache()


def test_several_card_traced_program_stamps_every_card(dev):
    """The tracer on a banded program with band i on cuda:i: each card's
    replayed stamps lie in order; read back after a replay with no sync of
    the other cards, each card's solve, levels, PCG rounds and exchanges
    (one a level, for the whole level's sample stack, and one a round) are
    spans of that card of no negative length, and the solve spans the
    rounds.  The untraced program launches the same kernels and no stamp;
    ``wide_warp_rounds`` counts the rounds whose wide body ran."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow import variational as fv
    from octane_tpu_torch.parallel import make_mesh, sharded
    from octane_tpu_torch.utils import profiling

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 CUDA devices")
    h = w = 512
    im1, im2 = (torch.from_numpy(a[None]).to(dev) for a in bench_pair(h, w))
    z = torch.zeros((h, w), device=dev)
    v0 = torch.full((h, w), 20.0, device=dev)
    cfg = OFConfig(kiters=3, solver="pcg", halo_warp=4, lambdac=5.0)
    rounds = cfg.kiters * cfg.gnc_steps * cfg.liters
    cards = [torch.device("cuda", i) for i in range(n)]
    mesh = make_mesh((1, n), cards)
    launches = {}
    try:
        for on in (False, True):
            if on:
                profiling.enable()
            prog = sharded.sharded_flow_program(cfg, (h, w), 1, mesh)
            while prog.graph is None:
                prog(im1, im2, z, v0)
            for c in cards:
                torch.cuda.synchronize(c)
            ops.reset_counters()
            profiling.reset()
            prog(im1, im2, z, v0)
            c = ops.counters()
            launches[on] = {name: c[name][0] for name in ops.WRAPPERS}
            # each band warps once a round, and again in a round whose wide body ran
            assert 0 < c["wide_warp_rounds"] == c["warp_band"][0] / n - rounds
            if on:
                spans = profiling.records()[None]
                for card in range(n):
                    mine = [s for s in spans if s.card == card]
                    names = [s.name for s in mine]
                    assert names.count("octane.solve") == 1 and names.count("octane.level") == 3
                    assert names.count("octane.pcg") == rounds
                    assert names.count("octane.exchange") == cfg.kiters + rounds
                    assert all(s.device_end >= s.device_start for s in mine)
                    solve = next(s for s in mine if s.name == "octane.solve")
                    assert all(solve.device_start <= s.device_start <= s.device_end
                               <= solve.device_end for s in mine)
                    stamps = prog.marks[cards[card]].stamps.tolist()
                    used = stamps[:len(prog.marks[cards[card]].slots)]
                    assert used == sorted(used)
            profiling.disable()
            fv.clear_program_cache()
    finally:
        profiling.disable()
        profiling.reset()
        fv.clear_program_cache()
    assert launches[False]["stamp"] == 0
    assert launches[True]["stamp"] == n * (2 + cfg.kiters + 2 * (cfg.kiters + 2 * rounds))
    assert ({k: v for k, v in launches[False].items() if k != "stamp"}
            == {k: v for k, v in launches[True].items() if k != "stamp"})


@pytest.mark.parametrize("solver", ["sor", "pcg"])
def test_nccl_program_replay_equals_the_eager_route(dev, tmp_path, solver):
    """Two processes over NCCL, one card each (``-nprocs 2``): each
    process's program captures on its second call; the replay (0 host
    reads under sync-debug "error") is torch.equal to the first call, to
    the program's eager route with the same launches and count, and to the
    single-process banded flow's rows."""
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.io.readers import scene_from_goes_arrays
    from octane_tpu_torch.parallel import make_mesh, sharded_variational_flow
    from torch_dist_worker import card_program, spawn
    from torch_fixtures import FIXTURE_T0, fixture_counts, goes_arrays

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    out = str(tmp_path / "prog")
    spawn(card_program, [(r, f"file://{tmp_path / 'store'}", out, solver) for r in range(2)],
          300)
    cfg = OFConfig(kiters=3, solver=solver)
    s1, s2 = (scene_from_goes_arrays(*goes_arrays(fixture_counts(*shift), t)[:4], cfg, dev,
                                     donav=False, t=t)
              for shift, t in (((0, 0), FIXTURE_T0), ((3.0, -1.5), FIXTURE_T0 + 60.0)))
    z = torch.zeros((512, 512), device=dev)
    u, v = sharded_variational_flow(s1.data, s2.data, z, z, cfg, make_mesh((1, 2), [dev] * 2))
    for r in range(2):
        got = np.load(f"{out}.{r}.npz")
        r0, r1 = got["rows"]
        assert str(got["route"]) == "graph"
        for a, b in (("u", "eu"), ("v", "ev"), ("u", "fu"), ("v", "fv")):
            np.testing.assert_array_equal(got[a], got[b])
        np.testing.assert_array_equal(got["u"], u[r0:r1].cpu().numpy())
        np.testing.assert_array_equal(got["v"], v[r0:r1].cpu().numpy())
        replay, eager = got["replay"], got["eager"]
        assert replay[-1] == 0 and (replay[:-1] == eager[:-1]).all() and replay[-2] > 0


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_traced_program_stamps_on_the_host_clock(dev, solver):
    """The tracer (utils.profiling) on the card: a traced program's replay
    writes its stamps in order, and each, on the host clock, lies at or
    after the host time its launch was enqueued, less 20 us, as do an eager
    span's; the round counts sum to the pair's count.  The untraced
    program's replay launches the same kernels and no stamp."""
    import time

    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow import variational as fv
    from octane_tpu_torch.utils import profiling

    h, w = 256, 256
    im1, im2 = (torch.from_numpy(a[None]).to(dev) for a in bench_pair(h, w))
    z = torch.zeros((h, w), device=dev)
    cfg = OFConfig(kiters=3, solver=solver)
    key = "pcg_iterations" if solver == "pcg" else "sor_passes"
    rounds = cfg.kiters * cfg.gnc_steps * cfg.liters
    launches, flows = {}, {}
    try:
        for on in (False, True):
            if on:
                profiling.enable()
            prog = fv.flow_program(cfg, (h, w), 1, dev)
            while prog.graph is None:       # the warm-up, then the capture
                prog(im1, im2, z, z)
            torch.cuda.synchronize()
            ops.reset_counters()
            profiling.reset()
            t_enq = time.perf_counter_ns()
            with profiling.span("octane.test", dev):
                flows[on] = prog(im1, im2, z, z)
            torch.cuda.synchronize()
            c = ops.counters()
            launches[on] = {name: c[name][0] for name in ops.WRAPPERS}
            if on:
                stamps = prog.marks.stamps.tolist()
                assert len(stamps) == 2 + cfg.kiters + 2 * rounds
                assert stamps == sorted(stamps)
                recs = profiling.records()[None]
                stamped = [s for s in recs if s.device_start is not None]
                assert len(stamped) == 2 + cfg.kiters + rounds      # test, solve, levels, rounds
                assert all(s.device_start >= t_enq - 20_000 for s in stamped)
                test = next(s for s in recs if s.name == "octane.test")
                assert test.device_start >= test.start - 20_000
                assert test.device_end >= max(s.device_end for s in stamped)
                assert len(c[f"{key}_by_round"]) == rounds
                assert sum(c[f"{key}_by_round"]) == c[key]
            profiling.disable()
    finally:
        profiling.disable()
        profiling.reset()
        fv.clear_program_cache()
    assert launches[False]["stamp"] == 0
    assert launches[True]["stamp"] == 2 + cfg.kiters + 2 * rounds + 2
    assert ({n: k for n, k in launches[False].items() if n != "stamp"}
            == {n: k for n, k in launches[True].items() if n != "stamp"})
    assert all(torch.equal(a, b) for a, b in zip(flows[False], flows[True]))


def _fixture_scenes(cfg, dev, shift):
    """The 512^2 GOES fixture pair moved by ``shift`` px over 60 s, on ``dev``."""
    from octane_tpu_torch.io.readers import scene_from_goes_arrays
    from torch_fixtures import FIXTURE_T0, fixture_counts, goes_arrays

    return [scene_from_goes_arrays(*goes_arrays(fixture_counts(*sh), t)[:4], cfg, dev,
                                   donav=nav, t=t)
            for sh, t, nav in (((0, 0), FIXTURE_T0, True), (shift, FIXTURE_T0 + 60.0, False))]


def test_products_go_to_page_locked_host_memory(dev):
    """compute_flow on one card delivers its product planes as page-locked
    host tensors, bit-equal to pix2uv (and the CTP) run on the card and then
    copied to the host; the flow stays on the card; ops.counters() counts
    each pair's planes and their bytes; a second pair leaves the first
    pair's planes as they were (no shared storage)."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.nav.winds import pix2uv

    names = ("u_wind", "v_wind", "u_raw", "v_raw")
    cfg = OFConfig(kiters=3)
    ops.reset_counters()
    s1, s2 = _fixture_scenes(cfg, dev, (3.0, -1.5))
    compute_flow(s1, s2, cfg)
    c = ops.counters()
    planes = [getattr(s1, n) for n in names]
    assert all(p.device.type == "cpu" and p.is_pinned() and p.dtype == torch.int16
               for p in planes)
    assert s1.u_pix.is_cuda and s1.v_pix.is_cuda
    for p, want in zip(planes, pix2uv(s1.u_pix, s1.v_pix, s1.nav, s2.t - s1.t)):
        assert torch.equal(p, want.cpu())
    assert int(s1.u_raw.abs().max()) > 100 and int(s1.u_wind.abs().max()) > 100
    assert c["host_planes"] == 4 and c["host_plane_bytes"] == 4 * 512 * 512 * 2
    kept = [p.clone() for p in planes]
    # a second pair, with a cloud-top height: five planes, the CTP among them
    cfg = OFConfig(kiters=3, do_cth=True)
    ops.reset_counters()
    t1, t2 = _fixture_scenes(cfg, dev, (-2.0, 1.0))
    t1.cth = torch.from_numpy(cth_steps(512, 512)).to(dev)
    compute_flow(t1, t2, cfg)
    c = ops.counters()
    assert c["host_planes"] == 5 and c["host_plane_bytes"] == 5 * 512 * 512 * 2
    assert t1.ctp.is_pinned() and torch.equal(t1.ctp, t1.cth.to(torch.int16).cpu())
    assert all(torch.equal(p, k) for p, k in zip(planes, kept))
    assert not torch.equal(t1.u_raw, s1.u_raw)
    ptrs = {p.data_ptr() for p in planes}
    assert not ptrs & {getattr(t1, n).data_ptr() for n in names + ("ctp",)}


def test_mesh_products_go_to_host_from_every_card(dev):
    """compute_flow on a (4, 1) mesh with band i on cuda:i: its product
    planes are page-locked host tensors, each band's rows copied from its
    own card, and none is left on a card; they equal pix2uv of the mesh's
    flow on one card bit for bit, and so do sharded_pix2uv_ms's float64
    winds; each card that copied stamps its octane.flow.to_host span."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow import variational as fv
    from octane_tpu_torch.flow.dispatcher import active_mesh, compute_flow
    from octane_tpu_torch.nav.winds import pix2uv, pix2uv_ms
    from octane_tpu_torch.parallel import sharded_pix2uv_ms
    from octane_tpu_torch.utils import profiling

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    names = ("u_wind", "v_wind", "u_raw", "v_raw")
    cfg = OFConfig(kiters=3, mesh_shape=(4, 1))
    s1, s2 = _fixture_scenes(cfg, dev, (3.0, -1.5))
    ops.reset_counters()
    profiling.reset()
    profiling.enable()
    try:
        compute_flow(s1, s2, cfg)
        spans = [s for s in profiling.records()[None] if s.name == "octane.flow.to_host"]
    finally:
        profiling.disable()
        profiling.reset()
        fv.clear_program_cache()
    c = ops.counters()
    assert sorted(s.card for s in spans) == [0, 1, 2, 3]
    assert all(s.device_start <= s.device_end for s in spans)
    assert c["host_planes"] == 4 and c["host_plane_bytes"] == 4 * 512 * 512 * 2
    dt = s2.t - s1.t
    for name, want in zip(names, pix2uv(s1.u_pix, s1.v_pix, s1.nav, dt)):
        plane = getattr(s1, name)
        assert plane.device.type == "cpu" and plane.is_pinned(), name
        assert torch.equal(plane, want.cpu()), name
    assert int(s1.u_raw.abs().max()) > 100
    ums, vms = sharded_pix2uv_ms(s1.u_pix, s1.v_pix, s1.nav, dt, active_mesh(cfg, dev))
    for got, want in zip((ums, vms), pix2uv_ms(s1.u_pix, s1.v_pix, s1.nav, dt)):
        assert got.is_pinned() and got.dtype == torch.float64 and torch.equal(got, want.cpu())
