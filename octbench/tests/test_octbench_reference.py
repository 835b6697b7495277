"""The plain reference against the port on the CPU, at 64 x 64 with the
configuration's settings, and its control: the same reference in the
precision below the configuration's, which the limits must refuse; and
the reference in blocks of rows against the same in one block (the
whole image)."""

import numpy as np
import pytest
import torch

from octbench import grid, reference, spec, traffic
from octbench.tests.tiny import LIMITS


def _f32(x):
    return float(np.float32(x))


def _pairs(solver, n=64):
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.io.datamodel import NavConstants
    from octane_tpu_torch.io.readers import scene_from_goes_arrays, set_goes_grid

    cfg = spec.load_json(f"{spec.HERE}/configs/goes-meso-b13.json")
    cfg["rows"] = cfg["cols"] = n
    tr = spec.traffic("meso-loop")
    tr.update(sequences=1, frames=3)
    st = traffic.make_stream(cfg, tr, 2 ** 32 + 5, "cpu")
    nav = grid.nav_constants(cfg)
    x, y = grid.scan_counts(cfg)
    ocfg = OFConfig(solver=solver, **cfg["settings"])
    fg = None
    for i in range(2):
        s1, s2 = (scene_from_goes_arrays(st.frames[0][j], x, y,
                                         set_goes_grid(NavConstants(**nav), n, n, 13), ocfg,
                                         "cpu", donav=j == i, t=st.times[0][j], band=13)
                  for j in (i, i + 1))
        compute_flow(s1, s2, ocfg, first_guess=fg)
        fg = (s1.u_pix, s1.v_pix)
        yield cfg, nav, st.frames[0][i], st.frames[0][i + 1], s1, s2


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_reference_follows_the_port_and_the_control_does_not(solver):
    ref_fg = ctl_fg = None
    for cfg, nav, c1, c2, s1, s2 in _pairs(solver):
        lo, hi = cfg["norm_min"], cfg["norm_max"]
        d1, d2 = (reference.normalised(c, nav, lo, hi, "cpu") for c in (c1, c2))
        assert torch.equal(d1, s1.data[0]) and torch.equal(d2, s2.data[0])
        z = torch.zeros_like(d1)
        u0, v0 = ref_fg or (z, z)
        u, v, _ = reference.solve(d1[None], d2[None], u0, v0, cfg["settings"], solver,
                                  acc=reference.REFERENCE.accumulate)
        ref_fg = (u, v)
        assert float((u - s1.u_pix).abs().max()) < LIMITS["flow_gap_px"] / 10
        assert float((v - s1.v_pix).abs().max()) < LIMITS["flow_gap_px"] / 10
        for got, want in zip((s1.u_wind, s1.v_wind, s1.u_raw, s1.v_raw),
                             reference.winds(u, v, nav, 60.0)):
            assert int((got.int() - want.int()).abs().max()) <= 1
        # the control: navigation in float32, the solve in bfloat16
        e1, e2 = (reference.normalised(c, nav, lo, hi, "cpu", reference.CONTROL) for c in (c1, c2))
        assert float((e1 != d1).float().mean()) > LIMITS["ingest_mismatch"]
        cu0, cv0 = ctl_fg or (z, z)
        cu, cv, _ = reference.solve(e1[None], e2[None], cu0, cv0, cfg["settings"], solver,
                                    torch.bfloat16)
        ctl_fg = (cu, cv)
        assert float((cu - u).abs().max()) > LIMITS["flow_gap_px"]


def test_winds_zero_beyond_the_limb():
    cfg = spec.load_json(f"{spec.HERE}/configs/goes-fd-b13.json")
    cfg.update(rows=85, cols=85, x_scale=cfg["x_scale"] * 64, y_scale=cfg["y_scale"] * 64)
    nav = grid.nav_constants(cfg)
    u = torch.full((85, 85), 0.1)
    U, V, Ur, Vr = reference.winds(u, torch.zeros_like(u), nav, 600.0)
    x, y = grid.scan_angles(cfg, "cpu", torch.float64)
    limb = (x * x + y * y > 0.021).numpy()
    assert np.all(U.numpy()[limb] == 0) and np.all(U.numpy()[~limb] > 0)
    assert np.all(Ur.numpy() == 10)


def _scene(n):
    cfg = spec.load_json(f"{spec.HERE}/configs/goes-meso-b13.json")
    cfg["rows"] = cfg["cols"] = n
    tr = spec.traffic("meso-loop")
    tr.update(sequences=1, frames=2)
    st = traffic.make_stream(cfg, tr, 2 ** 32 + 77 + n, "cpu")
    return cfg, grid.nav_constants(cfg), st.frames[0]


def _level(n, block_rows):
    """The finest level's stack, gradients and a first guess, made in blocks."""
    cfg, nav, (c1, c2) = _scene(n)
    lo, hi = cfg["norm_min"], cfg["norm_max"]
    d1, d2 = (reference.normalised(c, nav, lo, hi, "cpu", block_rows=block_rows)
              for c in (c1, c2))
    gx1, gy1 = reference.gradients(d1[None], block_rows)
    gx2, gy2 = reference.gradients(d2[None], block_rows)
    gxx, _ = reference.gradients(gx2, block_rows)
    gxy, gyy = reference.gradients(gy2, block_rows)
    stack = torch.cat([d2[None], gx2, gy2, gxx, gxy, gyy])
    gen = torch.Generator().manual_seed(n)
    u = 3.0 * torch.rand((n, n), generator=gen) - 1.5
    v = 3.0 * torch.rand((n, n), generator=gen) - 1.5
    low = reference.downsample(torch.stack([d1, u]), 0.5, block_rows)
    return cfg, nav, d1, d2, stack, gx1, gy1, u, v, low


@pytest.mark.parametrize("n", [64, 96])
@pytest.mark.parametrize("al1", [1.0, 0.5])
def test_blocked_stages_are_the_whole_images(n, al1):
    # each stage's blocks, with the neighbour rows its stencil reads, give
    # the bits of the whole image (one block)
    whole = _level(n, None)
    blocked = _level(n, 7)
    for a, b in zip(whole[2:], blocked[2:]):
        assert torch.equal(a, b)
    cfg, nav, d1, d2, stack, gx1, gy1, u, v, _ = whole
    s = cfg["settings"]
    args = (stack, d1[None], gx1, gy1, u, v, 0.5 * u, 0.5 * v, al1, _f32(s["alpha"]),
            _f32(s["lambda_"] / s["alpha"]), 0.0, s["dozim"])
    samples, bc_x, bc_y = reference.warp(stack, u, v)
    want = reference.assemble(samples, bc_x, bc_y, *args[1:])
    got = reference.system(*args, block_rows=7)
    flat = lambda m: [m[0], m[1], m[2], m[4], m[5]] + (m[3] or [])      # noqa: E731
    assert (want[3] is None) == (al1 == 1.0) and (got[3] is None) == (al1 == 1.0)
    for a, b in zip(flat(want), flat(got)):
        assert torch.equal(a, b)
    x = torch.stack([u, v])
    ax = torch.cat([reference.apply_a(reference._rows(got, r0, r1),
                                      x[:, max(r0 - 1, 0):r1 + 1], r0 - max(r0 - 1, 0))
                    for r0, r1 in reference.row_blocks(n, n, 5)], dim=1)
    assert torch.equal(ax, reference.apply_a(want, x))
    for a, b in zip(reference.winds(u, v, nav, 60.0), reference.winds(u, v, nav, 60.0,
                                                                        block_rows=3)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [64, 96])
@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_blocked_solve_is_the_whole_images(n, solver):
    # every round of the solve, quadratic and robust; only the dot
    # products' float64 sums are added in another order
    cfg, nav, (c1, c2) = _scene(n)
    d1, d2 = (reference.normalised(c, nav, cfg["norm_min"], cfg["norm_max"], "cpu")
              for c in (c1, c2))
    z = torch.zeros_like(d1)
    runs = [reference.solve(d1[None], d2[None], z + 0.25, z - 0.5, cfg["settings"], solver,
                            acc=torch.float64, block_rows=b) for b in (None, 9)]
    (u, v, n_whole), (ub, vb, n_blocked) = runs
    assert n_whole == n_blocked and n_whole > 0
    assert float((u - ub).abs().max()) <= 1e-6 and float((v - vb).abs().max()) <= 1e-6
    assert float(u.abs().max()) > 0.5           # the solve moved: not a trivial equality


def test_row_blocks_cover_every_row_once():
    assert reference.row_blocks(10, 4, 3) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert reference.row_blocks(5424, 5424) == [(0, 5424)]          # a full disk: one block
    blocks = reference.row_blocks(21696, 21696)
    assert blocks[0][0] == 0 and blocks[-1][1] == 21696 and len(blocks) == 15
    assert all(b[1] == c[0] for b, c in zip(blocks, blocks[1:]))


def _images(n):
    cfg, nav, (c1, c2) = _scene(n)
    return [reference.normalised(c, nav, cfg["norm_min"], cfg["norm_max"], "cpu")
            for c in (c1, c2)]


RAD, SRAD = 2, 2
EDGE = RAD + SRAD + 1           # the rows and columns whose reads reach past the image


def _inner(a):
    return a[EDGE:-EDGE, EDGE:-EDGE]


def _grid(n):
    return torch.meshgrid(torch.arange(n, dtype=torch.float32),
                          torch.arange(n, dtype=torch.float32), indexing="ij")


@pytest.mark.parametrize("dx,dy", [(2, -1), (-1, 0), (0, 2)])
def test_patch_match_recovers_integer_shifts(dx, dy):
    # g2[y, x] = g1[y - dy, x - dx]: on seeded noise the true offset alone
    # costs 0, so it wins at every pixel whose reads stay in the image; on an
    # integer ramp (3 x + 7 y: no other offset in reach costs 0) both probes
    # of each axis cost the same, so the fit leaves the flow on the shift
    n = 40
    noise = torch.rand((n + 8, n + 8), generator=torch.Generator().manual_seed(n))
    g1, g2 = noise[4:4 + n, 4:4 + n], noise[4 - dy:4 - dy + n, 4 - dx:4 - dx + n]
    rows, cols = torch.arange(n)[:, None], torch.arange(n)[None, :]
    wn, wm, _ = reference._search(g1, g2, rows, cols, RAD, SRAD)
    assert torch.all(_inner(wn) == dx) and torch.all(_inner(wm) == dy)
    u, v = reference.patch_match(g1, g2, RAD, SRAD)
    assert torch.equal(u.round(), wn.float()) and torch.equal(v.round(), wm.float())
    y, x = _grid(n)
    u, v = reference.patch_match(3 * x + 7 * y, 3 * (x - dx) + 7 * (y - dy), RAD, SRAD)
    assert torch.all(_inner(u) == dx) and torch.all(_inner(v) == dy)


@pytest.mark.parametrize("sx,sy", [(0.25, 0.0), (-1.3, 0.0), (0.0, 0.4), (0.0, -1.75)])
def test_patch_match_finds_a_subpixel_shift(sx, sy):
    # a texture of 40 seeded plane waves (0.4 to 0.8 rad/px) moved by a
    # known shift along one axis: the fit along that axis lands within
    # 0.05 px of it at the median of the inner pixels (0.020 to 0.031
    # measured), a fifth of the whole-pixel winner's error or less
    n = 64
    gen = torch.Generator().manual_seed(11)
    k = 0.4 + 0.4 * torch.rand(40, generator=gen, dtype=torch.float64)
    th = 2 * np.pi * torch.rand(40, generator=gen, dtype=torch.float64)
    ph = 2 * np.pi * torch.rand(40, generator=gen, dtype=torch.float64)
    y, x = (a.double() for a in _grid(n))

    def texture(x, y):
        return (20 * sum(torch.sin(a * (torch.cos(t) * x + torch.sin(t) * y) + p)
                         for a, t, p in zip(k, th, ph))).float()
    u, v = reference.patch_match(texture(x, y), texture(x - sx, y - sy), RAD, SRAD)
    got, want = (u, sx) if sx % 1 else (v, sy)
    err = float((_inner(got) - want).abs().median())
    assert err <= 0.05 and err <= abs(want - round(want)) / 5


@pytest.mark.parametrize("n", [64, 96])
def test_patch_match_is_the_ports(n):
    # the fit moves a pixel less than half a pixel from its winner, so the
    # rounded flows are the winners; no pixel has two offsets of equal least
    # cost (0 exact ties at 64 and 96), so no winner rests on the visit order
    from octane_tpu_torch.flow.patch_match import patch_match_flow

    d1, d2 = _images(n)
    u, v = reference.patch_match(d1, d2, RAD, SRAD)
    pu, pv = patch_match_flow(d1, d2, None, None, RAD, SRAD, device="cpu")
    assert torch.equal(u.round(), pu.round()) and torch.equal(v.round(), pv.round())
    assert float((u - pu).abs().max()) <= 1e-5 and float((v - pv).abs().max()) <= 1e-5
    assert float(u.abs().max()) >= 1.0 and float(v.abs().max()) >= 1.0
    rows, cols = torch.arange(n)[:, None], torch.arange(n)[None, :]
    costs = torch.stack([reference._jsose(d1, d2, rows, cols, a, b, RAD)
                         for a, b in reference.spiral(SRAD)])
    assert int(((costs == costs.min(0).values).sum(0) > 1).sum()) == 0


def test_patch_match_blocked_is_one_block():
    d1, d2 = _images(64)
    for a, b in zip(reference.patch_match(d1, d2, RAD, SRAD),
                    reference.patch_match(d1, d2, RAD, SRAD, block_rows=7)):
        assert torch.equal(a, b)


def test_patch_match_control_picks_other_winners():
    # the costs summed in bfloat16 (0.9 % of the pixels' winners move at 64)
    d1, d2 = _images(64)
    u, v = reference.patch_match(d1, d2, RAD, SRAD)
    cu, cv = reference.patch_match(d1, d2, RAD, SRAD, reference.CONTROL)
    moved = (cu.round() != u.round()) | (cv.round() != v.round())
    assert float(moved.float().mean()) > 1e-3
