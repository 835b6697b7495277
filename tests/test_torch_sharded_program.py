"""The banded program of octane_tpu_torch (parallel.sharded.sharded_flow_program)
and its guarded banded drivers, on the CPU.

On the CPU the guards read on the host, but the banded drivers
(parallel.sor.solve_bands, parallel.cg.solve_bands) walk every guarded body
without breaking, with their state in buffers fixed before the loop, as in
the captured graph, so a stale-buffer fault shows here too.

* Each driver against a copy of the loop it replaced (kept below as a
  reference, not a route of the package), at tolerances that stop it at
  the start, early, mid-solve and never (tests/test_torch_program.py's
  stops), quad and robust, on 4 even bands of 64^2 and on the uneven 3
  bands of a 37 x 53 system (16, 16 and 5 rows): iterates ``torch.equal``,
  the device counts and the host reads equal.
* ``sharded_flow_program`` on a (2, 4) CPU mesh against octane_tpu's
  ``sharded_variational_flow`` on the same numpy inputs, both relaxers,
  within 1e-3 px (tests/test_torch_mesh_flow.py's budget), and
  ``last_program_info``'s ``warp_levels`` and ``kiters`` against JAX's at
  64^2, where JAX runs its halo warp at every level.  Deliberate
  differences: the port's bands are 8-row aligned and may be uneven, and
  it pads nothing (JAX pads to a mesh-divisible shape); its
  ``cg_levels`` are every level, since every level solves on the bands.
* The reach test's wide body: a 12-px first guess with ``halo_warp`` 4
  runs it in every round of every level, and the flow equals, bit for bit,
  the flow with a halo so wide that the body never runs, and the
  single-device flow within the budget.
* The program's key (octane_tpu's keyed fields but its TPU option), its
  route (a graph only where every band lies on one card), and its refusals.
* ``ops.guard.when``: no latch, one host read per call;
  ``ops.record_pair`` with two kinds of guarded body.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from octane_tpu.config import OFConfig as JaxOFConfig
from octane_tpu.parallel.mesh import make_mesh as jax_make_mesh
from octane_tpu.parallel import sharded as jax_sharded

from octane_tpu_torch import ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow import program as fp
from octane_tpu_torch.flow import variational as fv
from octane_tpu_torch.ops import pcg as pcgmod
from octane_tpu_torch.ops import sor as sormod
from octane_tpu_torch.ops.guard import Guard, when
from octane_tpu_torch.ops.pcg import initial_partials, stack_system
from octane_tpu_torch.parallel import cg as band_cg
from octane_tpu_torch.parallel import make_mesh
from octane_tpu_torch.parallel import sharded
from octane_tpu_torch.parallel import sor as band_sor
from octane_tpu_torch.parallel.halo import LocalExchange

from test_torch_pcg import _system_np, _torch_sys
from test_torch_program import _stop_tol

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ITERS = 30
SPLITS = {"even": ((64, 64), 4), "uneven": ((37, 53), 3)}   # (h, w), bands


def _mesh(ry, rx, device=CPU):
    return make_mesh((ry, rx), [device] * (ry * rx))


# ----------------------------------------------------------------------------
# the drivers against the loops they replaced
# ----------------------------------------------------------------------------

def sor_bands_before(bands, true_h, resid0, tol, iters, omega=sormod.OMEGA):
    """parallel.sor.solve_bands as it was before its state moved into fixed
    slabs: a for ... else loop over passes that swaps each band's two slabs'
    Python references and breaks on a host read.  Returns (the bands' rows,
    passes, host reads, the residual before each pass)."""
    exchange = LocalExchange()
    s_main = min(sormod.PASS_SWEEPS, iters)
    n_main, s_rem = divmod(iters, s_main)
    ghost = 2 * s_main
    tol32 = float(np.float32(tol))
    w = bands[0][1].shape[2]
    slabs, reqs = [], []
    for i, (r0, cf) in enumerate(bands):
        r1 = r0 + cf.shape[-2]
        t0, t1 = max(0, r0 - ghost), min(true_h, r1 + ghost)
        cfs = torch.empty((cf.shape[0], t1 - t0, w))
        slabs.append((r0, r1, t0, t1, cfs, [torch.zeros((2, t1 - t0, w)),
                                            torch.empty((2, t1 - t0, w))]))
        reqs.append((i, t0, t1, cfs))
    exchange.fetch_bands(bands, reqs)
    n = reads = 0
    history = [float(resid0)]

    def run(ns):
        cur, reqs = [], []
        for i, (r0, r1, t0, t1, _, xs) in enumerate(slabs):
            cur.append((r0, xs[0][:, r0 - t0:r1 - t0]))
            reqs += [(i, t0, r0, xs[0][:, :r0 - t0]), (i, r1, t1, xs[0][:, r1 - t0:])]
        exchange.fetch_bands(cur, reqs)
        parts = []
        for r0, r1, t0, _, cfs, xs in slabs:
            _, part = sormod.sor_pass_band_plain(xs[0], cfs, ns, omega, t0, true_h, r0 - t0,
                                                 r1 - t0, out=xs[1][:, r0 - t0:r1 - t0])
            parts.append(part)
            xs.reverse()
        return torch.sum(torch.cat(parts))

    resid = resid0
    for _ in range(n_main):
        reads += 1
        if not float(resid) > tol32:
            break
        resid = run(s_main)
        n += 1
        history.append(float(resid))
    else:
        if s_rem:
            reads += 1
            if float(resid) > tol32:
                run(s_rem)
                n += 1
    return [xs[0][:, r0 - t0:r1 - t0] for r0, r1, t0, _, _, xs in slabs], n, reads, history


def pcg_bands_before(bands, true_h, tol, iters):
    """parallel.cg.solve_bands as it was: new x, p, r and ab every
    iteration, a host read of the stopping test.  Returns (the bands' rows,
    iterations, host reads, the residual before each iteration and after
    the last)."""
    exchange = LocalExchange()
    layout = [(r0, cf) for r0, cf, _ in bands]
    cfs = [cf for _, cf, _ in bands]
    w = cfs[0].shape[2]

    def ghosts():
        return [torch.empty((2, 2, w)) for _ in cfs]

    gd, gr, gp = ghosts(), ghosts(), ghosts()
    exchange.fetch_bands([(r0, cf[0:2]) for r0, cf in layout],
                         band_cg._ghost_reqs(layout, gd))
    b = [bb for _, _, bb in bands]
    part = torch.cat([initial_partials(cf, bb) for cf, bb in zip(cfs, b)])
    gamma = torch.sum(part[:, 0]) + torch.sum(part[:, 1])
    resid = torch.sum(part[:, 2])
    x = [torch.zeros_like(bb) for bb in b]
    p = [torch.zeros_like(bb) for bb in b]
    r = list(b)
    alpha = torch.zeros(())
    beta = torch.zeros_like(alpha)
    tol32 = float(np.float32(tol))
    n = reads = 0
    history = [float(resid)]
    for _ in range(iters):
        reads += 1
        if not float(resid) > tol32:
            break
        exchange.fetch_bands([(r0, t) for (r0, _), t in zip(layout, r)],
                             band_cg._ghost_reqs(layout, gr))
        exchange.fetch_bands([(r0, t) for (r0, _), t in zip(layout, p)],
                             band_cg._ghost_reqs(layout, gp))
        ab = torch.stack([alpha, beta])
        paps = []
        for i, (r0, cf) in enumerate(layout):
            x[i], p[i], ap, pap = pcgmod.pcg_pass_a_band_plain(x[i], r[i], p[i], cf, ab, gr[i],
                                                               gp[i], gd[i], r0, true_h)
            paps.append((ap, pap))
        alpha = gamma / torch.sum(torch.cat([pap for _, pap in paps]))
        parts = []
        for i in range(len(layout)):
            r[i], part = pcgmod.pcg_pass_b_plain(r[i], paps[i][0], cfs[i], alpha.reshape(1))
            parts.append(part)
        part = torch.cat(parts)
        gamma_new = torch.sum(part[:, 0])
        resid = torch.sum(part[:, 1])
        beta = gamma_new / gamma
        gamma = gamma_new
        n += 1
        history.append(float(resid))
    return [xi + alpha * pi for xi, pi in zip(x, p)], n, reads, history


def sor_bands_in_bodies(bands, true_h, resid0, tol, iters, count):
    """parallel.sor.solve_bands as it was before its transfers left the
    guarded bodies: one body per pass holds the ghost-row exchange, the
    band passes, the join of the residual partials and their sum; its
    state in slabs fixed before the loop (a copy kept as a reference)."""
    exchange = LocalExchange()
    s_main = min(sormod.PASS_SWEEPS, iters)
    n_main, s_rem = divmod(iters, s_main)
    ghost = 2 * s_main
    w = bands[0][1].shape[2]
    slabs, reqs = [], []
    for i, (r0, cf) in enumerate(bands):
        r1 = r0 + cf.shape[-2]
        t0, t1 = max(0, r0 - ghost), min(true_h, r1 + ghost)
        cfs = torch.empty((cf.shape[0], t1 - t0, w))
        slabs.append((r0, r1, t0, cfs, [torch.zeros((2, t1 - t0, w)),
                                        torch.empty((2, t1 - t0, w))]))
        reqs.append((i, t0, t1, cfs))
    exchange.fetch_bands(bands, reqs)

    def fetch(j):
        cur, reqs = [], []
        for i, (r0, r1, t0, _, xs) in enumerate(slabs):
            cur.append((r0, xs[j][:, r0 - t0:r1 - t0]))
            reqs += [(i, t0, r0, xs[j][:, :r0 - t0]), (i, r1, r1 + ghost,
                                                        xs[j][:, r1 - t0:])]
        return cur, [(i, a, min(b, true_h), o) for i, a, b, o in reqs]

    resid = resid0.clone()
    ran = torch.zeros((), dtype=torch.int32)

    def body(k, ns):
        j = k % 2
        exchange.fetch_bands(*fetch(j))
        parts = []
        for r0, r1, t0, cfs, xs in slabs:
            _, part = sormod.sor_pass_band(xs[j], cfs, ns, sormod.OMEGA, t0, true_h, r0 - t0,
                                           r1 - t0, out=xs[1 - j][:, r0 - t0:r1 - t0])
            parts.append(part)
        torch.sum(torch.cat(parts), 0, out=resid)
        ran.add_(1)

    guard = Guard(sormod.sor_solve_cf, count)
    tol32 = float(np.float32(tol))
    for k in range(n_main):
        guard(resid, tol32, lambda k=k: body(k, s_main))
    if s_rem:
        guard(resid, tol32, lambda: body(n_main, s_rem))
    count.add_(ran)
    odd = bool(ran % 2 == 1)
    return [xs[int(odd)][:, r0 - t0:r1 - t0] for r0, r1, t0, _, xs in slabs]


def pcg_bands_in_bodies(bands, true_h, tol, iters, count):
    """parallel.cg.solve_bands as it was before its transfers left the
    guarded bodies: one body per iteration holds the ghost-row fetches,
    passes A, the <p, Ap> join, alpha, passes B, the rr join and the
    scalars; x, p and r ping-pong (a copy kept as a reference)."""
    exchange = LocalExchange()
    layout = [(r0, cf) for r0, cf, _ in bands]
    cfs = [cf for _, cf, _ in bands]
    w = cfs[0].shape[2]

    def ghosts():
        return [torch.empty((2, 2, w)) for _ in cfs]

    gd, gr, gp = ghosts(), ghosts(), ghosts()
    exchange.fetch_bands([(r0, cf[0:2]) for r0, cf in layout],
                         band_cg._ghost_reqs(layout, gd))
    b = [bb for _, _, bb in bands]
    part = torch.cat([initial_partials(cf, bb) for cf, bb in zip(cfs, b)])
    gammas = [torch.sum(part[:, 0]) + torch.sum(part[:, 1]), torch.empty(())]
    resid = torch.sum(part[:, 2])
    xs = [[torch.zeros_like(bb), torch.empty_like(bb)] for bb in b]
    ps = [[torch.zeros_like(bb), torch.empty_like(bb)] for bb in b]
    rs = [[bb, torch.empty_like(bb)] for bb in b]
    ap = [torch.empty_like(bb) for bb in b]
    ab = torch.zeros(2)
    ran = torch.zeros((), dtype=torch.int32)

    def body(k):
        i0, j = k % 2, 1 - k % 2
        for planes, g in ((rs, gr), (ps, gp)):
            exchange.fetch_bands([(r0, t[i0]) for (r0, _), t in zip(layout, planes)],
                                 band_cg._ghost_reqs(layout, g))
        paps = []
        for i, (r0, cf) in enumerate(layout):
            *_, pap = pcgmod.pcg_pass_a_band(xs[i][i0], rs[i][i0], ps[i][i0], cf, ab, gr[i],
                                             gp[i], gd[i], r0, true_h,
                                             out=(xs[i][j], ps[i][j], ap[i]))
            paps.append(pap)
        torch.div(gammas[i0], torch.sum(torch.cat(paps)), out=ab[0])
        parts = []
        for i in range(len(layout)):
            _, part = pcgmod.pcg_pass_b(rs[i][i0], ap[i], cfs[i], ab[0:1], out=rs[i][j])
            parts.append(part)
        part = torch.cat(parts)
        torch.sum(part[:, 0], 0, out=gammas[j])
        torch.sum(part[:, 1], 0, out=resid)
        torch.div(gammas[j], gammas[i0], out=ab[1])
        ran.add_(1)

    guard = Guard(pcgmod.pcg_solve_fused, count)
    tol32 = float(np.float32(tol))
    for k in range(iters):
        guard(resid, tol32, lambda k=k: body(k))
    count.add_(ran)
    odd = int(ran % 2 == 1)
    return [xs[i][odd] + ab[0] * ps[i][odd] for i in range(len(b))]


def _banded_cf(split, quad, seed):
    """The coefficient stack of a system split over a CPU mesh's bands."""
    (h, w), nb = SPLITS[split]
    s = _torch_sys(_system_np(h, w, quad, seed))
    cf = sormod.build_cf(s)
    return band_sor.split_rows(cf, _mesh(1, nb)), h


@pytest.mark.parametrize("stop", [0, 2, "remainder", "never"])
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("split", list(SPLITS))
def test_banded_sor_driver_equals_the_loop_it_replaced(split, quad, stop):
    """The stops of tests/test_torch_program.py's SOR driver test: a pass
    reports its incoming residual, so the first test that can stop the
    loop mid-solve follows pass 2; ``remainder`` skips the remainder pass."""
    bands, h = _banded_cf(split, quad, seed=11)
    resid0 = band_sor.resid0_of(bands, CPU)
    *_, history = sor_bands_before(bands, h, resid0, 0.0, ITERS)
    n_main = ITERS // sormod.PASS_SWEEPS
    want_n = {"remainder": n_main, "never": n_main + 1}.get(stop, stop)
    tol = 0.0 if stop == "never" else history[want_n]
    ref, n, reads, _ = sor_bands_before(bands, h, resid0, tol, ITERS)
    assert n == want_n
    sormod.sor_solve_cf.host_syncs = 0
    count = torch.zeros((), dtype=torch.int32)
    got = band_sor.solve_bands(bands, h, resid0, tol, ITERS, count=count)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert int(count) == n and sormod.sor_solve_cf.host_syncs == reads


@pytest.mark.parametrize("stop", ["0", "1", "mid", "never"])
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("split", list(SPLITS))
def test_banded_pcg_driver_equals_the_loop_it_replaced(split, quad, stop):
    (h, w), nb = SPLITS[split]
    s = _torch_sys(_system_np(h, w, quad, seed=12))
    cf, b = stack_system(s)
    mesh = _mesh(1, nb)

    def bands():                 # the driver overwrites its right-hand sides
        return [(r0, c, bb.clone()) for (r0, c), (_, bb)
                in zip(band_sor.split_rows(cf, mesh), band_sor.split_rows(b, mesh))]

    *_, history = pcg_bands_before(bands(), h, 0.0, ITERS)
    tol = _stop_tol(history, stop)
    ref, n, reads, _ = pcg_bands_before(bands(), h, tol, ITERS)
    want_n = {"0": 0, "1": 1, "never": ITERS}.get(stop)
    assert n == want_n if want_n is not None else 1 < n < ITERS
    pcgmod.pcg_solve_fused.host_syncs = 0
    count = torch.zeros((), dtype=torch.int32)
    got = band_cg.solve_bands(bands(), h, tol, ITERS, count=count)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert int(count) == n and pcgmod.pcg_solve_fused.host_syncs == reads


@pytest.mark.parametrize("layout", ["one body", "split"])
@pytest.mark.parametrize("stop", [0, 2, "remainder", "never"])
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("split", list(SPLITS))
def test_banded_sor_driver_equals_the_loop_in_bodies(split, quad, stop, layout, monkeypatch):
    """The SOR driver against the loop that held each pass in one body:
    iterates torch.equal, the device counts and the host reads equal, with
    its transfers between the guarded bodies (``split``, the layout of
    bands on several cards or processes, forced here) and in one body per
    pass (the layout of bands on one card, as here)."""
    if layout == "split":
        monkeypatch.setattr(band_sor, "one_body", lambda devs, exchange: False)
    bands, h = _banded_cf(split, quad, seed=13)
    resid0 = band_sor.resid0_of(bands, CPU)
    *_, history = sor_bands_before(bands, h, resid0, 0.0, ITERS)
    n_main = ITERS // sormod.PASS_SWEEPS
    want_n = {"remainder": n_main, "never": n_main + 1}.get(stop, stop)
    tol = 0.0 if stop == "never" else history[want_n]
    runs = []
    for solve in (sor_bands_in_bodies, band_sor.solve_bands):
        sormod.sor_solve_cf.host_syncs = 0
        count = torch.zeros((), dtype=torch.int32)
        if solve is sor_bands_in_bodies:
            got = solve(bands, h, resid0, tol, ITERS, count)
        else:
            got = solve(bands, h, resid0, tol, ITERS, count=count)
        runs.append((got, int(count), sormod.sor_solve_cf.host_syncs))
    (ref, n_ref, reads_ref), (got, n, reads) = runs
    assert n_ref == want_n
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert n == n_ref and reads == reads_ref


@pytest.mark.parametrize("layout", ["one body", "split"])
@pytest.mark.parametrize("stop", ["0", "1", "mid", "never"])
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("split", list(SPLITS))
def test_banded_pcg_driver_equals_the_loop_in_bodies(split, quad, stop, layout, monkeypatch):
    if layout == "split":
        monkeypatch.setattr(band_cg, "one_body", lambda devs, exchange: False)
    (h, w), nb = SPLITS[split]
    s = _torch_sys(_system_np(h, w, quad, seed=14))
    cf, b = stack_system(s)
    mesh = _mesh(1, nb)

    def bands():                 # the drivers overwrite their right-hand sides
        return [(r0, c, bb.clone()) for (r0, c), (_, bb)
                in zip(band_sor.split_rows(cf, mesh), band_sor.split_rows(b, mesh))]

    *_, history = pcg_bands_before(bands(), h, 0.0, ITERS)
    tol = _stop_tol(history, stop)
    runs = []
    for solve in (pcg_bands_in_bodies, band_cg.solve_bands):
        pcgmod.pcg_solve_fused.host_syncs = 0
        count = torch.zeros((), dtype=torch.int32)
        if solve is pcg_bands_in_bodies:
            got = solve(bands(), h, tol, ITERS, count)
        else:
            got = solve(bands(), h, tol, ITERS, count=count)
        runs.append((got, int(count), pcgmod.pcg_solve_fused.host_syncs))
    (ref, n_ref, reads_ref), (got, n, reads) = runs
    want_n = {"0": 0, "1": 1, "never": ITERS}.get(stop)
    assert n_ref == want_n if want_n is not None else 1 < n_ref < ITERS
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert n == n_ref and reads == reads_ref


# ----------------------------------------------------------------------------
# the program against octane_tpu's sharded_variational_flow
# ----------------------------------------------------------------------------

def _pair(h, w, shift=2.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def mk(cx):
        return (200 * np.exp(-(((xx - cx) ** 2 + (yy - h / 2) ** 2) / (2 * (w / 10) ** 2)))
                + 30 + 5 * np.sin(xx / 5.0) * np.cos(yy / 7.0)).astype(np.float32)

    return mk(w / 2 - shift / 2), mk(w / 2 + shift / 2)


@pytest.mark.parametrize("solver", ["sor", "pcg"])
def test_program_matches_jax_sharded_flow(solver):
    h = w = 64
    im1, im2 = _pair(h, w)
    z = np.zeros((h, w), np.float32)
    cfg = OFConfig(kiters=2, cgiters=10, solver=solver, halo_warp=8)
    fv.clear_program_cache()
    mesh = _mesh(2, 4)
    ops.reset_counters()
    program = sharded.sharded_flow_program(cfg, (h, w), 1, mesh)
    u, v = program(*(torch.from_numpy(a) for a in (im1[None], im2[None], z, z)))
    info = sharded.last_program_info
    assert info["route"] == "eager" and "cpu" in info["reason"]
    assert ops.counters()["sor_passes" if solver == "sor" else "pcg_iterations"] > 0
    jax_sharded._sharded_program_cache.clear()
    ju, jv = jax_sharded.sharded_variational_flow(im1, im2, z, z,
                                                  JaxOFConfig(**dataclasses.asdict(cfg)),
                                                  jax_make_mesh((2, 4)))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-3)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-3)
    jinfo = jax_sharded.last_program_info
    assert info["warp_levels"] == jinfo["warp_levels"] == frozenset(range(cfg.kiters))
    assert info["kiters"] == jinfo["kiters"] == cfg.kiters
    assert info["cg_levels"] == frozenset(range(cfg.kiters))
    fv.clear_program_cache()


def test_warp_levels_skip_levels_of_one_band():
    """A 54 x 50 pair on 4 bands of 16 rows: its coarsest level (7 rows at
    kiters 4) lies on one band, so the band warp does not serve it."""
    cfg = OFConfig(kiters=4)
    sharded.sharded_flow_program(cfg, (54, 50), 1, _mesh(1, 4))
    assert sharded.last_program_info["warp_levels"] == frozenset({1, 2, 3})
    fv.clear_program_cache()


# ----------------------------------------------------------------------------
# the reach test's wide body
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["sor", "pcg"])
def test_wide_body_keeps_the_flow(monkeypatch, solver):
    """A 12-px first guess downwards with halo_warp 4 (reach 2) runs the
    wide body in every round of both levels; with halo_warp 48 the level
    slabs hold every row and it never runs.  The two flows are equal bit for
    bit, and within the budget of the single-device flow."""
    calls = []
    wide = sharded._warp_wide

    def spy(bands, exchange, h, warp_fn, tally):
        calls.append(h)
        return wide(bands, exchange, h, warp_fn, tally)

    monkeypatch.setattr(sharded, "_warp_wide", spy)
    h = w = 48
    im1, im2 = _pair(h, w, shift=1.0)
    v0 = np.full((h, w), 12.0, np.float32)
    z = np.zeros((h, w), np.float32)
    t = [torch.from_numpy(a) for a in (im1, im2, z, v0)]
    mesh = _mesh(1, 4)
    flows = {}
    for halo in (4, 48):
        cfg = OFConfig(kiters=2, cgiters=6, solver=solver, halo_warp=halo, lambdac=0.5)
        calls.clear()
        sharded.guard_reads.reads = 0
        flows[halo] = sharded.sharded_variational_flow(*t, cfg, mesh)
        rounds = cfg.kiters * cfg.gnc_steps * cfg.liters
        assert sharded.guard_reads.reads == rounds
        assert len(calls) == (rounds if halo == 4 else 0)
    assert all(torch.equal(a, b) for a, b in zip(flows[4], flows[48]))
    u1, v1 = fv.variational_flow(*t, cfg)
    np.testing.assert_allclose(flows[4][0].numpy(), u1.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(flows[4][1].numpy(), v1.numpy(), rtol=0, atol=1e-4)
    fv.clear_program_cache()


def test_wide_body_tallies_itself(monkeypatch):
    """The eager route walks the wide body and counts it in its level's
    tally; the plain route walks the same bodies.  Each round warps the 3
    bands from their slabs and, in the wide body, again from the level."""
    h = w = 40
    im1, im2 = (torch.from_numpy(a)[None] for a in _pair(h, w))
    z = torch.zeros((1, h, w))
    full = [(0, torch.cat([im1, im2, z, torch.full((1, h, w), 9.0)]))]
    cfg = OFConfig(kiters=2, cgiters=4, solver="sor", halo_warp=4, lambdac=0.5)
    seen = []
    wide = sharded._warp_wide

    def spy(bands, exchange, hl, warp_fn, tally):
        wide(bands, exchange, hl, warp_fn, tally)
        seen.append(int(tally))

    monkeypatch.setattr(sharded, "_warp_wide", spy)
    for plain in (False, True):
        seen.clear()
        ops.reset_counters()
        _, count = sharded.banded_flow(full, (h, w), 1, cfg, _mesh(1, 3), LocalExchange(),
                                       plain)
        assert seen == list(range(1, 10)) * 2
        assert ops.counters()["warp_band"] == (0, 2 * 9 * 2 * 3)
        assert int(count) > 0


# ----------------------------------------------------------------------------
# key, route, refusals
# ----------------------------------------------------------------------------

def _jax_key_fields():
    """The OFConfig fields octane_tpu's sharded_flow_program keys its cache on."""
    with open(os.path.join(ROOT, "octane_tpu", "parallel", "sharded.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "sharded_flow_program")
    key = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "key")
    return {n.attr for n in ast.walk(key.value)
            if isinstance(n, ast.Attribute) and getattr(n.value, "id", None) == "cfg"}


CHANGED = dict(alpha=4.0, lambda_=0.5, lambdac=0.1, scale_factor=0.6, kiters=3, liters=2,
               cgiters=20, gnc_steps=2, dozim=False, solver="sor", sor_omega=1.7,
               cg_tol=1e-6, halo_warp=24)


def test_program_keys():
    """The same (mesh, shape, channels, config) gives the same program;
    another mesh shape or devices, each keyed field, the shape and the
    channels give another; options the solve does not read do not.  The
    key's fields are in this order; the programs share the single-device
    programs' cache."""
    assert set(CHANGED) == _jax_key_fields() - {"use_pallas"}
    fv.clear_program_cache()
    cfg = OFConfig(kiters=2)
    mesh = _mesh(1, 4)
    assert sharded.sharded_program_key(cfg, [32, 48], 1, mesh) == (
        (1, 4), (CPU,) * 4, (32, 48), 1, cfg.alpha, cfg.lambda_, cfg.lambdac,
        cfg.scale_factor, cfg.kiters, cfg.liters, cfg.cgiters, cfg.gnc_steps, cfg.dozim,
        cfg.solver, cfg.sor_omega, cfg.cg_tol, cfg.halo_warp, False)
    prog = sharded.sharded_flow_program(cfg, (32, 48), 1, mesh)
    assert sharded.sharded_flow_program(OFConfig(kiters=2), [32, 48], 1, _mesh(1, 4)) is prog
    assert sharded.sharded_flow_program(cfg.replace(do_srsal=True, rad=3), (32, 48), 1,
                                        mesh) is prog
    assert sharded.last_program_info["key"] == sharded.sharded_program_key(cfg, (32, 48), 1,
                                                                           mesh)
    others = [sharded.sharded_flow_program(cfg.replace(**{k: val}), (32, 48), 1, mesh)
              for k, val in CHANGED.items()]
    others += [sharded.sharded_flow_program(cfg, (32, 47), 1, mesh),
               sharded.sharded_flow_program(cfg, (32, 48), 2, mesh),
               sharded.sharded_flow_program(cfg, (32, 48), 1, _mesh(2, 2)),
               sharded.sharded_flow_program(cfg, (32, 48), 1, _mesh(1, 8)),
               sharded.sharded_flow_program(cfg, (32, 48), 1, _mesh(1, 4, "meta"))]
    assert len({id(p) for p in others + [prog]}) == len(others) + 1
    assert len(fp._cache) == len(others) + 1
    assert fv.flow_program(cfg, (32, 48), 1, "cpu") is not prog
    fv.clear_program_cache()
    assert not fp._cache
    assert sharded.sharded_flow_program(cfg, (32, 48), 1, mesh) is not prog
    fv.clear_program_cache()


def test_program_route():
    """A graph where every band lies on a card, one ("cuda" names the
    current card) or several, captured as one graph begun on the first
    band's card; the eager loop, with its reason, on the CPU.  Building a
    program touches no card."""
    cfg = OFConfig(kiters=2)
    cards = [torch.device("cuda", i) for i in range(4)]
    for devices, route, reason, on in (
            ([torch.device("cuda", 0)] * 4, "graph", "cuda:0", cards[:1]),
            ([torch.device("cuda", 0), torch.device("cuda", 1)] * 2, "graph", "2 cards",
             cards[:2]),
            (cards, "graph", "4 cards", cards),
            ([CPU] * 4, "eager", "cpu", [CPU])):
        program = sharded.sharded_flow_program(cfg, (32, 48), 1, make_mesh((1, 4), devices))
        info = sharded.last_program_info
        assert info["route"] == route and reason in info["reason"]
        assert program.captures == (route == "graph")
        assert list(program.devices) == on and program.device == on[0]
    fv.clear_program_cache()


def test_program_refusals():
    cfg = OFConfig(kiters=2)
    mesh = _mesh(1, 4)
    with pytest.raises(ValueError, match="true_shape"):
        sharded.sharded_flow_program(cfg, (32, 48), 1, mesh, true_shape=(31, 48))
    assert sharded.sharded_flow_program(cfg, (32, 48), 1, mesh, true_shape=(32, 48))
    prog = sharded.sharded_flow_program(cfg, (32, 48), 1, mesh)
    z = torch.zeros((32, 48))
    with pytest.raises(ValueError, match="flow program"):
        prog(torch.zeros((1, 32, 40)), torch.zeros((1, 32, 40)), z, z)
    with pytest.raises(ValueError, match="flow program"):
        prog(torch.zeros((2, 32, 48)), torch.zeros((2, 32, 48)), z, z)
    fv.clear_program_cache()


# ----------------------------------------------------------------------------
# the guard without a latch, and the launches of two kinds of body
# ----------------------------------------------------------------------------

def test_when_has_no_latch():
    ran = []
    reads = sum(when(torch.tensor(flag), lambda flag=flag: ran.append(flag))
                for flag in (True, False, True, False, True))
    assert ran == [True, True, True] and reads == 5


def test_record_pair_counts_two_kinds_of_body():
    """A banded replay: each band of 4 runs pass A and B in a solver body,
    and warp_band in a wide body; each kind's launches are one body's times
    its own device count."""
    ops.reset_counters()
    solve, wide = {"pcg_pass_a_band": 4, "pcg_pass_b": 4}, {"warp_band": 4}
    ops.record_pair("pcg", torch.tensor(700, dtype=torch.int32), {"warp_band": 144},
                    guarded=[(solve, torch.tensor(700, dtype=torch.int32)),
                             (wide, torch.tensor(3, dtype=torch.int32))])
    c = ops.counters()
    assert c["pcg_pass_a_band"] == c["pcg_pass_b"] == (2800, 0)
    assert c["warp_band"] == (156, 0) and c["pcg_iterations"] == 700
    ops.reset_counters()
