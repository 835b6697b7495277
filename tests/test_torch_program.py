"""The flow program's state handling on the CPU (flow.variational.flow_program,
the guarded drivers ops.pcg.pcg_solve_fused and ops.sor.sor_solve_cf).

On the CPU the guards read the residual on the host, but the drivers walk
every guarded body without breaking, with their state in buffers fixed
before the loop, as in the captured graph; so a stale-buffer fault shows
here too.  Test 1 holds them bit for bit against copies of the loops they
replaced (kept below as references, not routes of the package) at
tolerances that stop at iteration 0, at iteration 1, mid-solve and never:
iterates, iteration counts and host reads equal.  Test 2 checks the
program cache's keys against octane_tpu's flow_program.  Test 3 holds
variational_flow, now through its program, against octane_tpu's with
tolerances that stop each relaxer early, within 5e-3 px
(tests/test_torch_variational.py's budget).  The captured replay itself
runs on the card (tests/test_torch_cuda.py, chip_smoke.py's program
phase).
"""

import ast
import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from octane_tpu.config import OFConfig as JaxOFConfig
from octane_tpu.flow.variational import variational_flow as jax_flow
from octane_tpu_torch import ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow import program as fp
from octane_tpu_torch.flow import variational as fv
from octane_tpu_torch.ops import pcg as pcgmod
from octane_tpu_torch.ops import sor as sormod
from octane_tpu_torch.ops.pcg import initial_partials

from test_torch_pcg import _system_np, _torch_sys

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 30


def pcg_loop_before(sysm, tol, iters):
    """ops.pcg.pcg_solve_fused as it was before its state moved into fixed
    buffers: a Python loop that breaks on a host read.  Returns (du, dv,
    iterations, host reads, the residual before each iteration and after
    the last)."""
    quad = not torch.is_tensor(sysm.a5)
    planes = [sysm.a1, sysm.a4, sysm.a2]
    if not quad:
        planes += [sysm.a5, sysm.a6, sysm.a7, sysm.a8]
    cf = torch.stack(planes)
    b = torch.stack([sysm.bu, sysm.bv])
    part = initial_partials(cf, b)
    gamma = torch.sum(part[:, 0]) + torch.sum(part[:, 1])
    resid = torch.sum(part[:, 2])
    x, p, r = torch.zeros_like(b), torch.zeros_like(b), b
    alpha = torch.zeros((), dtype=torch.float32)
    beta = torch.zeros_like(alpha)
    tol32 = float(np.float32(tol))
    n = reads = 0
    history = [float(resid)]
    for _ in range(iters):
        reads += 1
        if not float(resid) > tol32:
            break
        x, p, ap, pap = pcgmod.pcg_pass_a_plain(x, r, p, cf, torch.stack([alpha, beta]))
        alpha = gamma / torch.sum(pap)
        r, part = pcgmod.pcg_pass_b_plain(r, ap, cf, alpha.reshape(1))
        gamma_new = torch.sum(part[:, 0])
        resid = torch.sum(part[:, 1])
        beta = gamma_new / gamma
        gamma = gamma_new
        n += 1
        history.append(float(resid))
    x = x + alpha * p
    return x[0], x[1], n, reads, history


def sor_loop_before(cf, resid0, tol, iters, omega=sormod.OMEGA):
    """ops.sor.sor_solve_cf as it was: a for ... else loop over passes that
    swaps two buffers' Python references and breaks on a host read.
    Returns (du, dv, passes, host reads, the residual before each pass)."""
    _, h, w = cf.shape
    s_main = min(sormod.PASS_SWEEPS, iters)
    n_main, s_rem = divmod(iters, s_main)
    tol32 = float(np.float32(tol))
    bufs = [torch.zeros((2, h, w)), torch.empty((2, h, w))]
    n = reads = 0
    history = [float(resid0)]

    def run(ns):
        _, part = sormod.sor_pass_plain(bufs[0], cf, ns, omega, out=bufs[1])
        bufs.reverse()
        return torch.sum(part)

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
    return bufs[0][0], bufs[0][1], n, reads, history


def _stop_tol(history, stop):
    """A tolerance at which the loop stops ``stop``: at iteration 0, after
    iteration 1, mid-solve, or never."""
    if stop == "0":
        return history[0]
    if stop == "1":
        return history[1]
    if stop == "mid":
        return min(history[:len(history) // 2 + 1])
    return 0.0


STOPS = ["0", "1", "mid", "never"]
SHAPES = [(64, 64), (37, 53)]


@pytest.mark.parametrize("stop", STOPS)
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("hw", SHAPES)
def test_pcg_driver_equals_the_loop_it_replaced(hw, quad, stop):
    s = _torch_sys(_system_np(*hw, quad, seed=7))
    *_, history = pcg_loop_before(s, 0.0, ITERS)
    tol = _stop_tol(history, stop)
    ru, rv, n, reads, _ = pcg_loop_before(s, tol, ITERS)
    want_n = {"0": 0, "1": 1, "never": ITERS}.get(stop)
    assert n == want_n if want_n is not None else 1 < n < ITERS
    pcgmod.pcg_solve_fused.host_syncs = 0
    count = torch.zeros((), dtype=torch.int32)
    du, dv = pcgmod.pcg_solve_fused(s, tol, ITERS, count=count)
    assert torch.equal(du, ru) and torch.equal(dv, rv)
    assert int(count) == n and pcgmod.pcg_solve_fused.host_syncs == reads


@pytest.mark.parametrize("stop", [0, 2, "remainder", "never"])
@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("hw", SHAPES)
def test_sor_driver_equals_the_loop_it_replaced(hw, quad, stop):
    """A pass reports the residual of its incoming iterate, so the test
    after pass 1 reads ||b||^2 again and the first test that can stop the
    loop mid-solve follows pass 2 (``2``); ``remainder``: the residual
    meets the tolerance after the last main pass, so the remainder pass is
    skipped."""
    s = _torch_sys(_system_np(*hw, quad, seed=8))
    cf = sormod.build_cf(s)
    resid0 = torch.sum(s.bu * s.bu) + torch.sum(s.bv * s.bv)
    *_, history = sor_loop_before(cf, resid0, 0.0, ITERS)
    n_main = ITERS // sormod.PASS_SWEEPS
    want_n = {"remainder": n_main, "never": n_main + 1}.get(stop, stop)
    tol = 0.0 if stop == "never" else history[want_n]
    ru, rv, n, reads, _ = sor_loop_before(cf, resid0, tol, ITERS)
    assert n == want_n
    sormod.sor_solve_cf.host_syncs = 0
    count = torch.zeros((), dtype=torch.int32)
    du, dv = sormod.sor_solve_cf(cf, resid0, tol, ITERS, count=count)
    assert torch.equal(du, ru) and torch.equal(dv, rv)
    assert int(count) == n and sormod.sor_solve_cf.host_syncs == reads


def _jax_key_fields():
    """The OFConfig fields octane_tpu's flow_program keys its cache on."""
    with open(os.path.join(ROOT, "octane_tpu", "flow", "variational.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "flow_program")
    key = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "key")
    return {n.attr for n in ast.walk(key.value)
            if isinstance(n, ast.Attribute) and getattr(n.value, "id", None) == "cfg"}


CHANGED = dict(alpha=4.0, lambda_=0.5, lambdac=0.1, scale_factor=0.6, kiters=3, liters=2,
               cgiters=20, gnc_steps=2, dozim=False, solver="sor", sor_omega=1.7,
               cg_tol=1e-6)


def test_program_keys():
    """The same (shape, channels, config, device) gives the same program;
    each keyed field, the shape and the channels give another; options the
    solve does not read do not.  The keyed fields are octane_tpu's but its
    TPU option, in this order; programs of every kind share one cache."""
    assert set(CHANGED) == _jax_key_fields() - {"use_pallas"}
    fv.clear_program_cache()
    cfg = OFConfig(kiters=2)
    assert fv.program_key(cfg, [32, 48], 1, "cpu") == (
        (32, 48), 1, cfg.alpha, cfg.lambda_, cfg.lambdac, cfg.scale_factor, cfg.kiters,
        cfg.liters, cfg.cgiters, cfg.gnc_steps, cfg.dozim, cfg.solver, cfg.sor_omega,
        cfg.cg_tol, torch.device("cpu"), False)
    prog = fv.flow_program(cfg, (32, 48), 1, "cpu")
    assert fv.flow_program(OFConfig(kiters=2), [32, 48], 1, torch.device("cpu")) is prog
    assert fv.flow_program(cfg.replace(do_srsal=True, rad=3, nchannels=2), (32, 48), 1,
                           "cpu") is prog
    others = [fv.flow_program(cfg.replace(**{k: val}), (32, 48), 1, "cpu")
              for k, val in CHANGED.items()]
    others += [fv.flow_program(cfg, (32, 47), 1, "cpu"), fv.flow_program(cfg, (32, 48), 2, "cpu")]
    assert len({id(p) for p in others + [prog]}) == len(others) + 1
    assert len(fp._cache) == len(others) + 1
    fv.clear_program_cache()
    assert not fp._cache
    assert fv.flow_program(cfg, (32, 48), 1, "cpu") is not prog


def test_program_refuses_other_shapes():
    prog = fv.flow_program(OFConfig(kiters=2), (32, 48), 1, "cpu")
    z = torch.zeros((32, 48))
    with pytest.raises(ValueError, match="flow program"):
        prog(torch.zeros((1, 32, 40)), torch.zeros((1, 32, 40)), z, z)
    with pytest.raises(ValueError, match="flow program"):
        prog(torch.zeros((2, 32, 48)), torch.zeros((2, 32, 48)), z, z)


@pytest.mark.parametrize("solver,tol,most", [("pcg", 1e-2, 3 * 9 * ITERS),
                                             ("sor", 1.0, 3 * 9 * 4)])
def test_variational_flow_stopping_early_matches_jax(solver, tol, most):
    """Both relaxers with a tolerance that stops them early in some rounds
    (fewer iterations or passes than the most, read from ops.counters())."""
    g = np.load(os.path.join(ROOT, "tests", "golden", "variational_64.npz"))
    cfg = OFConfig(kiters=3, solver=solver, cg_tol=tol)
    z = torch.zeros(g["u"].shape)
    ops.reset_counters()
    u, v = fv.variational_flow(torch.from_numpy(g["im1"]), torch.from_numpy(g["im2"]), z, z,
                               cfg)
    ran = ops.counters()["pcg_iterations" if solver == "pcg" else "sor_passes"]
    assert 0 < ran < most
    zj = jnp.zeros(g["u"].shape, jnp.float32)
    ju, jv = jax_flow(g["im1"], g["im2"], zj, zj, JaxOFConfig(**dataclasses.asdict(cfg)))
    d = max(float(np.abs(u.numpy() - np.asarray(ju)).max()),
            float(np.abs(v.numpy() - np.asarray(jv)).max()))
    assert d <= 5e-3, f"max |port - jax| {d:.3e} px"


def test_record_pair_counts_replayed_launches_from_the_device_count():
    """A replay's launches: its unguarded nodes each time, and one guarded
    body's launches times the device count of the bodies that ran."""
    ops.reset_counters()
    nodes, per_body = {"warp": 36}, {"pcg_pass_a": 1, "pcg_pass_b": 1}
    for ran in (700, 0, 380):
        count = torch.tensor(ran, dtype=torch.int32)
        ops.record_pair("pcg", count, nodes, guarded=[(per_body, count)])
    c = ops.counters()
    assert c["warp"] == (108, 0)
    assert c["pcg_pass_a"] == c["pcg_pass_b"] == (1080, 0)
    assert c["pcg_iterations"] == 380 and c["sor_passes"] == 0
    assert c["sor_pass"] == (0, 0) and c["pcg_host_syncs"] == 0
    ops.reset_counters()
    assert ops.counters()["pcg_pass_a"] == (0, 0) and ops.counters()["pcg_iterations"] == 0


@pytest.mark.parametrize("solver,tol", [("pcg", 1e-2), ("sor", 1.0), ("pcg", 1e-30)])
def test_guarded_calls_equal_the_device_count(solver, tol):
    """On the eager route each body that ran calls its relaxer's passes
    once, so their calls equal the pair's device count, the number a
    replay's launches are derived from."""
    g = np.load(os.path.join(ROOT, "tests", "golden", "variational_64.npz"))
    z = torch.zeros(g["u"].shape)
    ops.reset_counters()
    fv.variational_flow(torch.from_numpy(g["im1"]), torch.from_numpy(g["im2"]), z, z,
                        OFConfig(kiters=2, solver=solver, cg_tol=tol))
    c = ops.counters()
    ran = c["pcg_iterations" if solver == "pcg" else "sor_passes"]
    guarded = ("pcg_pass_a", "pcg_pass_b") if solver == "pcg" else ("sor_pass",)
    assert ran > 0 and all(c[name][1] == ran for name in guarded)
