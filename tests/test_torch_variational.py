"""flow.variational on the CPU: the golden fixtures (the loop-level NumPy
oracle's flows, tests/golden/*.npz) at mean EPE < 0.01 px and max < 0.1 px,
and the port against octane_tpu's ``variational_flow`` within 5e-3 px
(docs/PARITY.md, end-to-end row).  On the CPU the warp and PCG wrappers
run their plain versions.  The solver's internal plain route and the
reference PCG loop are held against the wrapper path.
"""

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
from octane_tpu_torch.flow import variational
from octane_tpu_torch.flow.cg import pcg_solve
from octane_tpu_torch.flow.stencil import StencilSystem, apply_stencil
from octane_tpu_torch.flow.variational import _coarse_to_fine, variational_flow
from octane_tpu_torch.io.native import epe_stats

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    return np.load(os.path.join(GOLDEN, name))


def _run(g, cfg):
    z = torch.zeros(g["u"].shape)
    u, v = variational_flow(torch.from_numpy(g["im1"]), torch.from_numpy(g["im2"]),
                            z, z, cfg)
    return u.numpy(), v.numpy()


@pytest.mark.parametrize("name,kiters", [("variational_64.npz", 3),
                                         ("variational_256.npz", 4)])
def test_golden_epe(name, kiters):
    g = _load(name)
    ops.reset_counters()
    u, v = _run(g, OFConfig(kiters=kiters))
    mean, mx, _ = epe_stats(u, v, g["u"], g["v"])
    assert mean < 0.01, f"mean EPE {mean}"
    assert mx < 0.1, f"max EPE {mx}"
    c = ops.counters()
    # every level went through the wrappers (plain versions on the CPU)
    assert c["warp"][1] == kiters * 9 and c["pcg_pass_a"][1] > 0
    assert c["warp"][0] == c["pcg_pass_a"][0] == 0


def test_matches_jax_variational_flow():
    g = _load("variational_64.npz")
    cfg = OFConfig(kiters=3)
    u, v = _run(g, cfg)
    z = jnp.zeros(g["u"].shape, jnp.float32)
    ju, jv = jax_flow(g["im1"], g["im2"], z, z, JaxOFConfig(**dataclasses.asdict(cfg)))
    d = max(float(np.abs(u - np.asarray(ju)).max()),
            float(np.abs(v - np.asarray(jv)).max()))
    assert d <= 5e-3, f"max |port - jax| {d:.3e} px"


def test_plain_reference_path_agrees(monkeypatch):
    """The reference PCG loop (flow.cg.pcg_solve, dot products summed whole)
    in place of the pass driver, against the wrapper path: the same solve
    with another PCG driver, so round-off only."""
    g = _load("variational_64.npz")
    u1, v1 = _run(g, OFConfig(kiters=3))

    def reference_loop(cf, b, partials, tol, iters, *passes):
        off = [-1.0] * 4 if cf.shape[0] == 3 else list(cf[3:])
        sysm = StencilSystem(cf[0], cf[2], cf[1], *off, b[0], b[1])
        return pcg_solve(lambda a, b: apply_stencil(sysm, a, b), sysm.a1, sysm.a4,
                         sysm.bu, sysm.bv, tol, iters)

    monkeypatch.setattr(variational, "pcg_solve_cf", reference_loop)
    ops.reset_counters()
    u2, v2 = _run(g, OFConfig(kiters=3))
    assert ops.counters()["pcg_pass_a"] == (0, 0)
    assert max(np.abs(u1 - u2).max(), np.abs(v1 - v2).max()) <= 5e-3


def test_plain_route_is_counted_and_bit_identical():
    """``plain=True`` calls the plain versions directly (the route chip_smoke
    times the kernels against on the card); on the CPU the wrappers run the
    same plain versions, so the flows are equal bit for bit, and every call
    counts as a plain call."""
    g = _load("variational_64.npz")
    cfg = OFConfig(kiters=3)
    z = torch.zeros(g["u"].shape)
    im1, im2 = torch.from_numpy(g["im1"])[None], torch.from_numpy(g["im2"])[None]
    ops.reset_counters()
    u1, v1 = _coarse_to_fine(im1, im2, z, z, cfg)
    wrapped = ops.counters()
    ops.reset_counters()
    u2, v2 = _coarse_to_fine(im1, im2, z, z, cfg, plain=True)
    assert ops.counters() == wrapped
    assert torch.equal(u1, u2) and torch.equal(v1, v2)


@pytest.mark.parametrize("name,kiters", [("variational_64.npz", 3),
                                         ("variational_256.npz", 4)])
def test_golden_epe_sor(name, kiters):
    """``solver="sor"``: warp -> fused assembly -> SOR driver at every level
    (tests/test_golden.py:87-100 holds the JAX SOR path to the same budget)."""
    g = _load(name)
    ops.reset_counters()
    u, v = _run(g, OFConfig(kiters=kiters, solver="sor"))
    mean, mx, _ = epe_stats(u, v, g["u"], g["v"])
    assert mean < 0.01, f"mean EPE {mean}"
    assert mx < 0.1, f"max EPE {mx}"
    c = ops.counters()
    rounds = kiters * 9
    assert c["warp"] == (0, rounds) and c["assemble_cf"] == (0, rounds)
    assert c["sor_pass"] == (0, rounds * 4)    # 3 x 8 + 6 sweeps: tol never binds here
    assert c["sor_host_syncs"] == rounds * 4 and c["pcg_pass_a"] == (0, 0)


def test_sor_matches_jax_variational_flow():
    g = _load("variational_64.npz")
    cfg = OFConfig(kiters=3, solver="sor")
    u, v = _run(g, cfg)
    z = jnp.zeros(g["u"].shape, jnp.float32)
    ju, jv = jax_flow(g["im1"], g["im2"], z, z, JaxOFConfig(**dataclasses.asdict(cfg)))
    d = max(float(np.abs(u - np.asarray(ju)).max()),
            float(np.abs(v - np.asarray(jv)).max()))
    assert d <= 5e-3, f"max |port - jax| {d:.3e} px"


def test_sor_plain_route_is_counted_and_bit_identical():
    g = _load("variational_64.npz")
    cfg = OFConfig(kiters=2, solver="sor", sor_omega=1.7)
    z = torch.zeros(g["u"].shape)
    im1, im2 = torch.from_numpy(g["im1"])[None], torch.from_numpy(g["im2"])[None]
    ops.reset_counters()
    u1, v1 = _coarse_to_fine(im1, im2, z, z, cfg)
    wrapped = ops.counters()
    ops.reset_counters()
    u2, v2 = _coarse_to_fine(im1, im2, z, z, cfg, plain=True)
    assert ops.counters() == wrapped
    assert torch.equal(u1, u2) and torch.equal(v1, v2)
    u3, _ = _coarse_to_fine(im1, im2, z, z, cfg.replace(sor_omega=1.9))
    assert float((u1 - u3).abs().max()) > 0, "sor_omega must reach the sweeps"
