"""octane_tpu_torch's banded variational flow (parallel.sharded) on the CPU,
against the port's single-device flow and against octane_tpu's.

``sharded_variational_flow`` on a (2, 4) and a (1, 8) mesh of CPU bands,
per relaxer, at 64^2 and the odd 54x50 (octane_tpu's
tests/test_sharded.py:101-113; uneven bands, one empty at the coarse
level): within 1e-3 px of the port's ``variational_flow`` and of
octane_tpu's ``variational_flow`` (octane_tpu's budget; the zoom's matrix
products and the solvers' sums run in another order on bands).  The banded
plain route counts plain calls only; every band form runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from octane_tpu.config import OFConfig as JaxOFConfig
from octane_tpu.flow.variational import variational_flow as jax_variational_flow

from octane_tpu_torch import ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow.variational import variational_flow
from octane_tpu_torch.parallel import make_mesh, sharded_variational_flow
from octane_tpu_torch.parallel.sharded import _coarse_to_fine_banded, guard_reads
from octane_tpu_torch.parallel.halo import LocalExchange

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _pair(h, w, shift=2.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def mk(cx):
        return (200 * np.exp(-(((xx - cx) ** 2 + (yy - h / 2) ** 2) / (2 * (w / 10) ** 2)))
                + 30 + 5 * np.sin(xx / 5.0) * np.cos(yy / 7.0)).astype(np.float32)

    return mk(w / 2 - shift / 2), mk(w / 2 + shift / 2)


@pytest.mark.parametrize("solver", ["sor", "pcg"])
@pytest.mark.parametrize("case", [((54, 50), (2, 4), 2), ((64, 64), (2, 4), 3),
                                  ((64, 64), (1, 8), 2)])
def test_banded_flow_matches_single_device_and_jax(solver, case):
    (h, w), shape, kiters = case
    im1, im2 = _pair(h, w)
    z = np.zeros((h, w), np.float32)
    cfg = OFConfig(kiters=kiters, cgiters=10, solver=solver, halo_warp=8)
    t = [torch.from_numpy(a) for a in (im1, im2, z, z)]
    u1, v1 = variational_flow(*t, cfg)
    mesh = make_mesh(shape, [CPU] * (shape[0] * shape[1]))
    ops.reset_counters()
    guard_reads.reads = 0
    u2, v2 = sharded_variational_flow(*t, cfg, mesh)
    c = ops.counters()
    rounds = kiters * cfg.gnc_steps * cfg.liters
    assert guard_reads.reads == rounds                  # one reach-guard read per warp
    assert all(c[k][1] > 0 for k in ops.PATHS[f"mesh_{solver}"])
    assert all(c[k] == (0, 0) for k in ("warp", "sor_pass", "pcg_pass_a"))
    assert u2.shape == (h, w)
    for got, want in ((u2, u1), (v2, v1)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-3)
    ju, jv = jax_variational_flow(im1, im2, z, z, JaxOFConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(u2.numpy(), np.asarray(ju), rtol=0, atol=1e-3)
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), rtol=0, atol=1e-3)


def test_banded_plain_route_equals_the_wrappers():
    """The internal plain route of the banded path calls the plain versions
    directly (counted as plain calls) and gives the same flow."""
    im1, im2 = _pair(40, 48)
    z = np.zeros((40, 48), np.float32)
    t = [torch.from_numpy(a)[None] for a in (im1, im2)] + [torch.from_numpy(z)] * 2
    cfg = OFConfig(kiters=2, cgiters=8, solver="sor")
    mesh = make_mesh((1, 3), [CPU] * 3)
    ops.reset_counters()
    u1, v1 = _coarse_to_fine_banded(*t, cfg, mesh, LocalExchange(), plain=True)
    plain = ops.counters()
    u2, v2 = sharded_variational_flow(*t, cfg, mesh)
    assert torch.equal(u1, u2) and torch.equal(v1, v2)
    assert plain["sor_pass_band"][1] > 0 and plain["warp_band"][1] > 0


def test_reach_guard_widens_the_level_slab(monkeypatch):
    """A first guess of 12 px downwards exceeds halo_warp - 2 = 2 of a
    4-row halo at every level: the reach test runs the wide body (the whole
    level as the slab, every band warped again) in every round, and the
    flow stays that of one device."""
    from octane_tpu_torch.parallel import sharded

    seen = []

    def spy(bands, exchange, h, warp_fn, tally):
        seen.append(h)
        return wide(bands, exchange, h, warp_fn, tally)

    wide = sharded._warp_wide
    monkeypatch.setattr(sharded, "_warp_wide", spy)
    h = w = 48
    im1, im2 = _pair(h, w, shift=1.0)
    v0 = np.full((h, w), 12.0, np.float32)
    z = np.zeros((h, w), np.float32)
    cfg = OFConfig(kiters=2, cgiters=6, solver="sor", halo_warp=4, lambdac=0.5)
    t = [torch.from_numpy(a) for a in (im1, im2, z, v0)]
    u1, v1 = variational_flow(*t, cfg)
    guard_reads.reads = 0
    u2, v2 = sharded_variational_flow(*t, cfg, make_mesh((1, 4), [CPU] * 4))
    np.testing.assert_allclose(u2.numpy(), u1.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(v2.numpy(), v1.numpy(), rtol=0, atol=1e-4)
    rounds = cfg.gnc_steps * cfg.liters
    assert seen == [24] * rounds + [48] * rounds       # every round of both levels
    assert guard_reads.reads == 2 * rounds
