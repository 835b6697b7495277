"""The harness's whole run on the CPU at a tiny size (``tiny.tiny_cell``),
without its look for a card, sound and with the timed path broken
underneath: each fault that a cell can have must read ``correct`` false.
A cell on one card has no exchange between cards; its batch is one pair,
and "half of the batch left out" is half of the pair's rows."""

import pytest
import torch

from octbench import run
from octbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 4321


def _run(cell, seconds=1.0, trace=False):
    out, numbers, _ = run.run(cell, SEED, seconds, trace, "cpu")
    return out, numbers


def test_sound_run_is_correct():
    out, numbers = _run(tiny_cell())
    assert out["correct"], numbers
    assert list(out)[-1] == "checks" and set(out["checks"]) >= set(tiny_cell().limits)
    assert out["attempted"] >= 1
    assert {"pair_ms", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_sound_run_on_bands_is_correct(solver):
    # settings.mesh_shape as a JSON list: two row bands (on the CPU, both
    # on the CPU), the kept outputs compared from host memory
    cell = tiny_cell(solver)
    cell.config["settings"]["mesh_shape"] = [2, 1]
    out, numbers = _run(cell, seconds=3.0)
    assert out["correct"], numbers
    assert out["device"]["count"] == 1


def test_traced_run_reads_its_layers():
    out, _ = _run(tiny_cell("sor"), trace=True)
    assert out["correct"]
    assert {"ingest_ms", "flow_ms", "output_ms", "device_idle_share"} <= set(out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(geo1, geo2, u0, v0, cfg):
    return u0.clone(), v0.clone()


def _half(real):
    def flow(geo1, geo2, u0, v0, cfg):
        u, v = real(geo1, geo2, u0, v0, cfg)
        h = u.shape[0] // 2
        u, v = u.clone(), v.clone()
        u[h:] = 0.0
        v[h:] = 0.0
        return u, v
    return flow


def _altered_flow(real):
    def flow(geo1, geo2, u0, v0, cfg):
        u, v = real(geo1, geo2, u0, v0, cfg)
        u = u.clone()
        u[7, 9] += 0.25
        return u, v
    return flow


def _altered_wind(real):
    def winds(*args, **kw):
        uw, vw, ur, vr = real(*args, **kw)
        vw = vw.clone()
        vw[11, 5] += 100                   # 1 m/s at one pixel
        return uw, vw, ur, vr
    return winds


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered_flow", "altered_wind"])
def test_fault_reads_not_correct(fault, monkeypatch):
    from octane_tpu_torch.flow import dispatcher

    if fault == "altered_wind":
        monkeypatch.setattr(dispatcher, "pix2uv", _altered_wind(dispatcher.pix2uv))
    else:
        make = {"unchanged": lambda real: _unchanged, "half": _half,
                "altered_flow": _altered_flow}[fault]
        monkeypatch.setattr(dispatcher, "variational_flow", make(dispatcher.variational_flow))
    out, numbers = _run(tiny_cell())
    assert not out["correct"], numbers


def test_missing_pair_reads_not_correct():
    cell = tiny_cell()
    cell.traffic.update(sequences=8, frames=3)      # 16 pairs; the window runs one
    seed = next(s for s in range(SEED, SEED + 100)
                if max(run.compared_positions(cell, s)) > 0)
    out, numbers, _ = run.run(cell, seed, 0.0, False, "cpu")
    assert out["attempted"] == 1 and numbers["missing_pairs"] > 0
    assert not out["correct"]


def test_within_refuses_nan():
    nums = {"ingest_mismatch": 0.0, "flow_gap_px": float("nan"), "missing_pairs": 0.0}
    assert not run.within(nums, {"ingest_mismatch": 1e-3, "flow_gap_px": 1.0})
    nums["flow_gap_px"] = 0.5
    assert run.within(nums, {"ingest_mismatch": 1e-3, "flow_gap_px": 1.0})
    assert torch.isnan(torch.tensor(run._nan_max(0.1, float("nan"))))
