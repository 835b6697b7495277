"""The comparison under each algorithm, on the CPU at the tiny size: the
variational cells' check values are the ones recorded from the judge
before it knew the hybrid; a hybrid cell's solve starts from the
reference's patch-match, so a sound run is correct, its control is
refused, and a program whose start is left out or cut to whole pixels
reads not correct; a hybrid configuration under a warm-start traffic is
refused at load."""

import pytest
import torch

from octbench import reference, run, spec
from octbench.tests.tiny import tiny_cell, tiny_hybrid_cell

SEED = 2 ** 31 + 4321

# run.run(tiny_cell(solver), SEED, 1.0, False, "cpu", control=reference.CONTROL):
# (the program's numbers, the control's), recorded from the variational-only judge
RECORDED = {
    "pcg": ({"ingest_mismatch": 0.0, "flow_gap_px": 7.164478302001953e-05,
             "flow_gap_p999_px": 6.92903995513916e-05, "wind_gap": 1.0, "raw_gap": 1.0,
             "missing_pairs": 0.0},
            {"ingest_mismatch": 0.4153645833333333, "flow_gap_px": 0.15059053897857666,
             "flow_gap_p999_px": 0.14763200283050537, "wind_gap": 566.0, "raw_gap": 15.0,
             "missing_pairs": 0.0}),
    "sor": ({"ingest_mismatch": 0.0, "flow_gap_px": 0.0008014887571334839,
             "flow_gap_p999_px": 0.000509798526763916, "wind_gap": 4.0, "raw_gap": 1.0,
             "missing_pairs": 0.0},
            {"ingest_mismatch": 0.4153645833333333, "flow_gap_px": 0.42629051208496094,
             "flow_gap_p999_px": 0.4191882610321045, "wind_gap": 1486.0, "raw_gap": 42.0,
             "missing_pairs": 0.0}),
}


def _run(cell, control=None):
    out, numbers, control_numbers = run.run(cell, SEED, 1.0, False, "cpu", control=control)
    return out, numbers, control_numbers


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_variational_check_values_are_the_recorded_ones(solver):
    _, numbers, control = _run(tiny_cell(solver), reference.CONTROL)
    assert (numbers, control) == RECORDED[solver]


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_hybrid_run_is_correct_and_its_control_refused(solver):
    cell = tiny_hybrid_cell(solver)
    out, numbers, control = _run(cell, reference.CONTROL)
    assert out["correct"], numbers
    assert not run.within(control, cell.limits), control


def _zero_start(real):
    def patch_match(*args, **kw):
        u, v = real(*args, **kw)
        return torch.zeros_like(u), torch.zeros_like(v)
    return patch_match


def _whole_pixels(real):
    def patch_match(*args, **kw):
        u, v = real(*args, **kw)
        return u.round(), v.round()
    return patch_match


@pytest.mark.parametrize("fault", [_zero_start, _whole_pixels])
@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_hybrid_start_broken_reads_not_correct(fault, solver, monkeypatch):
    from octane_tpu_torch.flow import dispatcher

    monkeypatch.setattr(dispatcher, "patch_match_flow", fault(dispatcher.patch_match_flow))
    out, numbers, _ = _run(tiny_hybrid_cell(solver))
    assert not out["correct"], numbers


def test_hybrid_under_warm_start_is_refused_at_load():
    # fd-pcg with the draft hybrid configuration loads under its own cold
    # stream, and is refused under the mesoscale loops' warm starts
    bench = spec.benchmark()
    bench["configs"].append({"name": "goes-fd-b13-hybrid", "source": "draft",
                             "file": "octbench/rehearsal/goes-fd-b13-hybrid.json",
                             "reduced": [], "why": "draft"})
    fd = next(w for w in bench["workloads"] if w["name"] == "fd-pcg")
    fd["config"] = "goes-fd-b13-hybrid"
    cell = spec.cell("fd-pcg", bench)
    assert cell.config["settings"]["algorithm"] == "hybrid" and not cell.traffic["warm_start"]
    fd["traffic"] = "meso-loop-sor"
    with pytest.raises(SystemExit, match="warm-start"):
        spec.cell("fd-pcg", bench)
