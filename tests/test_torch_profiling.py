"""octane_tpu_torch.utils.profiling: StageTimer as octane_tpu's (mirrors
tests/test_sequence.py::TestProfiling; the same records give the same
summary() and report() as octane_tpu.utils.profiling.StageTimer, exactly)
and trace() writing a Chrome trace on the CPU; then the tracer on the CPU:
the spans of a compute_flow pair nest with their parents and request ids,
the solve's device spans (the CPU's stamps are the host clock) nest by
level and round, nothing is recorded, entered or stamped with the tracer
off, flows and winds are bit-identical with it on, the round counts sum
to the pairs' counts through the eager route and a program, the tracer's
state is part of the program key, and StageTimer's stages are spans.
The card's side (stamps in a replayed graph, the clock offset) is in
test_torch_cuda.py."""

import json
import os

import numpy as np
import pytest
import torch

from octane_tpu.utils.profiling import StageTimer as JaxStageTimer
from octane_tpu_torch.utils import StageTimer, trace

RECORDS = [
    {"short": [0.001, 0.002], "long": [0.5]},
    {"solve": [0.123456789, 0.2, 0.3], "ingest": [0.0004], "a_stage_name_longer_than_28": [1.5]},
    {"tie_a": [0.25], "tie_b": [0.125, 0.125], "zero": [0.0]},
]


class TestProfiling:
    def test_stage_timer(self):
        t = StageTimer()
        with t.stage("a"):
            pass
        with t.stage("a"):
            pass
        with t.stage("b", sync_on=torch.zeros(3)):
            pass
        rows = dict((r[0], r[1]) for r in t.summary())
        assert rows == {"a": 2, "b": 1}
        assert "total_ms" in t.report()

    def test_summary_orders_by_total_and_report_has_every_stage(self):
        t = StageTimer()
        t.records = {"short": [0.001, 0.002], "long": [0.5]}
        assert [r[0] for r in t.summary()] == ["long", "short"]
        name, n, total, mean = t.summary()[1]
        assert (name, n) == ("short", 2) and abs(total - 0.003) < 1e-12
        assert abs(mean - 0.0015) < 1e-12
        lines = t.report().splitlines()
        assert lines[0].split() == ["stage", "n", "total_ms", "mean_ms"]
        assert lines[1].split() == ["long", "1", "500.00", "500.00"]

    @pytest.mark.parametrize("records", RECORDS)
    def test_summary_and_report_equal_the_jax_package(self, records):
        ours, theirs = StageTimer(), JaxStageTimer()
        ours.records = {k: list(v) for k, v in records.items()}
        theirs.records = {k: list(v) for k, v in records.items()}
        assert ours.summary() == theirs.summary()
        assert ours.report() == theirs.report()

    def test_stages_record_as_the_jax_package(self):
        """The same stages through stage() give the same names and counts;
        the times are each timer's own."""
        ours, theirs = StageTimer(), JaxStageTimer()
        for timer, sync in ((ours, torch.zeros(3)), (theirs, None)):
            for name in ("read", "solve", "read", "write", "solve", "read"):
                with timer.stage(name, sync_on=sync):
                    pass
        assert ([r[:2] for r in sorted(ours.summary())]
                == [r[:2] for r in sorted(theirs.summary())])
        assert (ours.report().splitlines()[0] == theirs.report().splitlines()[0])

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        log_dir = tmp_path / "trace"
        with trace(str(log_dir)):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
        files = os.listdir(log_dir)
        assert len(files) == 1 and files[0].endswith(".json")
        path = log_dir / files[0]
        assert path.stat().st_size > 0
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any("matmul" in str(e.get("name", "")) for e in events)


# --- the tracer (utils.profiling): spans, device stamps, round counts -------

from octane_tpu_torch import ops  # noqa: E402
from octane_tpu_torch.config import OFConfig  # noqa: E402
from octane_tpu_torch.flow import variational as fv  # noqa: E402
from octane_tpu_torch.flow.dispatcher import compute_flow  # noqa: E402
from octane_tpu_torch.io.readers import scene_from_goes_arrays  # noqa: E402
from octane_tpu_torch.utils import profiling  # noqa: E402
# by its module name (pytest puts tests/ on the path): an installed package
# named ``tests`` would shadow ``tests.torch_fixtures``
from torch_fixtures import FIXTURE_T0, fixture_counts, goes_arrays  # noqa: E402


@pytest.fixture
def tracer():
    """The tracer on for the test, off and emptied after it."""
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()
        fv.clear_program_cache()


def _pair(cfg, h=40, w=56):
    """The two-scan GOES fixture through the reader and compute_flow on the
    CPU; returns the first scene."""
    scenes = []
    for shift, t, donav in (((0, 0), FIXTURE_T0, True), ((1.2, -0.6), FIXTURE_T0 + 60, False)):
        counts, x, y, nav, t, _, _ = goes_arrays(fixture_counts(*shift, h, w), t)
        scenes.append(scene_from_goes_arrays(counts, x, y, nav, cfg, "cpu", donav=donav, t=t))
    return compute_flow(scenes[0], scenes[1], cfg)


def _key(solver):
    return "pcg_iterations" if solver == "pcg" else "sor_passes"


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_spans_nest_with_parents_and_request_ids(tracer, solver):
    cfg = OFConfig(kiters=2, solver=solver)
    with profiling.request(3):
        _pair(cfg)
    with profiling.request(4):
        with profiling.span("outer"):
            _pair(cfg)
    recs = profiling.records()
    assert set(recs) == {3, 4}
    spans = recs[3]
    by_id = {s.id: s for s in spans}

    def parent(s):
        return by_id[s.parent].name if s.parent is not None else None

    names = [s.name for s in spans]
    assert names.count("octane.ingest") == 2 and names.count("octane.flow") == 1
    for s in spans:
        want = {"octane.ingest": None, "octane.ingest.h2d": "octane.ingest",
                "octane.ingest.navcal": "octane.ingest", "octane.flow": None,
                "octane.flow.first_guess": "octane.flow", "octane.flow.solve": "octane.flow",
                "octane.flow.pix2uv": "octane.flow", "octane.solve": "octane.flow.solve",
                "octane.level": "octane.solve", f"octane.{solver}": "octane.level"}[s.name]
        assert parent(s) == want, (s.name, s.at, want)
        if s.start is not None:         # a host span: within its parent's host times
            assert s.start <= s.end
            if s.parent is not None:
                p = by_id[s.parent]
                assert p.start <= s.start and s.end <= p.end
        if s.device_start is not None:
            assert s.device_start <= s.device_end
    # the device spans of the solve: kiters levels, each of gnc_steps x liters rounds
    levels = [s for s in spans if s.name == "octane.level"]
    rounds = [s for s in spans if s.name == f"octane.{solver}"]
    assert [s.at for s in levels] == [(0,), (1,)]
    assert [s.at for s in rounds] == [(k, g, i) for k in range(2) for g in range(3)
                                      for i in range(3)]
    for r in rounds:
        lvl = by_id[r.parent]
        assert lvl.at == r.at[:1] and lvl.device_start <= r.device_start <= r.device_end
        assert r.device_end <= lvl.device_end
    solve = next(s for s in spans if s.name == "octane.solve")
    assert solve.device_start <= levels[0].device_start
    assert levels[-1].device_end == solve.device_end
    # eager stamps: navcal and pix2uv carry device times, the host spans around them not
    for s in spans:
        stamped = s.name in ("octane.ingest.navcal", "octane.flow.pix2uv") or s.start is None
        assert (s.device_start is not None) == stamped, s.name
    # the second request's outer span is the parent of its top-level spans
    outer = next(s for s in recs[4] if s.name == "outer")
    assert all(s.parent == outer.id for s in recs[4]
               if s.name in ("octane.ingest", "octane.flow"))


def test_off_records_nothing_and_stamps_nothing(monkeypatch):
    """With the tracer off no span is recorded, no record_function range is
    entered and the stamp is never called."""
    from octane_tpu_torch.ops import stamp as stamp_mod

    def refuse(*args, **kwargs):
        raise AssertionError("called with the tracer off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(stamp_mod, "stamp", refuse)
    monkeypatch.setattr(stamp_mod, "launch", refuse)
    assert not profiling.enabled()
    profiling.reset()
    ops.reset_counters()
    with profiling.request(1):
        _pair(OFConfig(kiters=2))
    c = ops.counters()
    assert profiling.records() == {}
    assert c["stamp"] == (0, 0) and c["pcg_iterations_by_round"] == []


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_tracing_leaves_flows_and_winds_bit_identical(solver):
    cfg = OFConfig(kiters=2, solver=solver)
    off = _pair(cfg)
    profiling.enable()
    try:
        on = _pair(cfg)
    finally:
        profiling.disable()
        profiling.reset()
        fv.clear_program_cache()
    for name in ("u_pix", "v_pix", "u_wind", "v_wind", "u_raw", "v_raw"):
        assert torch.equal(getattr(off, name), getattr(on, name)), name


@pytest.mark.parametrize("route", ["eager", "program"])
@pytest.mark.parametrize("solver,tol", [("pcg", 1e-8), ("sor", 1e-8), ("pcg", 1e-1),
                                        ("sor", 10.0)])
def test_counts_by_round_sum_to_the_pair_count(tracer, route, solver, tol):
    """kiters x gnc_steps x liters rounds whose counts sum to the pair's,
    summed over pairs; at a tolerance that stops the relaxer early too."""
    cfg = OFConfig(kiters=3, solver=solver, cg_tol=tol)
    im1 = torch.from_numpy(fixture_counts(0, 0, 40, 56).astype(np.float32) / 40.0)[None]
    im2 = torch.from_numpy(fixture_counts(1.2, -0.6, 40, 56).astype(np.float32) / 40.0)[None]
    z = torch.zeros((40, 56))
    key = _key(solver)
    ops.reset_counters()
    totals = []
    for a, b in ((im1, im2), (im2, im1)):
        if route == "eager":
            fv._coarse_to_fine(a, b, z, z, cfg)
        else:
            fv.variational_flow(a, b, z, z, cfg)
        totals.append(ops.counters()[key])
    c = ops.counters()
    by_round = c[f"{key}_by_round"]
    assert len(by_round) == cfg.kiters * cfg.gnc_steps * cfg.liters
    assert sum(by_round) == sum(totals)
    budget = cfg.cgiters if solver == "pcg" else -(-cfg.cgiters // 8)
    assert min(by_round) >= 0 and max(by_round) <= 2 * budget     # two pairs
    work = "pcg_pass_a" if solver == "pcg" else "sor_pass"
    assert sum(by_round) == c[work][1]
    if tol > 1e-8:
        assert sum(totals) < 2 * len(by_round) * budget
    assert c["stamp"][1] == 2 * (2 + cfg.kiters + 2 * len(by_round))


def test_tracing_state_is_part_of_the_program_key():
    cfg = OFConfig(kiters=2)
    off = fv.program_key(cfg, (40, 56), 1, "cpu")
    profiling.enable()
    try:
        on = fv.program_key(cfg, (40, 56), 1, "cpu")
        prog = fv.flow_program(cfg, (40, 56), 1, "cpu")
    finally:
        profiling.disable()
    try:
        assert off != on and off[:-1] == on[:-1]
        assert fv.flow_program(cfg, (40, 56), 1, "cpu") is not prog
    finally:
        fv.clear_program_cache()


def test_stage_timer_records_land_in_records(tracer):
    t = StageTimer()
    with profiling.request(9):
        with t.stage("read"):
            with t.stage("inner", sync_on=torch.zeros(2)):
                pass
        with t.stage("read"):
            pass
    spans = profiling.records()[9]
    assert [s.name for s in spans] == ["octane.stage.read", "octane.stage.inner",
                                       "octane.stage.read"]
    assert spans[1].parent == spans[0].id
    assert t.records["read"] == [spans[0].seconds, spans[2].seconds]
    assert t.records["inner"] == [spans[1].seconds]


def test_stage_timer_times_with_the_tracer_off():
    profiling.reset()
    t = StageTimer()
    with pytest.raises(RuntimeError):
        with t.stage("fails"):
            raise RuntimeError("the stage's error")
    assert len(t.records["fails"]) == 1 and t.records["fails"][0] >= 0
    assert profiling.records() == {}


def test_trace_turns_the_tracer_on_for_its_block(tmp_path):
    profiling.reset()
    try:
        with trace(str(tmp_path)):
            assert profiling.enabled()
            with profiling.span("octane.test"):
                torch.ones(8).sum()
        assert not profiling.enabled()
        assert [s.name for s in profiling.records()[None]] == ["octane.test"]
        with open(tmp_path / os.listdir(tmp_path)[0]) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "octane.test" for e in events)
    finally:
        profiling.disable()
        profiling.reset()


def test_device_spans_close_a_level_where_the_next_begins():
    slots = [("octane.solve", (), False), ("octane.level", (0,), False),
             ("octane.sor", (0, 0, 0), False), ("octane.sor", (0, 0, 0), True),
             ("octane.level", (1,), False), ("octane.sor", (1, 0, 0), False),
             ("octane.sor", (1, 0, 0), True), ("octane.solve", (), True)]
    spans = profiling._device_spans(5, 2, [10, 11, 12, 20, 21, 22, 30, 31], slots)
    got = [(s.name, s.at, s.device_start, s.device_end) for s in spans]
    assert got == [("octane.solve", (), 10, 31), ("octane.level", (0,), 11, 21),
                   ("octane.sor", (0, 0, 0), 12, 20), ("octane.level", (1,), 21, 31),
                   ("octane.sor", (1, 0, 0), 22, 30)]
    by_id = {s.id: s for s in spans}
    assert spans[0].parent == 5 and all(s.request == 2 for s in spans)
    assert [by_id[s.parent].name for s in spans[1:]] == ["octane.solve", "octane.level",
                                                          "octane.solve", "octane.level"]


def test_totals_sum_each_side_by_name():
    spans = profiling._device_spans(None, 0, [10_000_000, 12_000_000, 15_000_000, 16_000_000],
                                    [("octane.solve", (), False), ("octane.pcg", (0, 0, 0), False),
                                     ("octane.pcg", (0, 0, 0), True), ("octane.solve", (), True)])
    host = profiling.Span("octane.flow")
    host.start, host.end = 0, 2_500_000
    got = profiling.totals(spans + [host, host])
    assert got == {"octane.solve": (0.0, 6.0), "octane.pcg": (0.0, 3.0),
                   "octane.flow": (5.0, 0.0)}


@pytest.mark.parametrize("solver, cgiters, budget", [("pcg", 30, 30), ("sor", 30, 4),
                                                     ("sor", 16, 2), ("sor", 5, 1)])
def test_capped_share_reads_the_relaxer_budget(solver, cgiters, budget):
    pairs = 3
    by_round = [budget * pairs, budget * pairs - 1, budget * pairs, 0]
    assert profiling.capped_share(by_round, solver, cgiters, pairs) == 0.5
    assert profiling.capped_share([], solver, cgiters, pairs) is None


def test_capped_share_agrees_with_the_counts_of_a_pair(tracer):
    """Every round of a pair with tol 0 runs its whole budget."""
    for solver in ("pcg", "sor"):
        cfg = OFConfig(kiters=2, solver=solver, cgiters=12, cg_tol=0.0)
        ops.reset_counters()
        _pair(cfg)
        by_round = ops.counters()[f"{_key(solver)}_by_round"]
        assert profiling.capped_share(by_round, solver, cfg.cgiters, 1) == 1.0


def test_enable_measures_no_clock_offset(monkeypatch):
    """The offset waits for the first records() that reads stamps."""
    def refuse(device):
        raise AssertionError("offset measured")

    monkeypatch.setattr(profiling, "_measure_offset", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        profiling.enable()
        with profiling.span("octane.test"):
            pass
        assert [s.name for s in profiling.records()[None]] == ["octane.test"]
    finally:
        profiling.disable()
        profiling.reset()


def _banded(cfg, h=48, w=40, v0=0.0):
    """The fixture pair's flow on a (4, 1) mesh of CPU bands, from a first
    guess of ``v0`` px down."""
    from octane_tpu_torch.parallel import make_mesh, sharded

    im1 = torch.from_numpy(fixture_counts(0, 0, h, w).astype(np.float32) / 40.0)[None]
    im2 = torch.from_numpy(fixture_counts(1.2, -0.6, h, w).astype(np.float32) / 40.0)[None]
    z = torch.zeros((h, w))
    return sharded.sharded_variational_flow(im1, im2, z, torch.full((h, w), v0), cfg,
                                            make_mesh((4, 1), [torch.device("cpu")] * 4))


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_banded_solve_stamps_levels_rounds_and_exchanges(tracer, solver):
    """A traced banded solve gives octane.solve, its levels, each round's
    relaxer and each round's exchange of ghost rows (octane.exchange, after
    the round's relaxer, in its level), on the card of its bands (the CPU
    here: no card index); the counts by round sum to the pair's."""
    cfg = OFConfig(kiters=2, solver=solver)
    ops.reset_counters()
    with profiling.request(0):
        _banded(cfg)
    spans = profiling.records()[0]
    by_id = {s.id: s for s in spans}
    names = {s.name for s in spans}
    assert names == {"octane.solve", "octane.level", f"octane.{solver}", "octane.exchange"}
    rounds = [(k, g, i) for k in range(2) for g in range(3) for i in range(3)]
    relax = [s for s in spans if s.name == f"octane.{solver}"]
    exchanges = [s for s in spans if s.name == "octane.exchange"]
    assert [s.at for s in relax] == rounds and [s.at for s in exchanges] == rounds
    for r, x in zip(relax, exchanges):
        assert by_id[x.parent].name == "octane.level" and by_id[x.parent].at == x.at[:1]
        assert r.device_end <= x.device_start <= x.device_end
        assert x.card is None and x.start is None
    c = ops.counters()
    key = _key(solver)
    assert sum(c[f"{key}_by_round"]) == c[key] > 0
    assert c["wide_warp_rounds"] == 0
    # stamps: the solve, the levels, and two a relaxer round and an exchange
    assert c["stamp"][1] == 2 + cfg.kiters + 4 * len(rounds)


def test_wide_warp_rounds_counts_the_pair_s_wide_bodies():
    """A 12-px first guess down, held by lambdac, with halo_warp 4 (reach 2)
    sends every round of both levels to the whole level; with halo_warp 64
    none.  The counter gives the last pair's, with the tracer off."""
    assert not profiling.enabled()
    ops.reset_counters()
    assert ops.counters()["wide_warp_rounds"] == 0
    cfg = OFConfig(kiters=2, solver="pcg", halo_warp=4, lambdac=0.5)
    narrow = _banded(cfg, v0=12.0)
    assert ops.counters()["wide_warp_rounds"] == 2 * 9
    wide = _banded(cfg.replace(halo_warp=64), v0=12.0)
    assert ops.counters()["wide_warp_rounds"] == 0
    assert all(torch.equal(a, b) for a, b in zip(narrow, wide))
    assert ops.counters()["stamp"] == (0, 0)
    fv.clear_program_cache()


def test_banded_tracing_is_part_of_the_program_key():
    from octane_tpu_torch.parallel import make_mesh, sharded

    cfg = OFConfig(kiters=2)
    mesh = make_mesh((4, 1), [torch.device("cpu")] * 4)
    off = sharded.sharded_program_key(cfg, (48, 40), 1, mesh)
    profiling.enable()
    try:
        on = sharded.sharded_program_key(cfg, (48, 40), 1, mesh)
    finally:
        profiling.disable()
    assert off != on and off[:-1] == on[:-1]
