"""octane_tpu_torch.utils.profiling: StageTimer as octane_tpu's (mirrors
tests/test_sequence.py::TestProfiling; the same records give the same
summary() and report() as octane_tpu.utils.profiling.StageTimer, exactly)
and trace() writing a Chrome trace on the CPU."""

import json
import os

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
