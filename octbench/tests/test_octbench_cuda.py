"""The benchmark's command on the card (marked ``cuda``; skips without
one): a short run of each cell prints one JSON result line whose
metrics are the cell's."""

import json
import subprocess
import sys

import pytest
import torch

from octbench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_command_prints_a_result(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, "-m", "octbench.run", "--workload", name,
                          "--seed", str(2 ** 33 + 1), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in spec.cell(name).end_to_end}
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == spec.cell(name).chips


def test_without_a_card_the_command_refuses(monkeypatch):
    from octbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "meso-sor-seq", "--seed", "1", "--seconds", "1"]) == 2
