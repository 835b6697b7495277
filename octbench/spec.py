"""A cell of ``BENCHMARK.json`` with the files it names: its configuration,
traffic, limits and metric readers, all found by name under octbench/."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def traffic(name: str) -> dict:
    """The traffic mix ``traffic/<name>.json``.  A mix that names a
    ``base`` is that mix with its own keys laid over it, so mixes that
    differ in a key or two share one copy of the generator's parameters."""
    mix = load_json(os.path.join(HERE, "traffic", f"{name}.json"))
    if "base" in mix:
        over = {k: v for k, v in mix.items() if k != "base"}
        mix = traffic(mix["base"])
        mix.update(over)
    return mix


def metric_reader(name: str):
    """The ``read(run)`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"octbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]      # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def refuse(name: str, config: dict, mix: dict):
    """Exit with the reason where the harness cannot judge ``config`` under
    ``mix``: a hybrid configuration under a warm-start traffic would run
    the port's patch-match from the previous pair's flow, which is
    sector-scale only (``FIRST_GUESS_MAX_PIXELS``), and the reference has
    no patch-match from a guess."""
    if config["settings"].get("algorithm") == "hybrid" and mix["warm_start"]:
        raise SystemExit(f"octbench: {name}: a hybrid configuration under a warm-start "
                         f"traffic: the port would start patch-match from the previous "
                         f"pair's flow, which it runs at sector scale only, and the "
                         f"reference's patch-match starts from a zero guess")


def cell(name: str, bench: dict = None) -> Cell:
    bench = bench or benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"octbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(sorted(by_name))})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config, mix = load_json(os.path.join(ROOT, cfg_entry["file"])), traffic(w["traffic"])
    refuse(name, config, mix)
    return Cell(
        name=name, chips=w["chips"], config=config, traffic=mix,
        limits=load_json(os.path.join(HERE, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])
