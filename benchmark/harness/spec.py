"""The benchmark's description, read by name: ``BENCHMARK.json`` at the
root of the checkout, ``configs/<config>.json`` (the file that
``BENCHMARK.json`` names), ``traffic/<mix>.json`` and
``metrics/<metric>.py``.  Adding a cell, a mix or a metric adds files
and entries; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


@dataclasses.dataclass
class Spec:
    workload: dict
    config: dict
    traffic: dict
    metrics: list  # the BENCHMARK.json entries this cell reports, in order

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def reports(entry: dict, workload: str, end_to_end: list) -> bool:
    """Whether a cell reports a metric: the cells its ``workloads`` list, or
    else (a per-layer metric) every cell that reports its ``moves``."""
    if "workloads" in entry:
        return workload in entry["workloads"]
    moves = entry.get("moves")
    if moves is None:
        return True
    return any(e["name"] == moves and reports(e, workload, []) for e in end_to_end)


def load(workload: str, trace: bool) -> Spec:
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError("no workload %r in BENCHMARK.json" % workload)
    cell = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / (cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = bench["end_to_end"]
    entries = bench["per_layer"] if trace else e2e
    return Spec(cell, config, traffic, [e for e in entries if reports(e, workload, e2e)])


def reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / (name + ".py")
    mod_spec = importlib.util.spec_from_file_location("benchmark_metric_" + name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark (a work or reference module)."""
    return importlib.import_module("benchmark.%s.%s" % (kind, name))
