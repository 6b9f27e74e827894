"""``BENCHMARK.json`` against the rules its readers hold it to: names,
units and texts in their alphabets and lengths, the keys each entry may
have, bounds, and every configuration, mix and metric found by name."""

import json
import re

from bench_support import CELLS

from benchmark.harness import spec as specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = specs.load_benchmark()


def text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(text(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text(c["source"]) and text(c["why"])
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        with open(specs.ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert all(NAME.match(k) and k in body for k in c["reduced"])
        assert (specs.HERE / "reference" / (body["reference"] + ".py")).is_file()
        assert (specs.HERE / "work" / (body["work"] + ".py")).is_file()
    cells = BENCH["workloads"]
    assert tuple(w["name"] for w in cells) == CELLS
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and text(w["why"])
        assert w["config"] in configs and w["chips"] == 1
        assert (specs.HERE / "traffic" / (w["traffic"] + ".json")).is_file()
    assert {w["config"] for w in cells} == set(configs)


def test_metrics():
    e2e, layers = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layers]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layer_names = {}
    for m in layers:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text(m["layer"]) and m["moves"] in {e["name"] for e in e2e}
        layer_names.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        for w in m.get("workloads", []):  # each cell listed reports what the metric moves
            assert any(e["name"] == m["moves"] and specs.reports(e, w, e2e) for e in e2e)
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (specs.HERE / "metrics" / (m["name"] + ".py")).is_file()
    assert all(len(v) == 1 for v in layer_names.values())  # one layer name a layer
    for w in cells:  # setup_s, another end-to-end metric and a per-layer one in every cell
        assert len(specs.load(w, False).metrics) >= 2 and specs.load(w, True).metrics
