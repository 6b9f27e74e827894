"""``benchmark/run.py`` as a check calls it: with no card it fails
and prints no result; beside no program it fails; on the card each
cell's short run is correct and reports its metrics."""

import json
import shutil
import subprocess
import sys

import pytest
from bench_support import CELLS

from benchmark.harness import spec as specs

RUN = [sys.executable, "benchmark/run.py", "--seed", str(2**31 + 3), "--seconds", "2"]


def run(cwd, workload, trace=0, timeout=600):
    return subprocess.run(RUN + ["--workload", workload, "--trace", str(trace)], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def no_result(proc):
    lines = proc.stdout.splitlines()
    return proc.returncode != 0 and not any(line.startswith("{") for line in lines)


def test_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert no_result(run(specs.ROOT, CELLS[0]))


def test_fails_beside_no_program(tmp_path):
    shutil.copy(specs.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(specs.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run(tmp_path, CELLS[0])
    assert no_result(proc) and "not in" in proc.stderr


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, workload, trace):
    proc = run(specs.ROOT, workload, trace)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    want = {m["name"] for m in specs.load(workload, bool(trace)).metrics}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"
