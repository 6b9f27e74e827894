"""The check that decides ``correct`` catches a broken timed path: the
whole run (set-up, window, check) on the CPU with the program's engine
broken underneath, once for each fault a one-chip search can have: a
call that hands back the previous call's state, half of the batch left
out, and an answer altered where it is produced.  Its control, the
reference with a guarantee broken, fails the same comparison."""

import time

import numpy as np
import pytest
from bench_support import CELLS, KEPT, tiny

from benchmark.control import control_numbers
from benchmark.harness.cell import execute
from benchmark.harness.index import synthesize

# the engine's batch calls (counts int64[B, N] first in what they return)
# and its single-query reduce (counts int32[N], exact words int32[W])
ENGINE_CALLS = ("counts_batch", "counts_batch_seqs", "counts_batch_kmers", "_single")


def stale(real):
    last = {}

    def call(self, *args):
        out = real(self, *args)
        prev, last["out"] = last.get("out", out), out
        return prev
    return call


def half(real):
    calls = {"n": 0}

    def call(self, *args):
        out = real(self, *args)
        counts = out[0] if isinstance(out, tuple) else out
        if counts.ndim == 2:
            counts[len(counts) // 2:] = 0
        else:  # one query: every other one left out
            calls["n"] += 1
            if calls["n"] % 2:
                for part in out:
                    part[:] = 0
        return out
    return call


def altered(real):
    def call(self, *args):
        out = real(self, *args)
        counts = out[0] if isinstance(out, tuple) else out
        if counts.ndim == 2:
            counts[np.arange(len(counts)), counts.argmax(axis=1)] += 1
        else:
            counts[counts.argmax()] += 1
            out[1][0] ^= 1  # sample 0's bit of the exact answer
        return out
    return call


def quiet(*args, **kwargs):
    pass


def run(workload):
    return execute(tiny(workload), 2**31 + 11, 1.0, False, "cpu", time.perf_counter(), log=quiet)


@pytest.mark.parametrize("workload", CELLS + KEPT)
def test_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["wrong_answers"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("workload", CELLS + KEPT)
@pytest.mark.parametrize("fault", [stale, half, altered])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    from bigsi_tpu_torch.index.device_engine import DeviceEngine

    for name in ENGINE_CALLS:
        monkeypatch.setattr(DeviceEngine, name, fault(getattr(DeviceEngine, name)))
    out = run(workload)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS + KEPT)
def test_control_is_not_correct(workload):
    spec = tiny(workload)
    index = synthesize(spec.config, 2**31 + 13, "cpu")
    numbers = control_numbers(spec, index, 2**31 + 13)
    assert numbers["wrong_answers"] > 0
