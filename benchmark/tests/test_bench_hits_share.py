"""The reader of ``engine.hits_share`` on a synthetic run: the share of
the engine's hits calls that did not take the dense copy, and nothing
(None) where the program made no such call or has no such counters."""

import pytest

from benchmark.harness.cell import Run
from benchmark.harness.spec import reader


def run(counts, calls=10):
    return Run(loop="closed", setup_s=30.0, window_s=10.0, attempted=2560, answered=2560,
               latencies_s=[0.1] * 10, calls=calls, load_s=3.0, synth_s=9.0,
               memory_peak_bytes=0, timers={}, counts=counts)


@pytest.mark.parametrize("calls,overflow,share", [
    (3_900, 0, 100.0),  # every batch's hits fit the record
    (200, 50, 75.0),  # a quarter took the dense copy
    (4, 4, 0.0),  # every batch overflowed
    (7, None, 100.0),  # no overflow counted yet
])
def test_share_is_taken_over_calls(calls, overflow, share):
    counts = {"engine.hits_calls": calls}
    if overflow is not None:
        counts["engine.hits_overflow"] = overflow
    assert reader("engine.hits_share")(run(counts)) == pytest.approx(share)


@pytest.mark.parametrize("counts", [
    {"engine.seq_calls": 10},  # a program without the counters (the parent's)
    {"engine.hits_calls": 0, "engine.hits_overflow": 0},
    {},
])
def test_share_reads_nothing_without_calls(counts):
    assert reader("engine.hits_share")(run(counts)) is None
