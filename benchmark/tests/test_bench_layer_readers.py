"""The readers of the engine's and the seq arm's per-layer metrics on a
synthetic run: each reads its span or counters per call, and reads
nothing (None) where the program did not run them."""

import pytest

from benchmark.harness.cell import Run
from benchmark.harness.spec import reader

SPANS = {
    "facade.seq_prep_ms": "search.seq_prep",
    "engine.rows_in_ms": "engine.rows_in",
    "engine.counts_back_ms": "engine.counts_back",
    "engine.widen_ms": "engine.widen",
    "engine.seq_geometry_ms": "engine.seq_geometry",
}


def run(timers=None, counts=None, calls=10):
    return Run(loop="closed", setup_s=30.0, window_s=10.0, attempted=2560, answered=2560,
               latencies_s=[0.1] * 10, calls=calls, load_s=3.0, synth_s=9.0,
               memory_peak_bytes=0, timers=timers or {}, counts=counts or {})


@pytest.mark.parametrize("metric,span", sorted(SPANS.items()))
def test_span_readers_read_ms_a_call(metric, span):
    r = run({span: 0.25, "search.batch_counts": 1.0}, {span: 10, "search.batch_counts": 10})
    assert reader(metric)(r) == pytest.approx(25.0)
    others = {s: 0.5 for s in SPANS.values() if s != span}
    assert reader(metric)(run(others, dict.fromkeys(others, 10))) is None  # its span never ran
    assert reader(metric)(run({span: 0.25}, {span: 10}, calls=0)) is None


@pytest.mark.parametrize("launches,calls,refused,share", [
    (100, 100, 0, 0.0),  # every launch served its call
    (120, 100, 0, 100.0 * 20 / 120),  # 20 tight overflows, each launched again
    (110, 100, 5, 100.0 * 15 / 110),  # and 5 calls refused after launching
    (100, 103, 3, 0.0),  # 3 refused by the guard before any launch
])
def test_seq_waste_share_is_unused_launches_over_launches(launches, calls, refused, share):
    counts = {"engine.seq_launches": launches, "engine.seq_calls": calls,
              "engine.seq_refused": refused}
    assert reader("engine.seq_waste_share")(run(counts=counts)) == pytest.approx(share)


def test_seq_waste_share_reads_nothing_without_launches():
    read = reader("engine.seq_waste_share")
    assert read(run(counts={"search.batch_counts": 10})) is None  # a program without the counters
    assert read(run(counts={"engine.seq_calls": 4, "engine.seq_refused": 4,
                            "engine.seq_launches": 0})) is None
    assert read(run(counts={"engine.seq_launches": 2, "engine.seq_calls": 2})) == 0.0
