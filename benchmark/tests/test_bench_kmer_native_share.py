"""The reader of ``facade.kmer_native_share`` on a synthetic run: the
share of offered classic batches that the native pass took, and nothing
(None) where the program offered none or has no such counters."""

import pytest

from benchmark.harness.cell import Run
from benchmark.harness.spec import reader


def run(counts, calls=10):
    return Run(loop="closed", setup_s=30.0, window_s=10.0, attempted=2560, answered=2560,
               latencies_s=[0.1] * 10, calls=calls, load_s=3.0, synth_s=9.0,
               memory_peak_bytes=0, timers={}, counts=counts)


@pytest.mark.parametrize("offered,refused,share", [
    (249, 0, 100.0),  # every batch took the pass
    (200, 50, 75.0),  # a quarter sent back (N bases, scored batches)
    (4, 4, 0.0),  # every batch refused
    (7, None, 100.0),  # no refusal counted yet
])
def test_share_is_taken_over_offered(offered, refused, share):
    counts = {"search.kmer_native_offered": offered}
    if refused is not None:
        counts["search.kmer_native_refused"] = refused
    assert reader("facade.kmer_native_share")(run(counts)) == pytest.approx(share)


@pytest.mark.parametrize("counts", [
    {"search.batch_counts": 10},  # a program without the counters (the parent's)
    {"search.kmer_native_offered": 0, "search.kmer_native_refused": 0},
    {},
])
def test_share_reads_nothing_when_nothing_was_offered(counts):
    assert reader("facade.kmer_native_share")(run(counts)) is None
