"""The generator: the same seed gives the same traffic, and every seed
the same work (lengths, kinds, thresholds, gaps) in another order."""

import numpy as np
import pytest
from bench_support import tiny

from benchmark.harness import traffic
from benchmark.harness.index import mutate, random_seq

SOURCES = [random_seq(np.random.default_rng(i), 10_000).tobytes().decode() for i in range(4)]
SEEDS = (1, 2**31 + 7)


@pytest.mark.parametrize("workload", ["classic-n8192.genes", "minimizer16-n8192.scored"])
def test_closed_pool_repeats_by_seed(workload):
    mix = tiny(workload).traffic
    a, b = (traffic.closed_pool(mix, SOURCES, SEEDS[1]) for _ in range(2))
    assert a.batches == b.batches and a.thresholds == b.thresholds
    c = traffic.closed_pool(mix, SOURCES, SEEDS[0])
    assert c.batches != a.batches
    for x, y in zip(a.batches, c.batches):  # the same lengths, in another order
        assert sorted(map(len, x)) == sorted(map(len, y))


def test_open_schedule_repeats_by_seed():
    mix = tiny("minimizer16-n8192.http").traffic
    a, b = (traffic.open_schedule(mix, SOURCES, SEEDS[1], 5.0) for _ in range(2))
    assert a.queries == b.queries
    assert np.array_equal(a.offsets, b.offsets) and np.array_equal(a.thresholds, b.thresholds)
    c = traffic.open_schedule(mix, SOURCES, SEEDS[0], 5.0)
    assert sorted(map(len, a.queries)) == sorted(map(len, c.queries))
    assert sorted(np.diff(a.offsets)) != sorted(np.diff(c.offsets))  # permuted, then cut at 5 s
    assert abs(len(a.offsets) - len(c.offsets)) <= 0.1 * len(a.offsets)
    assert set(np.unique(a.thresholds)) == {0.7, 1.0}


def test_lengths_are_the_mixes_quantiles():
    q = traffic.quantile_lengths(256, 300, 3000)
    assert q.min() >= 300 and q.max() <= 3000
    assert abs(np.median(q) - 949) <= 10 and abs(q.mean() - 1173) <= 10
    s = traffic.quantile_lengths(256, 300, 1000)
    assert s.max() <= 1000 and abs(s.mean() - 581) <= 5


def test_queries_are_acgt_with_their_snps():
    rng = np.random.default_rng(3)
    mix = tiny("classic-n8192.genes").traffic
    queries = traffic.make_queries(mix, SOURCES, 64, rng)
    assert all(set(q) <= set("ACGT") for q in queries)
    src = np.frombuffer(SOURCES[0].encode(), dtype=np.uint8)
    out = mutate(rng, src[:1000], 0.03)
    assert int((out != src[:1000]).sum()) == 30
