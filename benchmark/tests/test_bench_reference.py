"""The plain reference against the program's host engine (``engine:
numpy``) on the benchmark's own tiny index: the same answers, unscored
and scored, at both thresholds, for both layouts; its frozen hashing
against the program's rows."""

import numpy as np
import pytest
from bench_support import tiny

from benchmark.harness import traffic
from benchmark.harness.index import synthesize
from benchmark.reference.search import Reference

CONFIGS = {"classic-n8192.genes": "classic", "minimizer16-n8192.scored": "minimizer"}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def built(request):
    spec = tiny(request.param)
    index = synthesize(spec.config, 2**31 + 5, "cpu")
    return spec, index


def test_rows_equal_the_programs(built):
    from bigsi_tpu_torch import BIGSI
    from bigsi_tpu_torch.kmers import seq_to_kmer_matrix

    spec, index = built
    port = BIGSI(dict(index.port_config, engine="numpy"))
    ref = Reference(index.words, index.names, spec.config["index"], spec.config["reference"])
    for seq in (index.sources[0][:500], index.sources[1][3000:3031]):
        _, rows = ref.layout.position_rows(seq, spec.config["index"])
        assert np.array_equal(rows, port.kmer_matrix_to_row_idx(seq_to_kmer_matrix(seq, 31)))


@pytest.mark.parametrize("score", [False, True])
def test_answers_equal_the_programs(built, score):
    from bigsi_tpu_torch import BIGSI

    spec, index = built
    port = BIGSI(dict(index.port_config, engine="numpy"))
    ref = Reference(index.words, index.names, spec.config["index"], spec.config["reference"])
    pool = traffic.closed_pool(dict(spec.traffic, batch=8, pool_batches=1), index.sources, 9)
    batch = pool.batches[0]
    hits = 0
    for threshold in (1.0, 0.7):
        got = port.search_batch(batch, threshold, score)
        want = [ref.answer(q, threshold, score) for q in batch]
        assert got == want
        hits += sum(map(len, want))
    assert hits > 0  # planted samples answer


def test_control_breaks_the_answers(built):
    spec, index = built
    cfg = spec.config["index"]
    ref = Reference(index.words, index.names, cfg, spec.config["reference"])
    control = Reference(index.words, index.names, cfg, spec.config["reference"], cfg["h"] - 1)
    pool = traffic.closed_pool(dict(spec.traffic, batch=8, pool_batches=1), index.sources, 9)
    assert any(ref.answer(q, 0.7) != control.answer(q, 0.7) for q in pool.batches[0])
