"""The frozen bytes-of-work functions against brute-force counts on a
tiny index: distinct rows (classic) or tiles (minimizer) over the
batch, the queries' bases, the counts out, and for a scored batch the
distinct sectors of the answers' words, the ids and positions read and
the strings written."""

import math

import pytest
from bench_support import tiny

from benchmark.harness import traffic
from benchmark.harness.index import synthesize
from benchmark.harness.spec import module
from benchmark.reference.search import Reference


def brute(spec, index, batch, threshold, score):
    from bigsi_tpu_torch import BIGSI
    from bigsi_tpu_torch.kmers import seq_to_kmer_matrix

    port = BIGSI(dict(index.port_config, engine="numpy"))
    cfg = spec.config["index"]
    n = len(index.names)
    w = -(-n // 32)
    tiled = cfg["layout"] == "minimizer"
    unit = n * cfg.get("tile-rows", 32) // 8 if tiled else w * 4
    picked, sectors, moved = set(), set(), 0
    for seq in batch:
        mat = seq_to_kmer_matrix(seq, cfg["k"])
        distinct = {bytes(r) for r in mat}
        rows = port.kmer_matrix_to_row_idx(mat)
        for r in rows.tolist():
            picked.update([r[0] // cfg["tile-rows"]] if tiled else r)
        if not score:
            continue
        answers = port.search_batch([seq, seq], threshold)[0]
        if not answers:
            continue
        moved += 4 * len(distinct) * cfg["h"] + 4 * len(mat) + len(answers) * len(mat)
        for a in answers:
            c = index.names.index(a["sample_name"])
            for r in rows.tolist():
                if tiled:
                    sectors.add((r[0] // cfg["tile-rows"] * n + c) * (cfg["tile-rows"] // 8) // 32)
                else:
                    sectors.update((x * w + c // 32) * 4 // 32 for x in r)
    total = len(picked) * unit + sum(map(len, batch)) + len(batch) * n * 4
    return total + (moved + 32 * len(sectors) if score else 0)


@pytest.mark.parametrize("workload", ["classic-n8192.genes", "minimizer16-n8192.scored"])
@pytest.mark.parametrize("score", [False, True])
def test_batch_bytes_equal_a_brute_count(workload, score):
    spec = tiny(workload)
    index = synthesize(spec.config, 77, "cpu")
    batch = traffic.closed_pool(dict(spec.traffic, batch=4, pool_batches=1), index.sources,
                                5).batches[0]
    ref = Reference(index.words, index.names, spec.config["index"], spec.config["reference"])
    cfg = dict(spec.config["index"], samples=len(index.names))
    got = module("work", spec.config["work"]).batch_bytes(cfg, ref, batch, 0.7, score)
    assert got == brute(spec, index, batch, 0.7, score)
    assert math.isfinite(got) and got > 0
