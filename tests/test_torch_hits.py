"""Kernel M's plain version (``hits_compact``: a batch's counts
thresholded and compacted into a hits record) against a numpy threshold
query by query, the record's decode, the float64 ``min_kmers`` against
``math.ceil``, and the facade's hits route (the classic native route and
the seq arm on ``device="cpu"``) against its dense route and the JAX
package, with the routes that keep dense counts (staged columns, scored
batches, verified indexes) shown to keep them.  Every comparison is
exact."""

import math

import numpy as np
import pytest
import torch

import bigsi_tpu
import bigsi_tpu_torch
from bigsi_tpu import storage as ref_storage
from bigsi_tpu.kmers import seq_to_kmers
from bigsi_tpu_torch import metrics, storage
from bigsi_tpu_torch.index.device_engine import HITS_PER_QUERY, decode_hits, dense_hits
from bigsi_tpu_torch.ops import fused_lookup
from bigsi_tpu_torch.ops import lookup as plain

K = 31
THRESHOLDS = (1.0, 0.7, 1 / 3, 0.05)
SHAPES = [(1, 1), (1, 8192), (3, 31), (17, 33), (64, 100), (256, 8192), (300, 64)]


def reference_hits(counts, nks, threshold):
    """The facade's threshold before the hits: per query (colours, counts)."""
    out = []
    for row, nk in zip(counts, nks):
        if nk == 0:
            out.append(([], []))
            continue
        keep = np.flatnonzero(row >= math.ceil(int(nk) * threshold))
        out.append((keep.tolist(), row[keep].tolist()))
    return out


def per_query(hits):
    return [(hits.colours[lo:hi].tolist(), hits.found[lo:hi].tolist())
            for lo, hi in zip(hits.off[:-1].tolist(), hits.off[1:].tolist())]


def random_counts(rng, b, n, extra=0):
    """Counts int32[B, N + extra] and n_valid int32[B]: uniform counts up
    to each query's n_valid, a few samples at it exactly, some queries of
    no k-mer."""
    nks = rng.integers(0, 600, b).astype(np.int32)
    nks[rng.random(b) < 0.1] = 0
    counts = (rng.random((b, n + extra)) * (nks[:, None] + 1)).astype(np.int32)
    full = rng.random((b, n + extra)) < 0.02
    counts[full] = np.broadcast_to(nks[:, None], counts.shape)[full]
    return counts, nks


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("b,n", SHAPES)
def test_plain_kernel_matches_a_numpy_threshold(b, n, threshold):
    rng = np.random.default_rng(b * 10_007 + n)
    wide, nks = random_counts(rng, b, n, extra=5)
    counts = torch.from_numpy(wide)[:, :n]  # rows 5 samples apart
    rec = fused_lookup.hits_compact(counts, torch.from_numpy(nks), threshold, b * n)
    want = reference_hits(wide[:, :n], nks, threshold)
    assert int(rec[0]) == sum(len(c) for c, _ in want)
    hits = decode_hits(rec.numpy(), b, b * n)
    assert per_query(hits) == want
    assert hits.nks.tolist() == nks.tolist()
    assert per_query(dense_hits(wide[:, :n], nks, threshold)) == want


def test_a_record_past_its_room_keeps_the_total_and_n_valid():
    """min_kmers 0 makes every sample a hit: the total passes the room,
    the segments that fit are written in full and the others not."""
    rng = np.random.default_rng(3)
    counts, nks = random_counts(rng, 8, 100)
    nks[0] = 0
    cap = 8 * HITS_PER_QUERY
    rec = fused_lookup.hits_compact(torch.from_numpy(counts), torch.from_numpy(nks), 0.0, cap)
    assert int(rec[0]) == 7 * 100 > cap
    assert rec[1:9].tolist() == nks.tolist()
    hits = rec[1 + 16 : 1 + 24].tolist()
    assert hits == [0] + [100] * 7
    ent = rec[plain.hits_head(8):].view(cap, 2)
    assert ent[:500, 0].tolist() == list(range(100)) * 5  # the five segments that fit


def test_decode_reads_segments_in_any_order():
    """The kernel's blocks reserve their segments in no set order: a
    record whose segments are laid out backwards decodes the same."""
    rng = np.random.default_rng(5)
    counts, nks = random_counts(rng, 12, 40)
    b, cap = 12, 12 * 40
    rec = fused_lookup.hits_compact(torch.from_numpy(counts), torch.from_numpy(nks), 0.7,
                                    cap).numpy()
    want = per_query(decode_hits(rec, b, cap))
    start, cnt = rec[1 + b : 1 + 2 * b], rec[1 + 2 * b : 1 + 3 * b]
    head = plain.hits_head(b)
    ent = rec[head:].reshape(cap, 2)
    back = rec.copy()
    at = 0
    for q in reversed(range(b)):
        back[head + 2 * at : head + 2 * (at + cnt[q])] = ent[start[q] : start[q] + cnt[q]].ravel()
        back[1 + b + q] = at
        at += cnt[q]
    assert not np.array_equal(back, rec)
    assert per_query(decode_hits(back, b, cap)) == want


@pytest.mark.parametrize("threshold", THRESHOLDS + (0.9, 0.95, 0.8, 0.6, 0.3, 0.1, 0.0))
def test_min_kmers_is_math_ceil_in_float64(threshold):
    """nk 1-50,000: the plain kernel's and the host threshold's least
    count equal ``math.ceil(nk * threshold)``; a query whose counts are
    that least count less one and that count hits on the second alone."""
    nks = np.arange(1, 50_001, dtype=np.int32)
    want = np.array([math.ceil(int(nk) * threshold) for nk in nks], dtype=np.int64)
    got = plain.min_kmers(torch.from_numpy(nks), threshold)
    assert torch.equal(got, torch.from_numpy(want))
    counts = np.stack([want - 1, want], axis=1)
    for hits in (dense_hits(counts, nks, threshold),
                 decode_hits(fused_lookup.hits_compact(
                     torch.from_numpy(counts.astype(np.int32)), torch.from_numpy(nks),
                     threshold, 2 * nks.size).numpy(), nks.size, 2 * nks.size)):
        assert (np.diff(hits.off) == 1).all() and (hits.colours == 1).all()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    counts = torch.zeros((2, 8), dtype=torch.int32)
    nv = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_lookup.hits_compact(counts, nv, 1.5, 16)
    with pytest.raises(ValueError):
        fused_lookup.hits_compact(counts, nv, float("nan"), 16)
    with pytest.raises(TypeError):
        fused_lookup.hits_compact(counts.long(), nv, 1.0, 16)
    with pytest.raises(ValueError):
        fused_lookup.hits_compact(counts, nv[:1], 1.0, 16)


# -- the facade's routes ---------------------------------------------------


def random_seq(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def build(name, n_samples=10, glen=300, **extra):
    """A memory index of random genomes built by both packages from the
    same k-mers; -> (config, genomes, queries): exact, cut, mutated,
    unrelated, shorter than k and repeated queries."""
    rng = np.random.default_rng(len(name))
    config = {"storage-engine": "memory", "storage-config": {"filename": "hits-" + name},
              "k": K, "m": 1 << 16, "h": 3, **extra}
    for store in (ref_storage, storage):
        store.get_storage(config).delete_all()
    genomes = [random_seq(rng, glen) for _ in range(n_samples)]
    kmers = [list(seq_to_kmers(g, K)) for g in genomes]
    names = ["s%d" % i for i in range(n_samples)]
    bigsi_tpu.BIGSI.build(config, [bigsi_tpu.BIGSI.bloom(config, km) for km in kmers], names)
    bigsi_tpu_torch.BIGSI.build(dict(config, engine="numpy"),
                                [bigsi_tpu_torch.BIGSI.bloom(config, km) for km in kmers], names)
    snp = list(genomes[3][:200])
    snp[100] = "A" if snp[100] != "A" else "C"
    queries = [genomes[0], genomes[1][:120], "".join(snp), random_seq(rng, 150),
               genomes[4][10:60], genomes[5][:20], genomes[6][:K],
               genomes[7][:80] + genomes[7][:80]]
    return config, genomes, queries


ROUTES = {"classic": {}, "seq": {"layout": "minimizer", "tile-rows": 16, "minimizer-window": 19}}


def counted(port, queries, threshold, **kw):
    metrics.reset()
    got = port.search_batch(queries, threshold, **kw)
    c = metrics.snapshot()["counters"]
    return got, c.get("engine.hits_calls", 0), c.get("engine.hits_overflow", 0)


def routes(port, queries, threshold, monkeypatch):
    """-> (the hits route's answers, the dense route's), each batch's
    counters checked."""
    got, calls, over = counted(port, queries, threshold)
    assert (calls, over) == (1, 0), "the batch took the hits route"
    with monkeypatch.context() as mp:
        mp.setattr(bigsi_tpu_torch.BIGSI, "_hits_route", lambda self: False)
        dense, calls, _ = counted(port, queries, threshold)
    assert calls == 0
    return got, dense


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_hits_route_answers_as_the_dense_route_and_the_jax_package(route, monkeypatch):
    config, _, queries = build("route-" + route, **ROUTES[route])
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    ref = bigsi_tpu.BIGSI(config)
    for threshold in THRESHOLDS:
        got, dense = routes(port, queries, threshold, monkeypatch)
        assert got == dense == ref.search_batch(queries, threshold)
        assert got[0] and got[5] == [] and got[6]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_sample_a_hit_takes_the_dense_copy(route):
    """Threshold 0 on 80 samples: every sample of every query with a
    k-mer is a hit, past the record's room of 64 a query; the same call
    brings the dense counts back, and the answers stay the JAX
    package's.  A query shorter than k still answers []."""
    config, _, queries = build("all-" + route, n_samples=80, glen=200, **ROUTES[route])
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    got, calls, over = counted(port, queries, 0.0)
    assert (calls, over) == (1, 1)
    assert got == bigsi_tpu.BIGSI(config).search_batch(queries, 0.0)
    assert [len(r) for r in got] == [80] * 5 + [0, 80, 80]


def test_engine_hits_equal_its_dense_counts_thresholded():
    config, _, queries = build("engine")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    rng = np.random.default_rng(11)
    b, kmax, n = 6, 40, port.bitmatrix.num_cols
    idx = rng.integers(0, port.bitmatrix.num_rows, (b, kmax, 3))
    mask = np.arange(kmax) < rng.integers(0, kmax + 1, b)[:, None]
    nks = mask.sum(axis=1)
    dense = port.engine.counts_batch(idx, mask, n)
    for threshold in THRESHOLDS:
        got = port.engine.counts_batch(idx, mask, n, threshold, nks)
        want = dense_hits(dense, nks, threshold)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)
    empty = port.engine.counts_batch(idx[:, :0], mask[:, :0], n, 0.7, np.zeros(b, dtype=np.int64))
    assert empty.off.tolist() == [0] * (b + 1) and empty.nks.tolist() == [0] * b


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_deleted_samples_leave_hits_and_scored_batches(route):
    """A deleted sample's colour still counts on the card; the one
    builder drops it from the hits route's answers and from a scored
    batch's, as the JAX package does."""
    config, _, queries = build("deleted-" + route, **ROUTES[route])
    bigsi_tpu.BIGSI(config).delete_sample("s1")
    bigsi_tpu_torch.BIGSI(config, device="cpu").delete_sample("s1")
    port, ref = bigsi_tpu_torch.BIGSI(config, device="cpu"), bigsi_tpu.BIGSI(config)
    for threshold in (1.0, 0.7):
        got, calls, over = counted(port, queries, threshold)
        assert (calls, over) == (1, 0)
        assert got == ref.search_batch(queries, threshold)
        assert got[1] == [] and got[0]
    scored, calls, _ = counted(port, queries[:4], 0.7, score=True)
    assert calls == 0
    assert scored == ref.search_batch(queries[:4], 0.7, score=True) and scored[1] == []


def test_staged_columns_keep_the_dense_counts():
    config, genomes, queries = build("side")
    inserted = genomes[8][:150] + genomes[9][150:]
    kmers = list(seq_to_kmers(inserted, K))
    bigsi_tpu.BIGSI(config).insert(bigsi_tpu.BIGSI.bloom(config, kmers), "inserted")
    bigsi_tpu_torch.BIGSI(config, device="cpu").insert(
        bigsi_tpu_torch.BIGSI.bloom(config, kmers), "inserted")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    assert port.side is not None
    batch = queries + [inserted]
    for threshold in (1.0, 0.7):
        got, calls, _ = counted(port, batch, threshold)
        assert calls == 0
        assert got == bigsi_tpu.BIGSI(config).search_batch(batch, threshold)
        assert any(r["sample_name"] == "inserted" for r in got[-1])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_scored_batch_keeps_the_dense_counts(route):
    config, _, queries = build("scored-" + route, **ROUTES[route])
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    got, calls, _ = counted(port, queries[:4], 0.7, score=True)
    assert calls == 0
    assert got == bigsi_tpu.BIGSI(config).search_batch(queries[:4], 0.7, score=True)


def test_a_verified_index_keeps_the_dense_counts(tmp_path):
    rng = np.random.default_rng(8)
    genomes = [random_seq(rng, 400) for _ in range(6)]
    names = ["g%d" % i for i in range(6)]
    kmers = [list(seq_to_kmers(g, K)) for g in genomes]

    def config(who):
        return {"storage-engine": "bigsi-tpu", "storage-config": {"filename": str(tmp_path / who)},
                "k": K, "m": 200000, "h": 3, "screen": "minimizer"}

    ref_cfg, port_cfg = config("ref"), config("port")
    bigsi_tpu.BIGSI.build(ref_cfg, [bigsi_tpu.BIGSI.bloom(ref_cfg, k) for k in kmers], names)
    bigsi_tpu_torch.BIGSI.build(port_cfg, [bigsi_tpu_torch.BIGSI.bloom(port_cfg, k)
                                           for k in kmers], names, device="cpu")
    port = bigsi_tpu_torch.BIGSI(port_cfg, device="cpu")
    assert port.screen is not None
    queries = [g[40:260] for g in genomes] + [random_seq(rng, 200)]
    for threshold in (1.0, 0.7):
        got, calls, _ = counted(port, queries, threshold)
        assert calls == 0
        assert got == bigsi_tpu.BIGSI(ref_cfg).search_batch(queries, threshold)
        assert all(got[:6])
