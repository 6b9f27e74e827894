"""The seq serving arm of bigsi_tpu_torch (search_batch ->
DeviceEngine.counts_batch_seqs -> kernel H's plain version -> kernel E's,
engine on device="cpu") against the JAX package's seq arm (``engine:
tpu``, JAX on the CPU) and the numpy host engine: the same blooms built
by each package into its own memory store, the same queries, identical
result dicts and fall-backs (tolerance zero).  The
cases of tests/test_seq_batch_device.py and tests/test_long_queries.py,
on the port."""

import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import bigsi_tpu
import bigsi_tpu_torch
from bigsi_tpu import storage as ref_storage
from bigsi_tpu.index import device_engine as jax_engine
from bigsi_tpu.kmers import seq_to_kmers
from bigsi_tpu_torch import storage
from bigsi_tpu_torch.http.batcher import QueryBatcher
from bigsi_tpu_torch.http.server import make_server
from bigsi_tpu_torch.index import device_engine
from bigsi_tpu_torch.index.device_engine import DeviceEngine
from bigsi_tpu_torch.utils import profiling

K = 31
BASES = np.array(list("ACGT"))
# the two cols configs: the headline minimizer/16 (w = 19, r = 20) and the
# defaults, minimizer/32 (w = 11, r = 6)
CONFIGS = {"minimizer16": {"tile-rows": 16, "minimizer-window": 19},
           "minimizer32": {"tile-rows": 32}}


def random_seq(rng, n):
    return "".join(BASES[rng.integers(0, 4, n)])


def make_index(name, n=6, glen=600, layout="minimizer", **extra):
    """A memory index of n random genomes, minimizer/16 at w = 19 unless
    ``extra`` says otherwise; -> (config, genomes, rng)."""
    rng = np.random.default_rng(len(name))
    config = {
        "storage-engine": "memory", "storage-config": {"filename": "tseq-" + name},
        "k": K, "m": 1 << 18, "h": 3, "layout": layout,
        **(CONFIGS["minimizer16"] if layout == "minimizer" else {}), **extra,
    }
    genomes = [random_seq(rng, glen) for _ in range(n)]
    names = ["s%d" % i for i in range(n)]
    for store in (ref_storage, storage):
        store.get_storage(config).delete_all()
    bigsi_tpu.BIGSI.build(config, [bigsi_tpu.BIGSI.bloom(config, seq_to_kmers(g, K))
                                   for g in genomes], names)
    bigsi_tpu_torch.BIGSI.build(config, [bigsi_tpu_torch.BIGSI.bloom(config, seq_to_kmers(g, K))
                                         for g in genomes], names, device="cpu")
    return config, genomes, rng


def port_and_refs(config):
    """-> (the port on the CPU, the JAX package's tpu engine, the host engine)."""
    return (bigsi_tpu_torch.BIGSI(config, device="cpu"),
            bigsi_tpu.BIGSI(dict(config, engine="tpu")),
            bigsi_tpu.BIGSI(dict(config, engine="numpy")))


def spy(monkeypatch, obj, name):
    """Record (args, result) of every call of obj.name."""
    calls = []
    real = getattr(obj, name)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(obj, name, wrapper)
    return calls


def served(calls):
    return sum(out is not None for _, _, out in calls)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_seq_path_engages_and_matches_jax_and_host(monkeypatch, name):
    config, genomes, rng = make_index("engage-" + name, **CONFIGS[name])
    port, jax_ref, host = port_and_refs(config)
    assert port.engine.supports_seq_batch() and jax_ref.engine.supports_seq_batch()
    queries = [g[37:237] for g in genomes] + [random_seq(rng, 200) for _ in range(3)]
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    kmer_calls = spy(monkeypatch, DeviceEngine, "counts_batch_kmers")
    for threshold in (1.0, 0.7):
        got = port.search_batch(queries, threshold)
        assert got == jax_ref.search_batch(queries, threshold)
        assert got == host.search_batch(queries, threshold)
        assert all(got[:6]), "the genomes' substrings hit"
    assert len(seq_calls) == 2 and served(seq_calls) == 2 and not kmer_calls


def test_counts_batch_seqs_matches_the_jax_program():
    """The module-level H -> E step against the JAX package's one
    program, on the same cols bits and padded bytes."""
    config, genomes, rng = make_index("program")
    port, jax_ref, _ = port_and_refs(config)
    seqs = np.frombuffer("".join(g[:256] for g in genomes).encode(), np.uint8).reshape(6, 256)
    seqs = np.concatenate([seqs, np.full((2, 256), ord("A"), np.uint8)])
    lens = np.array([256, 200, 31, 30, 0, 256, 0, 0], dtype=np.int32)
    kw = dict(k=K, s=13, num_tiles=(1 << 18) // 16, h=3, tile_rows=16, r=20, u_cap=40,
              seed=device_engine.MINIMIZER_SEED)
    got = device_engine._counts_batch_seqs(
        port.engine.cols, torch.from_numpy(seqs), torch.from_numpy(lens), **kw)
    want = jax_engine._counts_batch_seqs(jax_ref.engine.cols, seqs, lens, **kw)
    n = port.num_samples
    np.testing.assert_array_equal(got[0][:, :n].numpy(), np.asarray(want[0])[:, :n])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]) and bool(want[2])


def test_counts_batch_seqs_spans_split_the_engine_call():
    """The engine's spans inside counts_batch_seqs: the copies in, kernels
    H and E up to the ok read, the counts back; each served batch times
    each once, inside the facade's engine span, and the results stay the
    JAX engine's."""
    from bigsi_tpu_torch import metrics

    config, genomes, rng = make_index("spans")
    port, jax_ref, _ = port_and_refs(config)
    queries = [g[11:311] for g in genomes] + [random_seq(rng, 300) for _ in range(2)]
    metrics.reset()
    assert port.search_batch(queries, 0.7) == jax_ref.search_batch(queries, 0.7)
    timers = metrics.snapshot()["timers"]
    spans = ("engine.seq_in", "engine.seq_kernels", "engine.seq_out")
    assert [timers[s]["count"] for s in spans] == [1, 1, 1]
    inside = sum(timers[s]["total_s"] for s in spans)
    assert inside <= timers["search.batch_counts"]["total_s"]


@pytest.fixture
def span_log(monkeypatch):
    """The port's span log, on and empty; off again after."""
    monkeypatch.setattr(profiling, "_SPANS_ON", False)
    profiling.spans.clear()
    profiling.spans.start()
    yield profiling.spans
    profiling.spans.clear()


class Deltas:
    """The port's registry over a block: counters and timer counts."""

    def __enter__(self):
        self.before = bigsi_tpu_torch.metrics.snapshot()
        return self

    def __exit__(self, *exc):
        after = bigsi_tpu_torch.metrics.snapshot()
        self.counters = {k: v - self.before["counters"].get(k, 0)
                         for k, v in after["counters"].items()}
        self.timers = {k: v["count"] - self.before["timers"].get(k, {}).get("count", 0)
                       for k, v in after["timers"].items()}


def one_call(records):
    """-> (the search.batch root, {name: [records]}) of a log holding one
    call, every record of which carries the root's call id."""
    roots = [r for r in records if r.name == "search.batch"]
    assert len(roots) == 1 and roots[0].parent is None
    root = roots[0]
    assert all(r.call == root.id for r in records)
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
    return root, by_name


def test_classic_batch_spans_nest_under_one_call(span_log):
    """search.batch holds search.batch_counts, which holds the engine's
    rows in, counts back and widening, all of one call."""
    config, genomes, _ = make_index("classic-spans", n=4, glen=300, layout="classic")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    queries = [g[10:200] for g in genomes]
    span_log.clear()  # the build's and the load's spans
    with Deltas() as d:
        got = port.search_batch(queries, 0.7)
    assert got == bigsi_tpu.BIGSI(dict(config, engine="numpy")).search_batch(queries, 0.7)
    root, by = one_call(span_log.records())
    (counts,) = by["search.batch_counts"]
    assert counts.parent == root.id
    for name in ("engine.rows_in", "engine.counts_back", "engine.widen"):
        (r,) = by[name]
        assert r.parent == counts.id and counts.start_ns <= r.start_ns <= r.end_ns <= counts.end_ns
    assert by["engine.rows_in"][0].end_ns <= by["engine.counts_back"][0].start_ns
    assert by["engine.counts_back"][0].end_ns <= by["engine.widen"][0].start_ns
    assert d.timers["search.batch"] == d.timers["engine.rows_in"] == 1


def test_seq_batch_spans_and_counters(span_log):
    """A minimizer/16 scheme-3 batch: the facade's prep and the engine's
    bucketing as spans of the call, and the seq arm's counters."""
    config, genomes, rng = make_index("seq-spans")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    queries = [g[5:305] for g in genomes] + [random_seq(rng, 250)]
    span_log.clear()  # the build's and the load's spans
    with Deltas() as d:
        got = port.search_batch(queries, 0.7)
    assert got == bigsi_tpu.BIGSI(dict(config, engine="numpy")).search_batch(queries, 0.7)
    root, by = one_call(span_log.records())
    (prep,), (counts,) = by["search.seq_prep"], by["search.batch_counts"]
    assert prep.parent == counts.parent == root.id and prep.end_ns <= counts.start_ns
    for name in ("engine.seq_geometry", "engine.seq_in", "engine.seq_kernels", "engine.seq_out"):
        (r,) = by[name]
        assert r.parent == counts.id
    (out,) = by["engine.seq_out"]
    for name in ("engine.counts_back", "engine.widen"):
        (r,) = by[name]
        assert r.parent == out.id
    assert {k: d.counters.get(k, 0) for k in (
        "search.seq_offered", "search.seq_gate_refused", "engine.seq_calls",
        "engine.seq_launches", "engine.seq_refused")} == {
        "search.seq_offered": 1, "search.seq_gate_refused": 0, "engine.seq_calls": 1,
        "engine.seq_launches": 1, "engine.seq_refused": 0}
    assert d.timers["search.seq_prep"] == d.timers["engine.seq_geometry"] == 1


def test_an_n_base_counts_a_gate_refusal():
    config, genomes, _ = make_index("gate-count")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    qs = [genomes[0][:150], genomes[1][:80] + "N" + genomes[1][81:150]]
    with Deltas() as d:
        got = port.search_batch(qs, 0.7)
    assert got == bigsi_tpu.BIGSI(dict(config, engine="numpy")).search_batch(qs, 0.7)
    assert d.counters["search.seq_offered"] == d.counters["search.seq_gate_refused"] == 1
    assert d.counters.get("engine.seq_calls", 0) == 0 and d.timers["search.seq_prep"] == 1


def test_a_tight_overflow_counts_two_launches_for_one_call(monkeypatch):
    """The tight budget overflows and the safe one serves: two launches,
    one call, none refused (one launch of two wasted)."""
    config, genomes, _ = make_index("overflow-count")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    monkeypatch.setattr(DeviceEngine, "_seq_u_tight", staticmethod(lambda nk, w: 2))
    qs = [g[:200] for g in genomes[:3]]
    with Deltas() as d:
        got = port.search_batch(qs, 0.7)
    assert got == bigsi_tpu.BIGSI(dict(config, engine="numpy")).search_batch(qs, 0.7)
    c = d.counters
    assert (c["engine.seq_calls"], c["engine.seq_launches"], c.get("engine.seq_refused", 0)) == (
        1, 2, 0)
    assert c["engine.seq_launches"] > c["engine.seq_calls"] and d.timers["engine.seq_kernels"] == 2


def test_a_refused_seq_call_is_counted(monkeypatch):
    """Both budgets overflow: the call launches twice, returns None and the
    k-mer path answers."""
    config, genomes, _ = make_index("refused-count")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    monkeypatch.setattr(DeviceEngine, "_seq_u_tight", staticmethod(lambda nk, w: 2))
    monkeypatch.setattr(DeviceEngine, "_seq_u_cap", staticmethod(lambda nk, w: 4))
    qs = [g[:200] for g in genomes[:3]]
    with Deltas() as d:
        got = port.search_batch(qs, 0.7)
    assert got == bigsi_tpu.BIGSI(dict(config, engine="numpy")).search_batch(qs, 0.7)
    c = d.counters
    assert (c["engine.seq_calls"], c["engine.seq_launches"], c["engine.seq_refused"]) == (1, 2, 1)


def test_batcher_times_each_requests_wait_under_its_dispatch(span_log):
    """serve.queue_wait once a request; in the log each is a child of the
    serve.dispatch span that served it, and shares that span's call."""
    config, genomes, _ = make_index("batcher-wait")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    batcher = QueryBatcher(port, max_wait_ms=200)
    qs = [g[30:230] for g in genomes]
    span_log.clear()  # the build's and the load's spans
    try:
        with Deltas() as d:
            with ThreadPoolExecutor(max_workers=len(qs)) as pool:
                outs = list(pool.map(lambda q: batcher.search(q, 0.7), qs))
    finally:
        batcher.close()
    assert outs == [port.search(q, 0.7) for q in qs]
    assert d.timers["serve.queue_wait"] == len(qs)
    recs = span_log.records()
    dispatch = {r.id: r for r in recs if r.name == "serve.dispatch"}
    waits = [r for r in recs if r.name == "serve.queue_wait"]
    assert len(waits) == len(qs) and len(dispatch) == d.timers["serve.dispatch"] >= 1
    for w in waits:
        assert w.parent in dispatch and w.call == dispatch[w.parent].call
        assert w.start_ns <= w.end_ns <= dispatch[w.parent].end_ns
    for r in recs:
        if r.name == "search.batch":
            assert r.parent in dispatch


def test_seq_path_duplicate_kmers_distinct_semantics(monkeypatch):
    """A query holding repeated k-mers reports num_kmers = the distinct
    count (the reference's set(kmers)), as the host path does."""
    config, genomes, _ = make_index("dups")
    port, jax_ref, host = port_and_refs(config)
    dup_query = genomes[0][:100] + genomes[0][:100]
    batch = [dup_query, genomes[1][:120]]
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    got = port.search_batch(batch, 0.5)
    assert served(seq_calls) == 1
    assert got == jax_ref.search_batch(batch, 0.5) == host.search_batch(batch, 0.5)
    assert got[0], "self-query must hit"
    assert got[0][0]["num_kmers"] == len(set(seq_to_kmers(dup_query, K))) < len(dup_query) - K + 1


def test_seq_path_falls_back_on_non_acgt(monkeypatch):
    config, genomes, _ = make_index("non-acgt")
    port, jax_ref, host = port_and_refs(config)
    qs = [genomes[0][:150], genomes[1][:80] + "N" + genomes[1][81:150]]
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    kmer_calls = spy(monkeypatch, DeviceEngine, "counts_batch_kmers")
    got = port.search_batch(qs, 0.7)
    assert not seq_calls and len(kmer_calls) == 1, "a non-ACGT batch takes the k-mer path"
    assert got == jax_ref.search_batch(qs, 0.7) == host.search_batch(qs, 0.7)


def test_seq_path_overflow_falls_back(monkeypatch):
    """A tiny entry budget: kernel H reports overflow, counts_batch_seqs
    returns None and the k-mer path answers the batch."""
    config, genomes, _ = make_index("overflow")
    port, _, host = port_and_refs(config)
    monkeypatch.setattr(DeviceEngine, "_seq_u_cap", staticmethod(lambda nk, w: 2))
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    kmer_calls = spy(monkeypatch, DeviceEngine, "counts_batch_kmers")
    qs = [g[:200] for g in genomes[:3]]
    got = port.search_batch(qs, 0.7)
    assert len(seq_calls) == 1 and served(seq_calls) == 0 and len(kmer_calls) == 1
    assert got == host.search_batch(qs, 0.7)
    assert all(got)


def test_staged_insert_keeps_the_host_paths(monkeypatch):
    config, genomes, _ = make_index("insert")
    kmers = list(seq_to_kmers(genomes[2][::-1], K))
    bigsi_tpu.BIGSI(config).insert(bigsi_tpu.BIGSI.bloom(config, kmers), "inserted")
    bigsi_tpu_torch.BIGSI(config, device="cpu").insert(
        bigsi_tpu_torch.BIGSI.bloom(config, kmers), "inserted")
    port, _, host = port_and_refs(config)
    assert port.side is not None and port.engine.supports_seq_batch()
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    qs = [genomes[2][::-1][:200], genomes[0][:150]]
    got = port.search_batch(qs, 0.7)
    assert got == host.search_batch(qs, 0.7) and not seq_calls
    assert any(r["sample_name"] == "inserted" for r in got[0])


def test_scored_batch_takes_the_kmer_path(monkeypatch):
    config, genomes, _ = make_index("score")
    port, jax_ref, _ = port_and_refs(config)
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    kmer_calls = spy(monkeypatch, DeviceEngine, "counts_batch_kmers")
    qs = [genomes[0][:150], genomes[3][10:200]]
    assert port.search_batch(qs, 0.7, score=True) == jax_ref.search_batch(qs, 0.7, score=True)
    assert not seq_calls and len(kmer_calls) == 1


def test_seq_path_short_and_empty_queries(monkeypatch):
    config, genomes, _ = make_index("short")
    port, jax_ref, host = port_and_refs(config)
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    qs = [genomes[0][:150], "ACGT", genomes[2][:35], genomes[3][:31], ""]
    got = port.search_batch(qs, 1.0)
    assert served(seq_calls) == 1
    assert got == jax_ref.search_batch(qs, 1.0) == host.search_batch(qs, 1.0)
    assert got[1] == [] and got[4] == []  # shorter than k
    assert got[0] and got[0][0]["sample_name"] == "s0"


def test_tight_budget_escalation_matches_the_jax_engine(monkeypatch):
    """A tight first try that overflows: the engine escalates to the safe
    budget in the same call, keeps it for the length bucket, and its
    escalation state equals the JAX engine's after the same calls."""
    config, genomes, _ = make_index("escalate", **{"minimizer-window": 3})
    port, jax_ref, host = port_and_refs(config)
    for cls in (DeviceEngine, jax_engine.DeviceEngine):
        monkeypatch.setattr(cls, "_seq_u_tight", staticmethod(lambda nk, w: 8))
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    qs = [g[:180] for g in genomes[:3]]
    for threshold in (0.7, 1.0):
        got = port.search_batch(qs, threshold)
        assert got == jax_ref.search_batch(qs, threshold) == host.search_batch(qs, threshold)
    assert served(seq_calls) == 2
    assert port.engine._seq_cap_esc == jax_ref.engine._seq_cap_esc == {192: 63}


def test_escalation_decays_per_length_bucket(monkeypatch):
    """After SEQ_CAP_DECAY clean big-budget batches the tight budget is
    retried, and only the overflowing length bucket is pessimised; the
    budgets tried and the state match the JAX engine's call for call."""
    config, genomes, _ = make_index("decay", **{"minimizer-window": 3})
    port, jax_ref, _ = port_and_refs(config)
    caps = {}
    for mod, eng in ((device_engine, port.engine), (jax_engine, jax_ref.engine)):
        monkeypatch.setattr(eng, "SEQ_CAP_DECAY", 2, raising=False)
        monkeypatch.setattr(type(eng), "_seq_u_tight", staticmethod(lambda nk, w: 8))
        seen = caps[mod.__name__] = []
        real = mod._counts_batch_seqs

        def wrapper(*a, _seen=seen, _real=real, **kw):
            _seen.append(kw["u_cap"])
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "_counts_batch_seqs", wrapper)

    def step(q):
        seqs = np.frombuffer(q.encode(), dtype=np.uint8)[None, :]
        lens = np.asarray([len(q)], dtype=np.int32)
        outs = [eng.counts_batch_seqs(seqs, lens, K, 3, port.num_samples)
                for eng in (port.engine, jax_ref.engine)]
        assert outs[0] is not None and outs[1] is not None
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
        assert caps[device_engine.__name__] == caps[jax_engine.__name__]
        assert port.engine._seq_cap_esc == jax_ref.engine._seq_cap_esc

    q = genomes[0][:180]
    step(q)  # overflow: tight, then big
    port_caps = caps[device_engine.__name__]
    assert len(port_caps) == 2 and port_caps[0] < port_caps[1]
    big = port_caps[1]
    step(q)  # escalated: big only, 2 -> 1
    step(q)  # 1 -> 0
    assert port_caps[2:] == [big, big]
    step(q)  # decayed: the tight budget is tried again
    assert port_caps[4] < big
    assert 192 in port.engine._seq_cap_esc and 128 not in port.engine._seq_cap_esc
    for seen in caps.values():
        del seen[:]
    step(genomes[1][:100])  # its own bucket (lb 128) starts tight
    assert port_caps[0] < big


def test_seq_path_long_queries(monkeypatch):
    """2-4 kb queries stay on the seq path, with a repeat about 3 kb
    after its first occurrence deduplicated."""
    config, genomes, _ = make_index("long", n=3, glen=4200)
    port, jax_ref, host = port_and_refs(config)
    queries = [genomes[0][:2200], genomes[1][:4000], genomes[2][:3000] + genomes[2][:200]]
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    got = port.search_batch(queries, 0.7)
    assert len(seq_calls) == 1 and served(seq_calls) == 1
    assert got == jax_ref.search_batch(queries, 0.7) == host.search_batch(queries, 0.7)
    assert got[2] and got[2][0]["num_kmers"] < len(queries[2]) - K + 1


def test_mixed_length_batch_splits_stragglers(monkeypatch):
    """12 short queries and an 8 kb straggler: the facade's up-front split
    keeps the short ones on the seq path; the straggler takes the host
    paths."""
    config, genomes, _ = make_index("mixed", n=3, glen=12_000)
    port, _, host = port_and_refs(config)
    queries = [genomes[i % 3][j * 97 : j * 97 + 300] for i, j in enumerate(range(12))]
    queries.append(genomes[2][:8_000])
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    got = port.search_batch(queries, 0.9)
    assert served(seq_calls) >= 1
    assert got == host.search_batch(queries, 0.9)
    assert got[-1] and got[-1][0]["sample_name"] == "s2"


def test_mixed_length_batch_over_the_guard_serves_the_short_majority(monkeypatch):
    """20 queries of 1 kb and 4 of 4 kb pass the facade's up-front split
    but not the guard as one batch (32 x 4,002^2 > 2^28): the facade's
    second split serves the short ones on the seq path, then the long
    ones, a batch small enough for the guard, on the seq path too."""
    config, genomes, _ = make_index("guard-split", n=3, glen=4100)
    port, _, host = port_and_refs(config)
    queries = [genomes[i % 3][i * 40 : i * 40 + 1000] for i in range(20)]
    queries += [genomes[i % 3][:3990] for i in range(4)]
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    got = port.search_batch(queries, 0.9)
    assert [out is not None for _, _, out in seq_calls] == [False, True, True]
    assert [args[1].shape[0] for args, _, _ in seq_calls] == [24, 20, 4]
    assert got == host.search_batch(queries, 0.9)


@pytest.mark.parametrize("b,l", [(256, 1024), (8, 4096), (256, 2048), (8, 4096 + 64),
                                 (3, 10), (9, 542), (1, 31), (17, 1100)])
def test_geometry_guard_matches_the_jax_engine(b, l):
    seqs = np.full((b, l), ord("C"), dtype=np.uint8)
    lens = np.full(b, l, dtype=np.int32)
    got = device_engine.seq_batch_geometry(seqs, lens, K, 19)
    want = jax_engine.seq_batch_geometry(seqs, lens, K, 19)
    assert (got is None) == (want is None)
    if got is not None:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (got is None) == ((b, l) in ((256, 2048), (8, 4096 + 64)))


@pytest.mark.parametrize("nk", [1, 96, 512, 546, 994, 4066])
@pytest.mark.parametrize("window", [3, 11, 19])
def test_entry_budgets_match_the_jax_engine(nk, window):
    assert DeviceEngine._seq_u_cap(nk, window) == jax_engine.DeviceEngine._seq_u_cap(nk, window)
    assert DeviceEngine._seq_u_tight(nk, window) == \
        jax_engine.DeviceEngine._seq_u_tight(nk, window)


def test_coalesced_http_requests_reach_counts_batch_seqs(monkeypatch):
    config, genomes, _ = make_index("http")
    host = bigsi_tpu.BIGSI(dict(config, engine="numpy"))
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    server = make_server(dict(config, serve_batch_wait_ms=30), host="127.0.0.1", port=0,
                         device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://127.0.0.1:%d/search" % server.server_address[1]

        def hit(i):
            q = genomes[i % len(genomes)][20:220]
            with urllib.request.urlopen("%s?seq=%s&threshold=0.7" % (base, q), timeout=60) as r:
                return q, json.loads(r.read())

        with ThreadPoolExecutor(max_workers=8) as pool:
            outs = list(pool.map(hit, range(8)))
        for q, out in outs:
            assert out["results"] == host.search(q, 0.7)
        assert {out["results"][0]["sample_name"] for _, out in outs} == {
            "s%d" % i for i in range(6)}
        assert served(seq_calls) >= 1 and served(seq_calls) == len(seq_calls)
    finally:
        server.shutdown()
        server.invalidate()
        server.server_close()
        thread.join(timeout=30)


@pytest.mark.parametrize("layout,extra", [
    ("minimizer", {"tile-rows": 64}),
    ("minimizer", {"tile-rows": 16, "minimizer-window": 19, "slot-scheme": 2}),
    ("classic", {}),
    ("blocked", {"tile-rows": 32}),
])
def test_other_layouts_keep_supports_seq_batch_false(layout, extra):
    config, genomes, _ = make_index("off-%s-%s" % (layout, sorted(extra.items())), n=3,
                                    glen=300, layout=layout, **extra)
    port, jax_ref, host = port_and_refs(config)
    assert not port.engine.supports_seq_batch()
    assert not jax_ref.engine.supports_seq_batch()
    qs = [g[:200] for g in genomes]
    assert port.search_batch(qs, 0.7) == host.search_batch(qs, 0.7)
