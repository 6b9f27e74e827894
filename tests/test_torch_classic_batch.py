"""The facade's classic batch route: one native pass from the batch's
bytes to its padded int32 row ids (``BIGSI._classic_batch_native``),
against bigsi_tpu's ``search_batch`` (JAX on the CPU; the numpy host
engine) on each of the port's engines that run on the CPU, the batches
it sends back to the per-query route (an N, a lowercase base, a bytes
entry, scoring), its counters, and staged inserts on both routes.  Every
comparison is of whole result dicts, exactly."""

import threading

import numpy as np
import pytest

import bigsi_tpu
import bigsi_tpu_torch
from bigsi_tpu import storage as ref_storage
from bigsi_tpu_torch import metrics, storage
from bigsi_tpu_torch.index.device_engine import DeviceEngine
from bigsi_tpu_torch.index.host_engine import HostEngine
from bigsi_tpu_torch.kmers import seq_to_kmers
from bigsi_tpu_torch.parallel.sharding import MeshEngine

K = 31
N_SAMPLES = 10
ENGINES = {"device": ({}, DeviceEngine), "numpy": ({"engine": "numpy"}, HostEngine),
           "mesh": ({"engine": "mesh", "mesh": [2, 2, 2]}, MeshEngine)}


def random_seq(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def mutate(rng, seq, snps):
    out = list(seq)
    for pos in rng.choice(len(seq), size=snps, replace=False):
        out[pos] = "ACGT"[("ACGT".index(out[pos]) + 1) % 4]
    return "".join(out)


def build(name, extra=None):
    """A classic memory index of random genomes built by both packages
    from the same k-mers; -> (config, genomes, queries) with exact,
    near-miss, unrelated, short and repeated queries."""
    rng = np.random.default_rng(len(name))
    config = {"storage-engine": "memory", "storage-config": {"filename": name},
              "k": K, "m": 8192, "h": 3, **(extra or {})}
    for store in (ref_storage, storage):
        store.get_storage(config).delete_all()
    genomes = [random_seq(rng, 300) for _ in range(N_SAMPLES)]
    kmers = [list(seq_to_kmers(g, K)) for g in genomes]
    names = ["s%d" % i for i in range(N_SAMPLES)]
    bigsi_tpu.BIGSI.build(config, [bigsi_tpu.BIGSI.bloom(config, km) for km in kmers], names)
    bigsi_tpu_torch.BIGSI.build(dict(config, engine="numpy"),
                                [bigsi_tpu_torch.BIGSI.bloom(config, km) for km in kmers], names)
    queries = [
        genomes[0], genomes[1][:120], mutate(rng, genomes[2][:200], 2),
        mutate(rng, genomes[3], 6), random_seq(rng, 150), genomes[4][10:60],
        genomes[5][:20],  # shorter than k: no k-mers
        genomes[6][:K],  # exactly one k-mer
        genomes[7][:80] + genomes[7][:80],  # repeated k-mers
    ]
    return config, genomes, queries


def counters():
    snap = metrics.snapshot()["counters"]
    return (snap.get("search.kmer_native_offered", 0),
            snap.get("search.kmer_native_refused", 0))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_native_route_matches_the_jax_package(engine):
    extra, cls = ENGINES[engine]
    config, _, queries = build("cb-" + engine)
    port = bigsi_tpu_torch.BIGSI(dict(config, **extra), device="cpu")
    assert isinstance(port.engine, cls)
    ref = bigsi_tpu.BIGSI(config)
    for threshold in (1.0, 0.7):
        metrics.reset()
        got = port.search_batch(queries, threshold)
        assert counters() == (1, 0), "the batch took the native route"
        assert got == ref.search_batch(queries, threshold)
        assert got == [port.search(q, threshold) for q in queries]
        assert any(got), "the queries hit"


NOT_ACGT = {
    "n_base": lambda q: q[:40] + "N" + q[41:],
    "lowercase": lambda q: q[:60].lower() + q[60:],
}


@pytest.mark.parametrize("kind", sorted(NOT_ACGT))
@pytest.mark.parametrize("engine", ["device", "numpy"])
def test_other_bytes_take_the_per_query_route(engine, kind):
    """A batch with a base outside ACGT is sent back to the per-query
    route, and answers as the JAX package and the native route would."""
    extra, _ = ENGINES[engine]
    config, _, queries = build("cb-bytes-" + engine)
    port = bigsi_tpu_torch.BIGSI(dict(config, **extra), device="cpu")
    ref = bigsi_tpu.BIGSI(config)
    odd = list(queries)
    odd[3] = NOT_ACGT[kind](queries[3])
    for threshold in (1.0, 0.7):
        metrics.reset()
        got = port.search_batch(odd, threshold)
        assert counters() == (1, 1)
        assert metrics.snapshot()["timers"]["search.hash"]["count"] == 1
        assert got == ref.search_batch(odd, threshold)
        metrics.reset()
        clean = port.search_batch(queries, threshold)
        assert counters() == (1, 0)
        assert [g for i, g in enumerate(got) if i != 3] == [
            c for i, c in enumerate(clean) if i != 3]


def test_a_bytes_entry_takes_the_per_query_route():
    """A bytes entry fails the gate's encode and is refused; the per-query
    route then raises as the JAX package does."""
    config, _, queries = build("cb-bytes-entry")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    batch = [queries[0], queries[1].encode("ascii")]
    metrics.reset()
    with pytest.raises(AttributeError):
        port.search_batch(batch)
    assert counters() == (1, 1)
    with pytest.raises(AttributeError):
        bigsi_tpu.BIGSI(config).search_batch(batch)


def test_scored_batch_takes_the_per_query_route():
    config, _, queries = build("cb-scored")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    metrics.reset()
    got = port.search_batch(queries[:4], 0.7, score=True)
    assert counters() == (1, 1)
    assert got == bigsi_tpu.BIGSI(config).search_batch(queries[:4], 0.7, score=True)


def test_staged_inserts_answer_alike_on_both_routes(monkeypatch):
    """Staged columns (the side shard) are counted from the native
    route's int32 ids as from the per-query route's int64 ones."""
    config, genomes, queries = build("cb-insert")
    inserted = genomes[8][:150] + genomes[9][150:]
    kmers = list(seq_to_kmers(inserted, K))
    bigsi_tpu.BIGSI(config).insert(bigsi_tpu.BIGSI.bloom(config, kmers), "inserted")
    bigsi_tpu_torch.BIGSI(config, device="cpu").insert(
        bigsi_tpu_torch.BIGSI.bloom(config, kmers), "inserted")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    assert port.side is not None
    batch = queries + [inserted, genomes[8][100:250]]
    ref = bigsi_tpu.BIGSI(config)
    for threshold in (1.0, 0.7):
        metrics.reset()
        native_route = port.search_batch(batch, threshold)
        assert counters() == (1, 0)
        with monkeypatch.context() as mp:
            mp.setattr(bigsi_tpu_torch.native, "available", lambda: False)
            metrics.reset()
            per_query = port.search_batch(batch, threshold)
            assert counters() == (1, 1)
        assert native_route == per_query == ref.search_batch(batch, threshold)
        assert any(r["sample_name"] == "inserted" for r in native_route[-2])


def test_each_thread_reuses_its_id_buffer():
    """The native pass writes into one buffer per calling thread, grown to
    the largest batch: a smaller batch after a larger one reuses it, and
    the stale ids past its own do not reach its answers."""
    config, genomes, queries = build("cb-buffer")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    ref = bigsi_tpu.BIGSI(config)
    large = queries + [genomes[9] * 3]
    assert port.search_batch(large, 0.7) == ref.search_batch(large, 0.7)
    buf = port._classic_ids.buf
    for batch in (queries[:4], queries[4:], large):
        assert port.search_batch(batch, 0.7) == ref.search_batch(batch, 0.7)
        assert port._classic_ids.buf is buf
    other = []
    thread = threading.Thread(target=lambda: other.append(port.search_batch(queries, 1.0)))
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert other == [ref.search_batch(queries, 1.0)]
    assert port._classic_ids.buf is buf  # the other thread took its own
