"""bigsi_tpu_torch.BIGSI (engine on device="cpu", so the kernels' plain
versions) against bigsi_tpu.BIGSI on the JAX device engine (JAX on the
CPU) and on the numpy host engine: the same blooms built by each package
into its own memory store, the same queries, identical result dicts
(tolerance zero)."""

import threading

import numpy as np
import pytest
import torch

import bigsi_tpu
import bigsi_tpu_torch
from bigsi_tpu import storage as ref_storage
from bigsi_tpu.index.host_engine import HostEngine as RefHostEngine
from bigsi_tpu.kmers import seq_to_kmers
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix as RefMatrix
from bigsi_tpu_torch import native, storage
from bigsi_tpu_torch.index.device_engine import DeviceEngine
from bigsi_tpu_torch.index.host_engine import HostEngine
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix

K = 31
N_SAMPLES = 12


def random_seq(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def mutate(rng, seq, snps):
    out = list(seq)
    for pos in rng.choice(len(seq), size=snps, replace=False):
        out[pos] = "ACGT"[("ACGT".index(out[pos]) + 1) % 4]
    return "".join(out)


def build_both(config, kmer_lists, names):
    """Each package blooms the same k-mers and builds its own memory
    index (the two stores are separate); the blooms must be equal."""
    for store in (ref_storage, storage):
        store.get_storage(config).delete_all()
    ref = [bigsi_tpu.BIGSI.bloom(config, kmers) for kmers in kmer_lists]
    port = [bigsi_tpu_torch.BIGSI.bloom(config, kmers) for kmers in kmer_lists]
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(r, p)
    bigsi_tpu.BIGSI.build(config, ref, names)
    bigsi_tpu_torch.BIGSI.build(config, port, names, device="cpu")


def insert_both(config, kmers, name):
    bigsi_tpu.BIGSI(config).insert(bigsi_tpu.BIGSI.bloom(config, kmers), name)
    bigsi_tpu_torch.BIGSI(config, device="cpu").insert(
        bigsi_tpu_torch.BIGSI.bloom(config, kmers), name)


def build_index(name, layout, tile_rows=32, **extra):
    """A memory index of N_SAMPLES random genomes; -> (config, queries)
    with exact, near-miss and unrelated queries of ragged lengths."""
    rng = np.random.default_rng(len(name))
    config = {
        "storage-engine": "memory", "storage-config": {"filename": name},
        "k": K, "m": 8192, "h": 3, "layout": layout, **extra,
    }
    if layout != "classic":
        config["tile-rows"] = tile_rows
    genomes = [random_seq(rng, 300) for _ in range(N_SAMPLES)]
    build_both(config, [list(seq_to_kmers(g, K)) for g in genomes],
               ["s%d" % i for i in range(N_SAMPLES)])
    queries = [
        genomes[0], genomes[1][:120], mutate(rng, genomes[2][:200], 2),
        mutate(rng, genomes[3], 6), random_seq(rng, 150), genomes[4][10:60],
        genomes[5][:20],  # shorter than k: no k-mers
    ]
    return config, queries


LAYOUTS = {"classic": ("classic", 32), "minimizer32": ("minimizer", 32)}


@pytest.mark.parametrize("reference", ["tpu", "numpy"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_matches_jax_package(layout, reference):
    config, queries = build_index("te-" + layout, *LAYOUTS[layout])
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    assert isinstance(port.engine, DeviceEngine)
    ref = bigsi_tpu.BIGSI(dict(config, engine=reference))
    for threshold in (1.0, 0.7):
        for q in queries:
            assert port.search(q, threshold) == ref.search(q, threshold)
        got = port.search_batch(queries, threshold)
        assert got == ref.search_batch(queries, threshold)
        assert any(got), "the queries hit"
    for q in queries[:3]:
        assert port.search(q, 0.7, score=True) == ref.search(q, 0.7, score=True)
    assert port.search_batch(queries[:3], 0.7, score=True) == ref.search_batch(
        queries[:3], 0.7, score=True)


@pytest.mark.parametrize("layout,tile_rows", [("minimizer", 64), ("blocked", 16)])
def test_port_tiled_layouts_match_host_engine(layout, tile_rows):
    """tile_rows 64 included: the port's 64-bit slot masks keep rows
    32-63, so it is held to the host engine (the JAX device engine
    drops those rows)."""
    config, queries = build_index("te-%s-%d" % (layout, tile_rows), layout, tile_rows)
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    host = bigsi_tpu.BIGSI(config)
    for threshold in (1.0, 0.7):
        assert port.search_batch(queries, threshold) == host.search_batch(queries, threshold)
        assert [port.search(q, threshold) for q in queries] == [
            host.search(q, threshold) for q in queries]


def test_staged_insert_matches_host_engine():
    """A staged insert lives in the side shard on the host; the facade
    appends its columns to the engine's counts."""
    config, queries = build_index("te-insert", "minimizer")
    insert_both(config, list(seq_to_kmers(queries[3], K)), "inserted")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    host = bigsi_tpu.BIGSI(config)
    assert port.side is not None
    for threshold in (1.0, 0.7):
        got = port.search_batch(queries, threshold)
        assert got == host.search_batch(queries, threshold)
        assert port.search(queries[3], threshold) == host.search(queries[3], threshold)
    assert any(r["sample_name"] == "inserted" for r in got[3])


def test_lookup_matches_host_engine():
    config, queries = build_index("te-lookup", "classic")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    host = bigsi_tpu.BIGSI(config)
    kmers = list(seq_to_kmers(queries[1], K))[:9]
    got, want = port.lookup(kmers), host.lookup(kmers)
    assert got.keys() == want.keys()
    for kmer in kmers:
        np.testing.assert_array_equal(got[kmer], want[kmer])


def test_engine_numpy_keeps_the_host_engine():
    config, queries = build_index("te-numpy", "classic")
    port = bigsi_tpu_torch.BIGSI(dict(config, engine="numpy"))
    assert isinstance(port.engine, HostEngine)
    assert port.search(queries[0]) == bigsi_tpu.BIGSI(config).search(queries[0])


def test_jax_engines_are_refused():
    config, _ = build_index("te-refuse", "classic")
    with pytest.raises(ValueError, match="not part of bigsi_tpu_torch"):
        bigsi_tpu_torch.BIGSI(dict(config, engine="tpu"), device="cpu")


def test_screened_index_raises(tmp_path):
    config = {
        "storage-engine": "bigsi-tpu", "storage-config": {"filename": str(tmp_path / "v")},
        "k": K, "m": 20000, "h": 3, "screen": "minimizer",
    }
    seqs = [random_seq(np.random.default_rng(i), 200) for i in range(3)]
    blooms = [bigsi_tpu_torch.BIGSI.bloom(config, seq_to_kmers(s, K)) for s in seqs]
    assert bigsi_tpu_torch.BIGSI.build(config, blooms, ["a", "b", "c"]) is None
    for engine in (None, "numpy"):
        cfg = config if engine is None else dict(config, engine=engine)
        with pytest.raises(NotImplementedError, match="screened"):
            bigsi_tpu_torch.BIGSI(cfg, device="cpu")


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_engine_without_cuda_raises(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    matrix = BitSliceMatrix(np.zeros((64, 8), dtype=np.uint32), 10)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        DeviceEngine(matrix, device=device)


def test_engine_counts_batch_matches_host_engine():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, size=(100, 2), dtype=np.uint32)
    matrix = BitSliceMatrix(words, 50)
    row_idx = rng.integers(0, 100, size=(5, 9, 3))
    mask = rng.random((5, 9)) < 0.7
    mask[2] = False
    got = DeviceEngine(matrix, device="cpu").counts_batch(row_idx, mask, 50)
    assert got.dtype == np.int64
    want = RefHostEngine(RefMatrix(words, 50)).counts_batch(row_idx, mask, 50)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(HostEngine(matrix).counts_batch(row_idx, mask, 50), want)
    with pytest.raises(IndexError):
        DeviceEngine(matrix, device="cpu").counts_batch(row_idx + 100, mask, 50)


# -- the minimizer grouped serving arm ----------------------------------------


def spy(monkeypatch, obj, name):
    """Count the calls of obj.name (a class attribute: every instance)."""
    calls = []
    real = getattr(obj, name)

    def wrapper(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(obj, name, wrapper)
    return calls


# the JAX package's headline serving config (tests/test_layout.py:399):
# minimizer at tile_rows 16, w = 19, slot scheme 3, r = 20
HEADLINE = {"minimizer-window": 19}


@pytest.mark.parametrize("reference", ["tpu", "numpy"])
def test_headline_cols_engine_matches_jax_package(monkeypatch, reference):
    config, queries = build_index("te-headline", "minimizer", 16, **HEADLINE)
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    engine = port.engine
    assert engine.run_len == 20 and engine.slot_scheme == 3
    assert engine.cols is not None and engine.cols.dtype == torch.int16 and engine.words is None
    assert engine.supports_kmer_batch() and engine.supports_seq_batch()
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    kmer_calls = spy(monkeypatch, DeviceEngine, "counts_batch_kmers")
    batch_calls = spy(monkeypatch, DeviceEngine, "counts_batch")
    ref = bigsi_tpu.BIGSI(dict(config, engine=reference))
    for threshold in (1.0, 0.7):
        for q in queries:
            assert port.search(q, threshold) == ref.search(q, threshold)
        got = port.search_batch(queries, threshold)
        assert got == ref.search_batch(queries, threshold)
        assert any(got), "the queries hit"
    for q in queries[:3]:
        assert port.search(q, 0.7, score=True) == ref.search(q, 0.7, score=True)
    assert port.search_batch(queries[:3], 0.7, score=True) == ref.search_batch(
        queries[:3], 0.7, score=True)
    # the seq arm serves both unscored batches; the scored one takes the
    # k-mer path
    assert len(seq_calls) == 2 and len(kmer_calls) == 1 and not batch_calls


def test_default_minimizer_engine_serves_counts_batch_kmers(monkeypatch):
    """The default minimizer config (tile_rows 32, w = 11, slot scheme 3)
    has int32 cols: the seq arm serves its unscored batches, and with the
    seq arm off, the k-mer path does."""
    config, queries = build_index("te-default-cols", "minimizer", 32)
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    engine = port.engine
    assert engine.run_len == 6 and engine.slot_scheme == 3
    assert engine.cols is not None and engine.cols.dtype == torch.int32 and engine.words is None
    assert engine.supports_kmer_batch() and engine.supports_seq_batch()
    seq_calls = spy(monkeypatch, DeviceEngine, "counts_batch_seqs")
    kmer_calls = spy(monkeypatch, DeviceEngine, "counts_batch_kmers")
    batch_calls = spy(monkeypatch, DeviceEngine, "counts_batch")
    host = bigsi_tpu.BIGSI(config)
    for threshold in (1.0, 0.7):
        assert port.search_batch(queries, threshold) == host.search_batch(queries, threshold)
    assert len(seq_calls) == 2 and not kmer_calls and not batch_calls
    monkeypatch.setattr(engine, "supports_seq_batch", lambda: False)
    for threshold in (1.0, 0.7):
        assert port.search_batch(queries, threshold) == host.search_batch(queries, threshold)
    assert len(seq_calls) == 2 and len(kmer_calls) == 2 and not batch_calls


def test_kmer_streams_cross_at_32_bits_and_widen_on_the_device():
    from bigsi_tpu_torch.index.device_engine import kmer_streams_to_device

    utile = np.array([[3, 1]], dtype=np.int32)
    gmask = np.array([[[1 << 31 | 5, 0], [0xFFFFFFFF, 1 << 16]]], dtype=np.uint32)
    n_valid = np.array([3], dtype=np.int32)
    got_u, got_g, got_n = kmer_streams_to_device((utile, gmask, n_valid), torch.device("cpu"))
    assert (got_u.dtype, got_g.dtype, got_n.dtype) == (torch.int32, torch.int64, torch.int32)
    np.testing.assert_array_equal(got_u.numpy(), utile)
    np.testing.assert_array_equal(got_g.numpy(), gmask.astype(np.int64))
    np.testing.assert_array_equal(got_n.numpy(), n_valid)


def test_slot_scheme_2_takes_the_v2_native_prep(monkeypatch):
    config, queries = build_index("te-scheme2", "minimizer", 16, **{"slot-scheme": 2}, **HEADLINE)
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    assert port.engine.slot_scheme == 2 and port.engine.supports_kmer_batch()
    v2 = spy(monkeypatch, native, "prep_minimizer_v2")
    v3 = spy(monkeypatch, native, "prep_minimizer_v3")
    host = bigsi_tpu.BIGSI(config)
    for threshold in (1.0, 0.7):
        assert port.search_batch(queries, threshold) == host.search_batch(queries, threshold)
    assert len(v2) == 2 and not v3


def test_query_with_an_n_base_matches_host_engine():
    """tests/test_scheme_v3.py:169: every k-mer of the query overlaps an N."""
    config = {
        "storage-engine": "memory", "storage-config": {"filename": "te-nbase"},
        "k": K, "m": 65536, "h": 3, "layout": "minimizer", "tile-rows": 16,
    }
    rng = np.random.default_rng(9)
    base = random_seq(rng, 150)
    seq_n = base[:60] + "N" + base[61:]
    build_both(config, [[s[i : i + K] for i in range(len(s) - K + 1)] for s in (seq_n, base)],
               ["with_n", "plain"])
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    host = bigsi_tpu.BIGSI(config)
    query = seq_n[40:90]
    want = host.search(query, 1.0)
    assert {r["sample_name"] for r in want} >= {"with_n"}
    assert port.search(query, 1.0) == want
    batch = [query, base[:80], query[:40]]
    for threshold in (1.0, 0.7):
        assert port.search_batch(batch, threshold) == host.search_batch(batch, threshold)


def test_counts_batch_kmers_in_chunks_overlaps_the_next_prep(monkeypatch):
    """With chunks of 4, each chunk's kernel dispatch waits until the next
    chunk's native prep has started on the worker thread: it would wait
    forever if the prep were submitted only after the dispatch."""
    config, queries = build_index("te-chunks", "minimizer", 16, **HEADLINE)
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    host = bigsi_tpu.BIGSI(config)
    monkeypatch.setattr(port.engine, "supports_seq_batch", lambda: False)  # the k-mer path
    monkeypatch.setattr(DeviceEngine, "SERVE_CHUNK", 4)
    sizes = [4, 4, 4, 4, 1]  # 17 queries
    started = [threading.Event() for _ in sizes]
    preps, dispatched = [], []
    prep, dispatch = DeviceEngine._prep_kmer_chunk, DeviceEngine._dispatch_kmer_chunk

    def spy_prep(self, kmer_rows, qstart, h):
        started[len(preps)].set()
        preps.append(len(qstart) - 1)
        return prep(self, kmer_rows, qstart, h)

    def spy_dispatch(self, ready, num_cols):
        i = len(dispatched)
        dispatched.append(ready[0].shape[0])
        if i + 1 < len(sizes):
            assert started[i + 1].wait(timeout=30), "chunk %d's prep overlaps dispatch %d" % (i + 1, i)
        return dispatch(self, ready, num_cols)

    monkeypatch.setattr(DeviceEngine, "_prep_kmer_chunk", spy_prep)
    monkeypatch.setattr(DeviceEngine, "_dispatch_kmer_chunk", spy_dispatch)
    batch = queries + queries[::-1] + queries[:3]
    for threshold in (1.0, 0.7):
        preps.clear()
        dispatched.clear()
        for event in started:
            event.clear()
        assert port.search_batch(batch, threshold) == host.search_batch(batch, threshold)
        assert preps == sizes and dispatched == sizes


def test_staged_insert_on_a_cols_engine_takes_counts_batch(monkeypatch):
    config, queries = build_index("te-headline-insert", "minimizer", 16, **HEADLINE)
    insert_both(config, list(seq_to_kmers(queries[3], K)), "inserted")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    host = bigsi_tpu.BIGSI(config)
    assert port.side is not None and port.engine.supports_kmer_batch()
    kmer_calls = spy(monkeypatch, DeviceEngine, "counts_batch_kmers")
    batch_calls = spy(monkeypatch, DeviceEngine, "counts_batch")
    for threshold in (1.0, 0.7):
        got = port.search_batch(queries, threshold)
        assert got == host.search_batch(queries, threshold)
    assert any(r["sample_name"] == "inserted" for r in got[3])
    assert len(batch_calls) == 2 and not kmer_calls


@pytest.mark.parametrize("tile_rows,kernel", [(8, "cols_counts"), (32, "cols_counts"),
                                              (64, "grouped_tile_counts")])
def test_minimizer_counts_batch_takes_the_grouped_kernels(monkeypatch, tile_rows, kernel):
    """counts_batch on a minimizer engine groups the streams and runs
    kernel E (cols) or kernel C (tile_rows 64), never kernel B."""
    from bigsi_tpu_torch.index import device_engine

    rng = np.random.default_rng(tile_rows)
    num_tiles, w, b, k, h = 40, 2, 4, 30, 3
    words = rng.integers(0, 2**32, size=(num_tiles * tile_rows, w), dtype=np.uint32)
    matrix = BitSliceMatrix(words, w * 32)
    tile = np.repeat(rng.integers(0, num_tiles, size=(b, k // 3)), 3, axis=1)
    row_idx = tile[..., None] * tile_rows + rng.integers(0, tile_rows, size=(b, k, h))
    mask = rng.random((b, k)) < 0.8
    mask[1] = False
    engine = DeviceEngine(matrix, device="cpu", layout="minimizer", tile_rows=tile_rows)
    assert (engine.cols is None) == (tile_rows == 64)
    calls = spy(monkeypatch, device_engine, kernel)
    b_calls = spy(monkeypatch, device_engine, "tile_counts")
    got = engine.counts_batch(row_idx, mask, w * 32)
    want = RefHostEngine(RefMatrix(words, w * 32)).counts_batch(row_idx, mask, w * 32)
    np.testing.assert_array_equal(got, want)
    assert len(calls) == 1 and not b_calls
