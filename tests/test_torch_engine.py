"""bigsi_tpu_torch.BIGSI (engine on device="cpu", so the kernels' plain
versions) against bigsi_tpu.BIGSI on the JAX device engine (JAX on the
CPU) and on the numpy host engine: the same index, the same queries,
identical result dicts (tolerance zero)."""

import numpy as np
import pytest
import torch

import bigsi_tpu
import bigsi_tpu_torch
from bigsi_tpu.index.host_engine import HostEngine
from bigsi_tpu.kmers import seq_to_kmers
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu.storage import get_storage
from bigsi_tpu_torch.index.device_engine import DeviceEngine

K = 31
N_SAMPLES = 12


def random_seq(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def mutate(rng, seq, snps):
    out = list(seq)
    for pos in rng.choice(len(seq), size=snps, replace=False):
        out[pos] = "ACGT"[("ACGT".index(out[pos]) + 1) % 4]
    return "".join(out)


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
    get_storage(config).delete_all()
    genomes = [random_seq(rng, 300) for _ in range(N_SAMPLES)]
    blooms = [bigsi_tpu.BIGSI.bloom(config, seq_to_kmers(g, K)) for g in genomes]
    bigsi_tpu.BIGSI.build(config, blooms, ["s%d" % i for i in range(N_SAMPLES)])
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
    bloom = bigsi_tpu.BIGSI.bloom(config, seq_to_kmers(queries[3], K))
    bigsi_tpu.BIGSI(config).insert(bloom, "inserted")
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
    bigsi_tpu.BIGSI.build(
        config, [bigsi_tpu.BIGSI.bloom(config, seq_to_kmers(s, K)) for s in seqs],
        ["a", "b", "c"])
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
    np.testing.assert_array_equal(got, HostEngine(matrix).counts_batch(row_idx, mask, 50))
    with pytest.raises(IndexError):
        DeviceEngine(matrix, device="cpu").counts_batch(row_idx + 100, mask, 50)
