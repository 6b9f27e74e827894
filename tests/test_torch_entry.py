"""The one-program query steps of the port against the JAX package's:
``ops/lookup.py:make_full_query_step`` and ``entry.py:entry`` (their
plain versions on the CPU), and the facade's split of its host part
into ``search.kmer_prep``, ``search.hash`` and ``search.pad`` on each
of its classic routes.

The same numpy inputs go through the JAX function (JAX on the CPU) and
the port; counts are integers, so every comparison is exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigsi_tpu_torch
from bigsi_tpu.hashing.murmur3 import hash_kmer_matrix
from bigsi_tpu.index.host_engine import HostEngine
from bigsi_tpu.kmers import canonicalize_kmer_matrix
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu.ops.lookup import make_full_query_step as jax_full_query_step
from bigsi_tpu_torch import storage
from bigsi_tpu_torch.entry import entry
from bigsi_tpu_torch.kmers import seq_to_kmers
from bigsi_tpu_torch.ops.lookup import make_full_query_step

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")


@pytest.mark.parametrize("m, n, klen, b, k", [(4096, 256, 9, 3, 16), (1000, 70, 31, 5, 40)])
def test_full_query_step_matches_jax_and_host(m, n, klen, b, k):
    """tests/test_device_engine.py:131's shapes and a ragged one: the
    port's step equals JAX's step and host hashing + host counts."""
    rng = np.random.default_rng(m)
    h = 3
    blooms = [rng.random(m) < 0.3 for _ in range(n)]
    mat = BitSliceMatrix.create(blooms, m, n)
    host = HostEngine(mat)
    kmers = ACGT[rng.integers(0, 4, size=(b, k, klen))]
    mask = rng.random((b, k)) < 0.9
    mask[-1] = False  # an all-padding query

    words = torch.from_numpy(np.ascontiguousarray(mat.words).view(np.int32))
    got = make_full_query_step(m, h)(words, torch.from_numpy(kmers), torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == (b, words.shape[1] * 32)
    want = jax_full_query_step(m, h)(jnp.asarray(mat.words), jnp.asarray(kmers),
                                     jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(b):
        idx = hash_kmer_matrix(canonicalize_kmer_matrix(kmers[i][mask[i]]), h, m)
        np.testing.assert_array_equal(got[i, :n].numpy(), host.counts(host.and_rows(idx), n))


@pytest.fixture
def graft_entry(tmp_path, monkeypatch):
    """``__graft_entry__`` imported with its compile cache in tmp_path;
    the cache settings it changes are put back afterwards."""
    saved = {key: getattr(jax.config, key) for key in CACHE_KEYS}
    monkeypatch.setenv("BIGSI_TPU_JAX_CACHE", str(tmp_path / "jax_cache"))
    try:
        yield importlib.import_module("__graft_entry__")
    finally:
        for key, value in saved.items():
            jax.config.update(key, value)


def test_entry_matches_jax_entry(graft_entry):
    """entry(device="cpu") draws the JAX entry's inputs from the same seed
    (the uint16 cols as int16 bits) and gives its outputs exactly."""
    jfn, jargs = graft_entry.entry()
    want = jfn(*jargs)
    fn, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    for got_arg, jax_arg in zip(args, jargs):
        np.testing.assert_array_equal(
            got_arg.numpy(), np.asarray(jax_arg).view(got_arg.numpy().dtype))
    got = fn(*args)
    assert len(got) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))
    assert bool(got[2])


def test_entry_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        entry()


@pytest.mark.parametrize("route", ["native", "per_query"])
def test_search_batch_splits_its_host_part(route):
    """A classic index's search_batch times its host part, and its result
    dicts stay those of the numpy host engine.  An ACGT batch takes the
    one native pass: ``search.kmer_prep`` (bytes to padded row ids) and
    ``search.pad`` (the mask) once each, no ``search.hash``; a batch
    with an N takes the per-query route: k-mer extraction and dedup, the
    per-query hashing and the padding, each once, after the refused
    native pass's gate (a second ``search.kmer_prep``)."""
    rng = np.random.default_rng(4)
    config = {"storage-engine": "memory", "storage-config": {"filename": "entry-spans"},
              "k": 31, "m": 8192, "h": 3}
    storage.get_storage(config).delete_all()
    genomes = ["".join("ACGT"[c] for c in rng.integers(0, 4, 300)) for _ in range(6)]
    blooms = [bigsi_tpu_torch.BIGSI.bloom(config, list(seq_to_kmers(g, 31))) for g in genomes]
    bigsi_tpu_torch.BIGSI.build(config, blooms, ["s%d" % i for i in range(6)], device="cpu")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    host = bigsi_tpu_torch.BIGSI(dict(config, engine="numpy"))
    queries = [genomes[0][:120], genomes[1], genomes[2][:20], genomes[3][50:200]]
    spans = ["search.kmer_prep", "search.hash", "search.pad", "search.batch_counts"]
    if route == "native":
        spans.remove("search.hash")
    else:
        queries[1] = genomes[1][:100] + "N" + genomes[1][101:]
    for threshold in (1.0, 0.7):
        bigsi_tpu_torch.metrics.reset()
        got = port.search_batch(queries, threshold)
        timers = bigsi_tpu_torch.metrics.snapshot()["timers"]
        for name in spans:
            refused_gate = route == "per_query" and name == "search.kmer_prep"
            assert timers[name]["count"] == 1 + refused_gate, name
            assert timers[name]["total_s"] >= 0.0
        assert ("search.hash" in timers) == (route == "per_query")
        assert got == host.search_batch(queries, threshold)
