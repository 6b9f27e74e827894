"""``native.prep_classic_seqs`` (one threaded native pass from a classic
batch's bytes to its padded row ids) against the facade's per-query
route: ``seq_to_kmer_matrix`` -> ``unique_rows_with_inverse`` -> the
canonical classic rows of ``kmer_matrix_to_row_idx``, padded.  The
route's canonicalizing and hashing run in numpy here
(``BIGSI_TPU_NO_NATIVE``), so the reference shares no code with the
pass.  Ids, counts and padding are compared exactly.

Imports neither JAX nor bigsi_tpu, so it also runs where they are not
installed: ``python -m pytest --noconftest tests/test_torch_classic_prep.py``.
"""

import numpy as np
import pytest

from bigsi_tpu_torch import native
from bigsi_tpu_torch.hashing.scheme import row_indices
from bigsi_tpu_torch.kmers import (
    canonicalize_kmer_matrix,
    reverse_comp,
    seq_to_kmer_matrix,
    unique_rows_with_inverse,
)

M_SMALL = 1021


def random_seq(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def per_query_route(seqs, k, h, m):
    """The per-query route's padded int64 [B, kmax, h] and counts."""
    rows = []
    for seq in seqs:
        uniq, _ = unique_rows_with_inverse(seq_to_kmer_matrix(seq, k))
        if uniq.shape[0] == 0:
            rows.append(np.empty((0, h), dtype=np.int64))
            continue
        rows.append(row_indices(canonicalize_kmer_matrix(uniq), h, m))
    kmax = max([1] + [r.shape[0] for r in rows])
    idx = np.zeros((len(seqs), kmax, h), dtype=np.int64)
    for i, r in enumerate(rows):
        idx[i, : r.shape[0]] = r
    return idx, np.array([r.shape[0] for r in rows], dtype=np.int64)


def native_pass(seqs, k, h, m, nthreads=0):
    flat = np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
    sstart = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=sstart[1:])
    return native.prep_classic_seqs(flat, sstart, k, h, m, nthreads=nthreads)


def assert_same(seqs, k, h, m, nthreads=0):
    got = native_pass(seqs, k, h, m, nthreads)
    assert got is not None, "the native library builds and takes the batch"
    idx, n = got
    want_idx, want_n = per_query_route(seqs, k, h, m)
    assert idx.dtype == np.int32 and n.dtype == np.int32
    assert idx.shape == want_idx.shape  # kmax = max(1, max n): today's padding
    np.testing.assert_array_equal(n, want_n)
    np.testing.assert_array_equal(idx, want_idx)  # rows in first-seen order, zero padding
    for i, nk in enumerate(n):
        assert not idx[i, nk:].any()
    return idx, n


@pytest.fixture(autouse=True)
def numpy_reference(monkeypatch):
    monkeypatch.setenv("BIGSI_TPU_NO_NATIVE", "1")  # the reference's own hashing
    assert native.available()


@pytest.mark.parametrize("m", [M_SMALL, 25_000_000])
@pytest.mark.parametrize("h", [1, 3, 5])
@pytest.mark.parametrize("k", [3, 15, 31, 32])
def test_random_batches_match_the_per_query_route(k, h, m):
    rng = np.random.default_rng(k * 100 + h * 10 + (m > M_SMALL))
    seqs = [random_seq(rng, int(n)) for n in rng.integers(0, 260, size=23)]
    # the longest query repeats itself: fewer distinct k-mers than windows,
    # so the rows are packed down from the windows' bound to kmax
    seqs.append(random_seq(rng, 300) * 3)
    idx, n = assert_same(seqs, k, h, m, nthreads=4)
    assert idx.shape[1] < 900 - k + 1


def edge_batch(rng, k):
    kmer = random_seq(rng, k)
    return [
        random_seq(rng, k - 1),  # shorter than k: no k-mers
        random_seq(rng, k),  # exactly k: one
        "",  # an empty entry
        "A" * (k + 40),  # homopolymer: one distinct k-mer
        "C" * (2 * k),
        kmer + reverse_comp(kmer),  # a k-mer and its reverse complement
        kmer + kmer + reverse_comp(kmer) + kmer,  # repeats in first-seen order
        "ACGT" * (k // 2 + 3),  # a short period: few distinct k-mers
        random_seq(rng, 5 * k),
    ]


@pytest.mark.parametrize("k", [1, 3, 4, 15, 31, 32])
def test_edge_queries_match_the_per_query_route(k):
    rng = np.random.default_rng(k)
    seqs = edge_batch(rng, k)
    idx, n = assert_same(seqs, k, 3, 25_000_000, nthreads=3)
    assert n[0] == 0 and n[1] == 1 and n[2] == 0 and n[3] == 1 and n[4] == 1
    # a k-mer and its reverse complement are two k-mers with the same rows
    kmer, seq = seqs[5][:k], seqs[5]
    if kmer != reverse_comp(kmer):
        seen = list(dict.fromkeys(seq[i : i + k] for i in range(len(seq) - k + 1)))
        a, b = seen.index(kmer), seen.index(reverse_comp(kmer))
        assert a != b and n[5] == len(seen)
        np.testing.assert_array_equal(idx[5, a], idx[5, b])


@pytest.mark.parametrize("batch", ["empty_entries", "no_kmers", "one_query", "none",
                                   "longest_repeats"])
def test_degenerate_batches_pad_to_one(batch):
    seqs = {"empty_entries": ["", "", ""], "no_kmers": ["ACGT", "AC"],
            "one_query": ["ACGTTGCAACGTAAACCCGGGTTT" * 3], "none": [],
            "longest_repeats": ["A" * 200, "ACGTTGCAACGTAAACCCGGGTTTACG", "CA" * 90]}[batch]
    idx, n = assert_same(seqs, 15, 3, M_SMALL)
    assert idx.shape == (len(seqs), max(1, int(n.max(initial=0))), 3)


@pytest.mark.parametrize("nthreads", [1, 2, 3, 8, 64])
def test_thread_counts_give_the_same_output(nthreads):
    rng = np.random.default_rng(7)
    lens = np.exp(rng.uniform(np.log(31), np.log(3000), size=41)).astype(int)
    seqs = [random_seq(rng, int(n)) for n in lens] + ["", "A" * 40]
    idx, n = assert_same(seqs, 31, 3, 25_000_000, nthreads=nthreads)
    assert idx.shape[1] == max(len(s) for s in seqs) - 30  # no packing: kmax is the bound
    one_idx, one_n = native_pass(seqs, 31, 3, 25_000_000, nthreads=1)
    assert idx.tobytes() == one_idx.tobytes() and n.tobytes() == one_n.tobytes()


@pytest.mark.parametrize("k,m", [(33, M_SMALL), (0, M_SMALL), (31, 2 ** 31), (31, 0)])
def test_out_of_range_parameters_are_refused(k, m):
    assert native_pass(["ACGT" * 20], k, 3, m) is None


@pytest.mark.parametrize("given", ["stale_and_large", "too_small", "int64", "strided"])
def test_a_caller_buffer_is_written_or_replaced(given):
    """``out``: ids land in a caller's int32 buffer that holds the batch's
    bound, whatever it held before; another buffer is taken otherwise."""
    rng = np.random.default_rng(11)
    seqs = [random_seq(rng, int(n)) for n in rng.integers(20, 400, size=9)] + ["GATTACA" * 30]
    bound = len(seqs) * (max(len(s) for s in seqs) - 30) * 3
    buf = {"stale_and_large": rng.integers(-9, 9, size=bound + 77).astype(np.int32),
           "too_small": np.zeros(bound - 1, dtype=np.int32),
           "int64": np.zeros(bound, dtype=np.int64),
           "strided": np.zeros(2 * bound, dtype=np.int32)[::2]}[given]
    flat = np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
    sstart = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=sstart[1:])
    idx, n = native.prep_classic_seqs(flat, sstart, 31, 3, 25_000_000, out=buf)
    want_idx, want_n = per_query_route(seqs, 31, 3, 25_000_000)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(n, want_n)
    assert np.shares_memory(idx, buf) == (given == "stale_and_large")
