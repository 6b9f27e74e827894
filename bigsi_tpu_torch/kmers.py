"""K-mer primitives: sliding windows, reverse complement, canonicalization,
and dense numpy/2-bit encodings used by the device data plane.

Semantics follow the reference BIGSI (``bigsi/utils/fncts.py:38-65``):
a canonical k-mer is the lexicographic min of the k-mer and its reverse
complement; non-ACGT characters pass through ``reverse_complement``
unchanged (``COMPLEMENT.get(base, base)``).
"""

from __future__ import annotations

import numpy as np

COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}

# ASCII translation table for reverse complement (non-ACGT maps to itself).
_COMP_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in COMPLEMENT.items():
    _COMP_TABLE[ord(_a)] = ord(_b)

# 2-bit codes (A=0, C=1, G=2, T=3); -1 marks non-ACGT.
_CODE_TABLE = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _CODE_TABLE[ord(_b)] = _i
_BASE_FOR_CODE = np.frombuffer(b"ACGT", dtype=np.uint8)


def seq_to_kmers(seq, kmer_size):
    """Yield every k-mer of ``seq`` (len-k sliding window, step 1)."""
    for i in range(len(seq) - kmer_size + 1):
        yield seq[i : i + kmer_size]


def reverse_comp(s: str) -> str:
    return "".join([COMPLEMENT.get(base, base) for base in reversed(s)])


def canonical(k: str) -> str:
    rc = reverse_comp(k)
    return rc if rc < k else k


def convert_query_kmer(kmer: str) -> str:
    return canonical(kmer)


def convert_query_kmers(kmers):
    for k in kmers:
        yield canonical(k)


def seq_to_ascii(seq: str) -> np.ndarray:
    """Sequence string -> uint8 ASCII array."""
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)


def seq_to_kmer_matrix(seq: str, kmer_size: int) -> np.ndarray:
    """All k-mers of ``seq`` as a dense uint8 ASCII matrix [L-k+1, k].

    Built with a strided view + copy: no per-kmer Python loop.
    """
    a = seq_to_ascii(seq)
    n = len(seq) - kmer_size + 1
    if n <= 0:
        return np.empty((0, kmer_size), dtype=np.uint8)
    return np.lib.stride_tricks.sliding_window_view(a, kmer_size).copy()


def canonicalize_kmer_matrix(kmers: np.ndarray) -> np.ndarray:
    """Vectorized canonicalization of an ASCII k-mer matrix [K, k].

    Returns a new matrix where each row is min(kmer, revcomp(kmer)) in
    lexicographic (byte) order — identical to the reference's
    ``canonical`` for ACGT input.
    """
    if kmers.size == 0:
        return kmers
    import os

    if not os.environ.get("BIGSI_TPU_NO_NATIVE"):
        from bigsi_tpu_torch import native

        out = np.ascontiguousarray(kmers, dtype=np.uint8).copy()
        if native.canonicalize_kmers_inplace(out):
            return out
    rc = _COMP_TABLE[kmers[:, ::-1]]
    # Lexicographic compare rows of `kmers` vs `rc`: find first differing
    # column, then pick whichever is smaller there.
    diff = kmers != rc
    any_diff = diff.any(axis=1)
    first = np.where(any_diff, diff.argmax(axis=1), 0)
    rows = np.arange(kmers.shape[0])
    take_rc = kmers[rows, first] > rc[rows, first]
    out = np.where(take_rc[:, None], rc, kmers)
    return np.ascontiguousarray(out)


def unique_rows(kmers: np.ndarray) -> np.ndarray:
    """Distinct rows of an ASCII k-mer matrix, in first-seen order."""
    return unique_rows_with_inverse(kmers)[0]


def unique_rows_with_inverse(kmers: np.ndarray):
    """Distinct rows in first-seen order plus the inverse map.

    Returns ``(uniq, inverse)`` with ``uniq[inverse] == kmers``.
    """
    if kmers.shape[0] == 0:
        return kmers, np.empty(0, dtype=np.int64)
    void = np.ascontiguousarray(kmers).view(
        np.dtype((np.void, kmers.dtype.itemsize * kmers.shape[1]))
    ).ravel()
    _, first_idx, inv = np.unique(void, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    # `order` ranks sorted-unique ids by first appearance; remap so that
    # unique id 0 is the first k-mer seen, 1 the second, ...
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return kmers[np.sort(first_idx)], rank[inv].astype(np.int64)


def ascii_to_strings(kmers: np.ndarray) -> list:
    return [bytes(row).decode("ascii") for row in kmers]


def encode_kmers_2bit(kmers: np.ndarray) -> np.ndarray:
    """ASCII k-mer matrix [K, k] -> 2-bit packed uint64 [K] (k <= 31).

    Base at position j (0 = leftmost) occupies bits [2*(k-1-j), 2*(k-1-j)+1]
    so that integer order == lexicographic order.
    """
    K, k = kmers.shape
    if k > 31:
        raise ValueError("2-bit packing supports k <= 31")
    codes = _CODE_TABLE[kmers].astype(np.uint64)
    shifts = (2 * (k - 1 - np.arange(k, dtype=np.uint64))).astype(np.uint64)
    return (codes << shifts[None, :]).sum(axis=1, dtype=np.uint64)


def decode_kmers_2bit(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`encode_kmers_2bit` -> ASCII matrix [K, k]."""
    shifts = (2 * (k - 1 - np.arange(k, dtype=np.uint64))).astype(np.uint64)
    codes = (packed[:, None] >> shifts[None, :]) & np.uint64(3)
    return _BASE_FOR_CODE[codes.astype(np.intp)]
