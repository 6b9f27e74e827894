"""MurmurHash3_x86_32, bit-exact with the reference's ``mmh3.hash``.

The reference hashes the ASCII canonical k-mer string with seeds
``0..h-1`` and reduces with Python's floor-mod
(``bigsi/bloom/bloomfilter.py:5-13``).  ``mmh3.hash`` returns a *signed*
int32; Python ``%`` then maps it to ``[0, m)``.  Golden values
(``bigsi/tests/bloom/test_create_bloomfilter.py:5-8``)::

    generate_hashes("ATT", 3, 25) == {2, 15, 17}
    generate_hashes("ATT", 1, 25) == {15}
    generate_hashes("ATT", 2, 50) == {15, 27}

Two implementations here share the algorithm (the native library's
``hash_kmer_batch`` is a third):

* :func:`murmur3_32` — scalar pure-Python (oracle).
* :func:`murmur3_32_batch` — numpy, vectorized over a [K, k] ASCII
  matrix x an [h] seed vector (host build/query path).
"""

from __future__ import annotations

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """Scalar MurmurHash3_x86_32 -> signed int32 (mmh3.hash parity)."""
    h = seed & _M32
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[4 * i : 4 * i + 4], "little")
        k = (k * _C1) & _M32
        k = _rotl32(k, 15)
        k = (k * _C2) & _M32
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _M32
    tail = data[nblocks * 4 :]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _M32
        k = _rotl32(k, 15)
        k = (k * _C2) & _M32
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h - (1 << 32) if h >= (1 << 31) else h


def _np_rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def bytes_to_words(data: np.ndarray):
    """Split an ASCII matrix [K, k] into little-endian uint32 body words
    [K, k//4] plus the tail word [K] (k%4 trailing bytes, zero-padded).
    """
    K, k = data.shape
    nblocks = k // 4
    body = data[:, : nblocks * 4].reshape(K, nblocks, 4).astype(np.uint32)
    words = (
        body[:, :, 0]
        | (body[:, :, 1] << np.uint32(8))
        | (body[:, :, 2] << np.uint32(16))
        | (body[:, :, 3] << np.uint32(24))
    )
    tail = np.zeros(K, dtype=np.uint32)
    ntail = k % 4
    for j in range(ntail):
        tail |= data[:, nblocks * 4 + j].astype(np.uint32) << np.uint32(8 * j)
    return words, tail, ntail


def murmur3_32_batch(data: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """Vectorized murmur3: ASCII matrix [K, k] x seeds [h] -> int32 [K, h]."""
    if data.ndim != 2:
        raise ValueError("expected [K, k] uint8 matrix")
    K, k = data.shape
    seeds = np.asarray(seeds, dtype=np.uint32)
    words, tail, ntail = bytes_to_words(data)
    with np.errstate(over="ignore"):
        h = np.broadcast_to(seeds[None, :], (K, len(seeds))).copy()
        c1 = np.uint32(_C1)
        c2 = np.uint32(_C2)
        for i in range(words.shape[1]):
            kw = words[:, i : i + 1] * c1
            kw = _np_rotl32(kw, 15)
            kw = kw * c2
            h ^= kw
            h = _np_rotl32(h, 13)
            h = h * np.uint32(5) + np.uint32(0xE6546B64)
        if ntail:
            kw = tail[:, None] * c1
            kw = _np_rotl32(kw, 15)
            kw = kw * c2
            h ^= kw
        h ^= np.uint32(k)
        h ^= h >> np.uint32(16)
        h = h * np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h.astype(np.int32)


def hash_kmer_matrix(kmers: np.ndarray, num_hashes: int, m: int) -> np.ndarray:
    """Bloom bucket indices for an ASCII k-mer matrix.

    Returns int64 [K, h]: ``mmh3.hash(kmer, seed) % m`` with Python
    floor-mod semantics (always non-negative).  Uses the native C++
    hasher when built (bit-identical; see tests/test_native.py).
    """
    import os

    if kmers.shape[0] and not os.environ.get("BIGSI_TPU_NO_NATIVE"):
        from bigsi_tpu_torch import native

        out = native.hash_kmer_batch(kmers, num_hashes, m)
        if out is not None:
            return out
    seeds = np.arange(num_hashes, dtype=np.uint32)
    hashes = murmur3_32_batch(kmers, seeds).astype(np.int64)
    return np.mod(hashes, m)


def generate_hashes(element: str, number_hash_functions: int, bloomfilter_size: int):
    """Scalar reference-parity API: set of bucket indices for one element."""
    return {
        murmur3_32(element.encode("utf-8"), seed) % bloomfilter_size
        for seed in range(number_hash_functions)
    }
