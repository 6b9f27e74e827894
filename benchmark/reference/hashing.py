"""Frozen hashing for the plain reference: 2-bit codes, MurmurHash3_x86_32
and splitmix64, written from their published definitions in NumPy.

Nothing here imports the program.  The layouts' row functions
(``reference/<layout>.py``) build on these; the benchmark also draws
the planted samples' blooms with them, so the index's planted bits and
the reference's reading of them come from one place that no change to
the program can move.
"""

from __future__ import annotations

import numpy as np

CODE = np.full(256, 255, dtype=np.uint8)  # A C G T -> 0 1 2 3, anything else 255
for _i, _b in enumerate(b"ACGT"):
    CODE[_b] = _i
COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    COMPLEMENT[_a] = _b


def seq_codes(seq: str) -> np.ndarray:
    """ACGT string -> uint64 codes A=0 C=1 G=2 T=3; other bytes raise."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    codes = CODE[raw]
    if (codes == 255).any():
        raise ValueError("the reference takes ACGT sequences only")
    return codes.astype(np.uint64)


def window_codes(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Codes of a sequence -> (forward, reverse-complement) uint64 codes of
    every k-long window, most significant base first (integer order is
    lexicographic order on ACGT); k <= 32."""
    if k > 32:
        raise ValueError("k <= 32")
    if codes.shape[0] < k:
        empty = np.zeros(0, dtype=np.uint64)
        return empty, empty
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    up = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    down = (2 * np.arange(k)).astype(np.uint64)
    fwd = np.bitwise_or.reduce(win << up, axis=1)
    rc = np.bitwise_or.reduce((np.uint64(3) - win) << down, axis=1)
    return fwd, rc


def splitmix64(z: np.ndarray) -> np.ndarray:
    """The splitmix64 finaliser over uint64."""
    z = np.asarray(z, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_32(data: np.ndarray, seeds) -> np.ndarray:
    """MurmurHash3_x86_32 of each row of an ASCII matrix uint8[K, n] under
    each seed -> signed int32[K, len(seeds)], as ``mmh3.hash`` gives."""
    k_rows, n = data.shape
    seeds = np.asarray(seeds, dtype=np.uint32)
    nblocks = n // 4
    body = data[:, : nblocks * 4].reshape(k_rows, nblocks, 4).astype(np.uint32)
    blocks = body[..., 0] | body[..., 1] << np.uint32(8) | body[..., 2] << np.uint32(16) \
        | body[..., 3] << np.uint32(24)
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)
    with np.errstate(over="ignore"):
        h = np.repeat(seeds[None, :], k_rows, axis=0)
        for i in range(nblocks):
            kw = _rotl(blocks[:, i:i + 1] * c1, 15) * c2
            h = _rotl(h ^ kw, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        tail = np.zeros(k_rows, dtype=np.uint32)
        for j in range(n % 4):
            tail |= data[:, nblocks * 4 + j].astype(np.uint32) << np.uint32(8 * j)
        if n % 4:
            h ^= _rotl(tail[:, None] * c1, 15) * c2
        h ^= np.uint32(n)
        h ^= h >> np.uint32(16)
        h = h * np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h.view(np.int32)
