"""The classic layout (upstream BIGSI's): a k-mer's h rows are
``mmh3.hash(canonical k-mer, seed) mod m`` for seeds 0 .. h-1, with
Python's floor modulus; the canonical k-mer is the lesser of the k-mer
and its reverse complement in byte order."""

from __future__ import annotations

import numpy as np

from benchmark.reference.hashing import COMPLEMENT, murmur3_32, seq_codes, window_codes


def position_rows(seq: str, cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """-> (forward code uint64[P] of the k-mer at each position, its rows
    int64[P, h]); P = len(seq) - k + 1."""
    k, h, m = cfg["k"], cfg["h"], cfg["m"]
    fwd, rc = window_codes(seq_codes(seq), k)
    if fwd.size == 0:
        return fwd, np.zeros((0, h), dtype=np.int64)
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(raw, k)
    canon = np.where((rc < fwd)[:, None], COMPLEMENT[win[:, ::-1]], win)
    hashes = murmur3_32(np.ascontiguousarray(canon), np.arange(h)).astype(np.int64)
    return fwd, np.mod(hashes, m)
