"""The port's minimizer layout under slot scheme 3 (``hashing/scheme.py``
of the port, whose definition this freezes): rows come in tiles of
``tile-rows``.  A k-mer's tile is the least of ``splitmix64(SEED ^
canonical s-mer code)`` over its w = k - s + 1 s-mers, modulo the number
of tiles; its h slots are 6-bit fields of ``splitmix64(canonical k-mer
code)`` modulo tile-rows.  Codes are 2 bits a base, most significant
first, and a canonical code is the lesser of the two strands'."""

from __future__ import annotations

import numpy as np

from benchmark.reference.hashing import seq_codes, splitmix64, window_codes

SEED = np.uint64(0x5EED5EED)


def position_rows(seq: str, cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """-> (forward code uint64[P] of the k-mer at each position, its rows
    int64[P, h]); P = len(seq) - k + 1."""
    k, h, m = cfg["k"], cfg["h"], cfg["m"]
    tile_rows, window = cfg["tile-rows"], cfg["minimizer-window"]
    codes = seq_codes(seq)
    fwd, rc = window_codes(codes, k)
    if fwd.size == 0:
        return fwd, np.zeros((0, h), dtype=np.int64)
    s = k - window + 1
    sf, sr = window_codes(codes, s)
    order = splitmix64(SEED ^ np.minimum(sf, sr))
    least = np.lib.stride_tricks.sliding_window_view(order, window).min(axis=1)
    tile = (least % np.uint64(max(1, m // tile_rows))).astype(np.int64)
    hv = splitmix64(np.minimum(fwd, rc))
    shifts = (np.arange(h) * 6).astype(np.uint64)
    slots = ((hv[:, None] >> shifts[None, :]) % np.uint64(tile_rows)).astype(np.int64)
    return fwd, tile[:, None] * tile_rows + slots
