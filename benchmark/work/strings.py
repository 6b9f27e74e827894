"""The bytes that scoring's presence strings need for one batch (kernel
L's strings form in the program, whatever computes them): for every
answer, the 32-byte sector of each distinct index word (or cols element)
that holds the answer's sample for one of its query's k-mers, each
counted once over the batch; each hit query's row ids and positions
read once; and one byte a position of every answer's string written."""

from __future__ import annotations

import math

import numpy as np

SECTOR = 32  # bytes: the least the card's memory moves for a random word


def batch_bytes(cfg: dict, reference, batch: list[str], threshold: float, sector_of) -> int:
    """``sector_of(rows int64[K, h], sample) -> int64[...]`` gives the
    sectors a sample's bits of those k-mers' rows lie in."""
    sectors, moved = [], 0
    for seq in batch:
        fwd, rows = reference.layout.position_rows(seq, cfg)
        _, first = np.unique(fwd, return_index=True)
        bits, _ = reference.presence(seq)
        counts = bits.sum(axis=0, dtype=np.int64)
        hits = np.flatnonzero(counts >= math.ceil(bits.shape[0] * threshold))
        if hits.size == 0:
            continue
        distinct = rows[first]
        sectors.extend(sector_of(distinct, int(c)).ravel() for c in hits)
        moved += 4 * distinct.size + 4 * fwd.size + hits.size * fwd.size
    if not sectors:
        return moved
    return moved + SECTOR * np.unique(np.concatenate(sectors)).size
