"""The bytes a batch's search needs on a classic index: each index row
that the batch's distinct k-mers select, read once (every row holds all
samples' bits: W 4-byte words); the queries' bases, read once; each
query's count a sample, written once as int32; and where the batch is
scored, the presence strings' bytes (``work/strings.py``)."""

from __future__ import annotations

import numpy as np

from benchmark.work import strings


def batch_bytes(cfg: dict, reference, batch: list[str], threshold: float, score: bool) -> int:
    n = cfg["samples"]
    w = -(-n // 32)
    rows = [reference.layout.position_rows(seq, cfg)[1] for seq in batch]
    distinct = np.unique(np.concatenate([r.ravel() for r in rows])).size
    total = distinct * w * 4 + sum(len(s) for s in batch) + len(batch) * n * 4
    if score:
        total += strings.batch_bytes(
            cfg, reference, batch, threshold,
            lambda r, c: (r * w + c // 32) * 4 // strings.SECTOR)
    return total
