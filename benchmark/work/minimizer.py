"""The bytes a batch's search needs on a minimizer index in the cols
layout: each tile that the batch's distinct k-mers select, read once as
its cols row (one tile_rows-bit element a sample); the queries' bases,
read once; each query's count a sample, written once as int32; and
where the batch is scored, the presence strings' bytes
(``work/strings.py``), a sector for each distinct cols element read."""

from __future__ import annotations

import numpy as np

from benchmark.work import strings


def batch_bytes(cfg: dict, reference, batch: list[str], threshold: float, score: bool) -> int:
    n, tile_rows = cfg["samples"], cfg["tile-rows"]
    elem = tile_rows // 8
    tiles = [reference.layout.position_rows(seq, cfg)[1][:, 0] // tile_rows for seq in batch]
    distinct = np.unique(np.concatenate(tiles)).size
    total = distinct * n * elem + sum(len(s) for s in batch) + len(batch) * n * 4
    if score:
        total += strings.batch_bytes(
            cfg, reference, batch, threshold,
            lambda r, c: (r[:, 0] // tile_rows * n + c) * elem // strings.SECTOR)
    return total
