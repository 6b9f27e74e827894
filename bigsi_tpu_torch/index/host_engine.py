"""Host (numpy) compute engine for the signature index.

This is the CPU oracle: the device engines
(:mod:`bigsi_tpu_torch.index.device_engine`) must produce identical results.
The three core ops correspond to the reference query pipeline
(``bigsi/graph/index.py:42-80``, ``bigsi/graph/bigsi.py:192-230``):

* gather the ``h`` hash rows of each k-mer and AND them;
* AND across all k-mers + nonzero scan (exact filter);
* unpack + column-sum (inexact hit counts).
"""

from __future__ import annotations

import numpy as np

from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.matrix.packing import unpack_bits_lsb


class HostEngine:
    def __init__(self, matrix: BitSliceMatrix):
        self.matrix = matrix

    def and_rows(self, row_idx: np.ndarray) -> np.ndarray:
        """row_idx int [K, h] -> packed presence uint32 [K, W]:
        per k-mer, the AND of its h hash rows."""
        if row_idx.shape[0] == 0:
            return np.empty((0, self.matrix.num_words), dtype=np.uint32)
        rows = self.matrix.words[row_idx.reshape(-1)]
        rows = rows.reshape(row_idx.shape[0], row_idx.shape[1], -1)
        out = rows[:, 0, :]
        for j in range(1, row_idx.shape[1]):
            out = out & rows[:, j, :]
        return out

    def exact_colours(self, packed: np.ndarray) -> np.ndarray:
        """Colours whose bit is set in ALL k-mer presence rows."""
        if packed.shape[0] == 0:
            return np.empty(0, dtype=np.int64)
        allk = np.bitwise_and.reduce(packed, axis=0)
        return np.flatnonzero(unpack_bits_lsb(allk)).astype(np.int64)

    def counts(self, packed: np.ndarray, num_cols: int) -> np.ndarray:
        """Per-colour count of k-mers present -> int64 [num_cols]."""
        if packed.shape[0] == 0:
            return np.zeros(num_cols, dtype=np.int64)
        bits = unpack_bits_lsb(packed, num_cols)
        return bits.sum(axis=0, dtype=np.int64)

    def presence_matrix(self, packed: np.ndarray, num_cols: int) -> np.ndarray:
        """Unpacked 0/1 presence [K, num_cols] (scoring path)."""
        return unpack_bits_lsb(packed, num_cols)

    def counts_batch(
        self, row_idx: np.ndarray, mask: np.ndarray, num_cols: int
    ) -> np.ndarray:
        """Batched per-query hit counts.

        row_idx int [B, K, h] (padding rows are 0), mask bool [B, K]
        -> int64 [B, num_cols].  Oracle for the device engines'
        single-dispatch batched path (``DeviceEngine.counts_batch``).
        """
        return counts_batch_fallback(self, row_idx, mask, num_cols)


def counts_batch_fallback(engine, row_idx, mask, num_cols) -> np.ndarray:
    """Per-query loop over any engine's (and_rows, counts) surface —
    the batched-counts fallback for engines without a native batch op."""
    b = row_idx.shape[0]
    out = np.zeros((b, num_cols), dtype=np.int64)
    for i in range(b):
        valid = mask[i]
        if not valid.any():
            continue
        packed = engine.and_rows(row_idx[i][valid])
        out[i] = engine.counts(packed, num_cols)
    return out


def presence_strings_fallback(engine, row_idx_list, inverse_list, colour_lists,
                              num_cols, packed_list=None) -> list:
    """Per-query presence strings over any engine's (and_rows,
    presence_matrix) surface: the contract of ``DeviceEngine.
    presence_strings`` for engines without a batched one.  ``packed_list``,
    where the caller has them, are each query's AND-ed rows, which are
    then not gathered again."""
    out = []
    for i, (row_idx, inverse, colours) in enumerate(
            zip(row_idx_list, inverse_list, colour_lists)):
        colours = np.asarray(colours, dtype=np.int64)
        if colours.size == 0:
            out.append([])
            continue
        packed = engine.and_rows(row_idx) if packed_list is None else packed_list[i]
        x = engine.presence_matrix(packed, num_cols)
        chars = np.ascontiguousarray(x[inverse][:, colours].T, dtype=np.uint8) + np.uint8(0x30)
        out.append([c.tobytes().decode("ascii") for c in chars])
    return out
