"""Bit-sliced signature matrix.

The reference stores the matrix one bitarray row per KV-store key
(``bigsi/matrix/bitmatrix.py:7-75``).  Here the whole index is a single
dense ``uint32[m, W]`` ndarray (RAM, mmap, or device HBM) in the
LSB-first matrix layout of :mod:`bigsi_tpu_torch.matrix.packing`.  Rows are
bitslices over samples; ``num_cols`` tracks the live sample count while
``W`` may include zero padding (the analogue of the reference's
byte-padding phantom columns, ``bitmatrix.py:34-37`` — padding bits are
always zero so AND/count semantics are unchanged).

Like the reference class, this layer "does not know the concept of a
kmer" (``bitmatrix.py:9-12``): row indices are opaque.
"""

from __future__ import annotations

import numpy as np

from bigsi_tpu_torch.matrix.packing import (
    WORD_BITS,
    pack_bits_lsb,
    unpack_bits_lsb,
    words_for,
)

# Pad the word axis to sublane granularity only; storing at full
# 128-lane width would waste up to 16x memory for narrow indexes.  The
# device engine re-packs narrow rows into 128-lane "fat rows" at
# staging time, and mesh sharding pads further as needed
# (bigsi_tpu/parallel/sharding.py pad_words_for_mesh).
LANE_WORDS = 8

DEFAULT_ROW_CHUNK = 1 << 14


def _padded_words(num_cols: int, lane_words: int = LANE_WORDS) -> int:
    w = words_for(max(num_cols, 1))
    return ((w + lane_words - 1) // lane_words) * lane_words


def transpose_blooms(
    blooms,
    num_rows: int,
    row_chunk: int = DEFAULT_ROW_CHUNK,
    lane_words: int = LANE_WORDS,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Transpose N column Bloom filters into the packed bitslice matrix.

    ``blooms``: sequence of N bool arrays of length ``num_rows`` (one per
    sample).  Returns ``uint32[num_rows, W]``.  Processes ``row_chunk``
    bitslice rows at a time so peak extra memory is ``N * row_chunk``
    bytes — never the dense ``N x m`` matrix that is the reference's
    scaling wall (``bigsi/matrix/transpose.py:33-43``).
    """
    n = len(blooms)
    w = _padded_words(n, lane_words)
    if out is None:
        out = np.zeros((num_rows, w), dtype=np.uint32)
    for r0 in range(0, num_rows, row_chunk):
        r1 = min(r0 + row_chunk, num_rows)
        block = np.empty((n, r1 - r0), dtype=np.uint8)
        for i, b in enumerate(blooms):
            block[i] = b[r0:r1]
        packed = pack_bits_lsb(np.ascontiguousarray(block.T))
        out[r0:r1, : packed.shape[1]] = packed
    return out


def transpose_blooms_to_file(
    blooms,
    num_rows: int,
    path: str,
    row_chunk: int = DEFAULT_ROW_CHUNK,
    lane_words: int = LANE_WORDS,
) -> int:
    """Stream the bitslice transpose straight into a ``rows.bin`` file.

    Same chunking as :func:`transpose_blooms` but rows append to
    ``path`` instead of a RAM matrix, so peak memory is
    ``N * row_chunk`` bytes for ANY index size — the 450k-sample
    matrix (~1.4 TB) never exists in RAM on any host.  Returns the
    padded word count W (callers register the file with
    ``IndexStore.adopt_rows``).
    """
    n = len(blooms)
    w = _padded_words(n, lane_words)
    # bound the chunk block (n * row_chunk bytes) to ~1 GiB at any N
    row_chunk = min(row_chunk, max(1024, (1 << 30) // max(n, 1)))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for r0 in range(0, num_rows, row_chunk):
            r1 = min(r0 + row_chunk, num_rows)
            block = np.empty((n, r1 - r0), dtype=np.uint8)
            for i, b in enumerate(blooms):
                block[i] = b[r0:r1]
            packed = pack_bits_lsb(np.ascontiguousarray(block.T))
            if packed.shape[1] != w:
                grown = np.zeros((packed.shape[0], w), dtype=np.uint32)
                grown[:, : packed.shape[1]] = packed
                packed = grown
            packed.tofile(f)
    import os

    os.replace(tmp, path)
    return w


class BitSliceMatrix:
    """Dense packed bit matrix with the reference ``BitMatrix`` API shape."""

    def __init__(self, words: np.ndarray, num_cols: int):
        if words.ndim != 2 or words.dtype != np.uint32:
            raise ValueError("words must be uint32 [num_rows, W]")
        self.words = words
        self.num_cols = int(num_cols)

    @property
    def num_rows(self) -> int:
        return self.words.shape[0]

    @property
    def num_words(self) -> int:
        return self.words.shape[1]

    @classmethod
    def create(cls, blooms, num_rows: int, num_cols: int) -> "BitSliceMatrix":
        words = transpose_blooms(blooms, num_rows)
        return cls(words, num_cols)

    @classmethod
    def zeros(cls, num_rows: int, num_cols: int) -> "BitSliceMatrix":
        return cls(
            np.zeros((num_rows, _padded_words(num_cols)), dtype=np.uint32), num_cols
        )

    # -- row access ---------------------------------------------------

    def get_rows(self, row_indexes) -> np.ndarray:
        """Packed rows uint32 [R, W]."""
        idx = np.asarray(row_indexes, dtype=np.int64)
        return self.words[idx]

    def get_row_bools(self, row_index: int, trim: bool = True) -> np.ndarray:
        bits = unpack_bits_lsb(self.words[row_index])
        return bits[: self.num_cols].astype(bool) if trim else bits.astype(bool)

    def set_row_bools(self, row_index: int, bits: np.ndarray) -> None:
        packed = pack_bits_lsb(np.asarray(bits, dtype=np.uint8))
        row = np.zeros(self.num_words, dtype=np.uint32)
        row[: packed.shape[-1]] = packed
        self.words[row_index] = row

    def ensure_writable(self) -> None:
        """Copy mmap-backed / read-only words into RAM before mutation."""
        if not self.words.flags.writeable:
            self.words = np.array(self.words)

    # -- column ops ---------------------------------------------------

    def get_column(self, column_index: int) -> np.ndarray:
        """Bool column over all rows (vectorized, unlike the reference's
        per-row bit pokes at ``bitmatrix.py:50-63``)."""
        w, b = divmod(column_index, WORD_BITS)
        return ((self.words[:, w] >> np.uint32(b)) & np.uint32(1)).astype(bool)

    def get_columns(self, column_indexes):
        for c in column_indexes:
            yield self.get_column(c)

    def insert_column(self, bits: np.ndarray, column_index: int) -> None:
        """Set column ``column_index`` to ``bits`` (bool [num_rows]),
        growing the matrix if the index is at/after the current edge."""
        if column_index >= self.num_cols:
            self.num_cols = column_index + 1
        need_w = _padded_words(self.num_cols)
        if need_w > self.num_words:
            grown = np.zeros((self.num_rows, need_w), dtype=np.uint32)
            grown[:, : self.num_words] = self.words
            self.words = grown
        w, b = divmod(column_index, WORD_BITS)
        mask = np.uint32(1 << b)
        col = self.words[:, w]
        bits = np.asarray(bits, dtype=bool)
        n = min(len(bits), self.num_rows)
        self.words[:, w] = np.where(bits[:n], col | mask, col & ~mask)

    # -- merge --------------------------------------------------------

    def merge(self, other: "BitSliceMatrix", row_chunk: int = DEFAULT_ROW_CHUNK) -> None:
        """Column-concatenate ``other`` after this matrix's live columns
        (semantics of ``bigsi/graph/index.py:54-60`` at matrix granularity).
        """
        if other.num_rows != self.num_rows:
            raise ValueError("row count mismatch in merge")
        new_cols = self.num_cols + other.num_cols
        new_w = _padded_words(new_cols)
        out = np.zeros((self.num_rows, new_w), dtype=np.uint32)
        if self.num_cols % WORD_BITS == 0:
            # Fast path: word-aligned concatenation.
            w0 = self.num_cols // WORD_BITS
            out[:, : min(w0, self.num_words)] = self.words[:, :w0]
            ow = words_for(other.num_cols)
            out[:, w0 : w0 + ow] = other.words[:, :ow]
        else:
            for r0 in range(0, self.num_rows, row_chunk):
                r1 = min(r0 + row_chunk, self.num_rows)
                left = unpack_bits_lsb(self.words[r0:r1], self.num_cols)
                right = unpack_bits_lsb(other.words[r0:r1], other.num_cols)
                packed = pack_bits_lsb(np.concatenate([left, right], axis=-1))
                out[r0:r1, : packed.shape[1]] = packed
        self.words = out
        self.num_cols = new_cols
