"""CUDA compute engine: the bitslice matrix resident on the card.

The port of ``bigsi_tpu/index/device_engine.py:DeviceEngine`` for
search.  Same method surface as
:class:`bigsi_tpu.index.host_engine.HostEngine` (numpy in, numpy out),
so it plugs into the facade's engine seam.  The matrix lives on the
device once, row-major, as ``int32[m_pad, W]`` holding the uint32 bits
(:func:`load_words`); the tiled layouts zero-pad it to whole tiles, and
tile ``t`` is rows ``t * tile_rows ... t * tile_rows + tile_rows - 1``.

* classic: kernel A (:func:`~bigsi_tpu_torch.ops.fused_lookup.classic_counts`)
  gathers each k-mer's h rows, ANDs them and counts hits per sample;
* blocked / minimizer: kernel B
  (:func:`~bigsi_tpu_torch.ops.fused_lookup.tile_counts`) takes each
  k-mer's tile and a 64-bit slot mask instead.

A single query reduces through the same kernel as a batch of one;
scoring's presence rows come from the plain ops.  The JAX engine's cols
and seq serving paths are not ported yet, so ``supports_kmer_batch``
and ``supports_seq_batch`` are False and the facade takes
``counts_batch``.  PyTorch compiles nothing per shape, so no bucketing
of K or B is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from bigsi_tpu.hashing.scheme import TILE_ROWS
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.ops.fused_lookup import classic_counts, tile_counts

TILED_LAYOUTS = ("blocked", "minimizer")
LOAD_CHUNK_ROWS = 1 << 20  # rows per host->device copy in load_words


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  A CUDA device without CUDA raises: the
    engine never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bigsi_tpu_torch's engine needs a CUDA device and none is "
            "available (device='cpu' runs the plain PyTorch versions)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %s" % dev)
    return dev


def load_words(words: np.ndarray, device, tile_rows: int | None = None) -> torch.Tensor:
    """The JAX package's matrix (``BitSliceMatrix.words``, numpy
    uint32[m, W] in RAM or mmap) -> int32[m_pad, W] on ``device``
    holding the same bits.  With ``tile_rows``, m_pad rounds m up to
    whole tiles and the added rows are zero.  Copied in row chunks, so a
    mmap'd matrix never has a second full copy in host RAM."""
    if words.ndim != 2 or words.dtype != np.uint32:
        raise ValueError("words must be uint32 [m, W]")
    m, w = words.shape
    m_pad = m if tile_rows is None else -(-m // tile_rows) * tile_rows
    out = torch.empty((m_pad, w), dtype=torch.int32, device=device)
    out[m:].zero_()
    for r0 in range(0, m, LOAD_CHUNK_ROWS):
        chunk = np.array(words[r0 : r0 + LOAD_CHUNK_ROWS]).view(np.int32)
        out[r0 : r0 + chunk.shape[0]].copy_(torch.from_numpy(chunk))
    return out


def tile_streams(row_idx: torch.Tensor, mask: torch.Tensor, tile_rows: int):
    """Row ids int[..., h] of a tiled layout (all h rows of a k-mer lie
    in one tile) and validity bool[...] -> (tile int32[...], slot mask
    int64[...]), on the tensors' device; bit s of a mask selects row s
    of the tile, and masked-out k-mers get tile 0 and mask 0.  The masks
    are 64 bits wide, so tile_rows 64 keeps rows 32-63 (the JAX engine's
    uint32 masks drop them)."""
    idx = row_idx.long()
    tile = torch.where(mask, idx[..., 0] // tile_rows, 0).to(torch.int32)
    bits = torch.ones_like(idx) << (idx % tile_rows)
    smask = bits[..., 0]
    for j in range(1, bits.shape[-1]):
        smask = smask | bits[..., j]
    return tile, torch.where(mask, smask, 0)


class DeviceEngine:
    def __init__(
        self, matrix: BitSliceMatrix, device=None, layout: str = "classic",
        tile_rows: int = TILE_ROWS,
    ):
        if layout != "classic" and layout not in TILED_LAYOUTS:
            raise ValueError("unknown layout %r" % layout)
        self.matrix = matrix
        self.device = resolve_device(device)
        self.layout = layout
        self.tile_rows = tile_rows
        self.tiled = layout in TILED_LAYOUTS
        self.words = load_words(
            np.asarray(matrix.words), self.device, tile_rows if self.tiled else None
        )
        if self.words.shape[0] >= 1 << 31:
            raise ValueError("row ids are int32: at most 2**31 - 1 rows")

    def _to_device(self, arr: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)).to(self.device)

    def _check_rows(self, row_idx: np.ndarray) -> None:
        # an id past the matrix would read out of bounds on the card
        if row_idx.size and (row_idx.min() < 0 or row_idx.max() >= self.matrix.num_rows):
            raise IndexError("row ids must lie in [0, %d)" % self.matrix.num_rows)

    def _reduce(self, row_idx: np.ndarray, mask: np.ndarray):
        """row ids int[B, K, h], bool[B, K] -> (counts int32[B, W * 32],
        exact int32[B, W]) on the device, through the layout's kernel."""
        self._check_rows(row_idx)
        idx = self._to_device(row_idx, np.int32)
        valid = self._to_device(mask, bool)
        if not self.tiled:
            return classic_counts(self.words, idx, valid)
        tile, smask = tile_streams(idx, valid, self.tile_rows)
        return tile_counts(self.words, tile, smask, self.tile_rows)

    # -- single query: `packed` is an opaque handle the facade passes
    #    back; the empty query stays a numpy array, as on the host engine

    def and_rows(self, row_idx: np.ndarray):
        if row_idx.shape[0] == 0:
            return np.empty((0, self.matrix.num_words), dtype=np.uint32)
        return _PackedQuery(np.asarray(row_idx))

    def _single(self, packed) -> tuple[np.ndarray, np.ndarray]:
        idx = packed.row_idx[None]
        counts, exact = self._reduce(idx, np.ones(idx.shape[:2], dtype=bool))
        return counts[0].cpu().numpy(), exact[0].cpu().numpy().view(np.uint32)

    def exact_colours(self, packed) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty(0, dtype=np.int64)
        exact = self._single(packed)[1]
        bits = np.unpackbits(exact.view(np.uint8), bitorder="little")
        return np.flatnonzero(bits[: self.matrix.num_cols]).astype(np.int64)

    def counts(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.zeros(num_cols, dtype=np.int64)
        return self._single(packed)[0][:num_cols].astype(np.int64)

    def presence_matrix(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty((0, num_cols), dtype=np.uint8)
        self._check_rows(packed.row_idx)
        idx = self._to_device(packed.row_idx, np.int32)
        if self.tiled:
            valid = torch.ones(idx.shape[0], dtype=torch.bool, device=self.device)
            tile, smask = tile_streams(idx, valid, self.tile_rows)
            rows = plain.blocked_presence(self.words, tile, smask, self.tile_rows)
        else:
            rows = plain.and_rows(self.words, idx)
        host = rows.cpu().numpy().view(np.uint32)
        bits = np.unpackbits(host.view(np.uint8), axis=-1, bitorder="little")
        return bits[:, :num_cols]

    # -- batched search (the serving path of search_batch / bulk_search)

    def counts_batch(
        self, row_idx: np.ndarray, mask: np.ndarray, num_cols: int
    ) -> np.ndarray:
        """row ids int[B, K, h] (padding k-mers hold any in-range id),
        mask bool[B, K] -> int64[B, num_cols], in one kernel launch."""
        b, k = mask.shape
        if b == 0 or k == 0:
            return np.zeros((b, num_cols), dtype=np.int64)
        counts, _ = self._reduce(row_idx, mask)
        return counts[:, :num_cols].cpu().numpy().astype(np.int64)

    def supports_kmer_batch(self) -> bool:
        return False  # the cols arm (counts_batch_kmers) is not ported yet

    def supports_seq_batch(self) -> bool:
        return False  # the seq arm (counts_batch_seqs) is not ported yet


class _PackedQuery:
    """One query's row ids; the engine reduces them on demand."""

    def __init__(self, row_idx: np.ndarray):
        self.row_idx = row_idx
