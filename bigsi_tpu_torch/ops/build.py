"""On-device index construction: one sample's bloom, and blooms to the
bitslice matrix.

The counterpart of ``bigsi_tpu/ops/build_jax.py`` (``device_bloom``,
``device_transpose``), re-stated here because that module imports jax.
Both give the host build pipeline's bits exactly
(:class:`bigsi_tpu_torch.bloom.BloomFilter`,
:func:`bigsi_tpu_torch.matrix.bitmatrix.transpose_blooms`), so blooms and
matrices built either way mix.

* :func:`device_bloom` launches kernel J
  (:func:`bigsi_tpu_torch.ops.fused_lookup.bloom_scatter`) for a tensor
  on a CUDA device: canonical k-mers, murmur3 rows and an atomic OR of
  their bits.
* :func:`device_transpose` launches kernel K
  (:func:`bigsi_tpu_torch.ops.fused_lookup.bloom_transpose`).

For tensors on the CPU they run the plain versions below (a bool
scatter and an LSB-first pack; a chunked unpack, transpose and pack),
which ``chip_smoke.py`` also holds the kernels to on the card.  Numpy
inputs go to ``device`` (None means CUDA).  Bloom words and matrix words
are int32 tensors holding the uint32 bits.
"""

from __future__ import annotations

import torch

from bigsi_tpu_torch.ops import hash as kmer_hash
from bigsi_tpu_torch.ops.lookup import pack_bits

TILE_ROWS = 32


def bloom_plain(kmers: torch.Tensor, seeds: torch.Tensor, out: str, m: int,
                tile_rows: int = 1) -> torch.Tensor:
    """Kernel J's contract, plain: the bits of the canonical k-mers' rows
    (:func:`bigsi_tpu_torch.ops.hash.kmer_rows_plain` with ``out``
    "classic" or "blocked") set in a zeroed bloom, packed LSB-first ->
    int32[ceil(m / 32)].  Rows past the last word are dropped."""
    rows = kmer_hash.kmer_rows_plain(kmers, seeds, out, True, m, tile_rows).reshape(-1).long()
    bits = torch.zeros(-(-m // 32) * 32, dtype=torch.bool, device=kmers.device)
    bits[rows[rows < bits.numel()]] = True
    return pack_bits(bits)


def transpose_plain(blooms: torch.Tensor, m: int, rows_chunk: int = 4096) -> torch.Tensor:
    """Kernel K's contract, plain: packed blooms int32[N, MW] -> int32[m,
    ceil(N / 32)], ``rows_chunk`` bit positions (rows) a chunk: unpack,
    transpose, zero-pad the samples to whole words, pack."""
    n, mw = blooms.shape
    w = -(-n // 32)
    wc = max(1, rows_chunk // 32)
    shifts = torch.arange(32, dtype=torch.int32, device=blooms.device)
    chunks = []
    for c0 in range(0, -(-m // 32), wc):
        sl = blooms[:, c0 : c0 + wc]
        bits = ((sl[:, :, None] >> shifts) & 1).bool().reshape(n, -1)  # [N, rows]
        padded = torch.zeros((bits.shape[1], w * 32), dtype=torch.bool, device=blooms.device)
        padded[:, :n] = bits.t()
        chunks.append(pack_bits(padded))
    if not chunks:
        return torch.empty((0, w), dtype=torch.int32, device=blooms.device)
    return torch.cat(chunks)[:m]


def device_bloom(kmers, *, m: int, h: int, layout: str = "classic",
                 tile_rows: int = TILE_ROWS, device=None) -> torch.Tensor:
    """ASCII k-mers uint8[K, k] -> packed bloom int32[ceil(m / 32)].

    Matches ``BIGSI.bloom`` (canonicalize, hash with seeds 0 .. h-1,
    floor-mod m) for the classic layout, and the blocked layout's rows
    (seed 0 the tile, seeds 1 .. h the slots); minimizer tiles need the
    host's s-mer windows and raise ``ValueError``."""
    if layout not in ("classic", "blocked"):
        raise ValueError("device_bloom supports classic/blocked, not %r" % layout)
    kmers = kmer_hash.as_tensor(kmers, device)
    nseeds = h + 1 if layout == "blocked" else h
    seeds = torch.arange(nseeds, dtype=torch.int32, device=kmers.device)
    from bigsi_tpu_torch.ops import fused_lookup

    return fused_lookup.bloom_scatter(kmers, seeds, layout, m,
                                      tile_rows if layout == "blocked" else 1)


def device_transpose(blooms, m: int, rows_chunk: int = 4096, device=None) -> torch.Tensor:
    """Packed blooms int32[N, MW] -> packed bitslice matrix int32[m, W].

    W is exactly ceil(N / 32), not padded to the host's lane words
    (callers pad for their layouts); the padding samples' bits are 0 and
    the rows are cut to m.  ``rows_chunk`` bounds the plain version's
    unpacked chunk (N x rows_chunk bytes); the kernel needs no chunks."""
    from bigsi_tpu_torch.ops import fused_lookup

    return fused_lookup.bloom_transpose(kmer_hash.as_tensor(blooms, device), m, rows_chunk)
