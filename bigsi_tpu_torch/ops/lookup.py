"""Plain PyTorch versions of the lookup kernels.

Counterparts of ``bigsi_tpu/ops/lookup.py`` (``and_rows_jnp``,
``counts_from_packed``, ``exact_and_reduce``, ``query_counts_jnp``,
``batched_counts_jnp``, ``blocked_presence``, ``blocked_counts``).  They
are the reference of the CUDA kernels in
:mod:`bigsi_tpu_torch.ops.fused_lookup`: the kernels' wrappers run them
for tensors on the CPU, the CPU tests hold them against the JAX
functions, and ``chip_smoke.py`` holds the kernels against them on the
card.

The bitslice matrix is ``int32[m, W]`` holding uint32 bit words (torch
has no complete uint32 arithmetic): bit ``n % 32`` of ``words[r, n //
32]`` is sample ``n`` of row ``r``.  Single bits are read as ``(x >> j)
& 1``, which is right on int32 although ``>>`` is arithmetic there.
Padding k-mers add nothing to counts and all ones to the exact AND.
The carry-save popcount tree of the JAX package is not ported: it works
around the TPU's vector unit.
"""

from __future__ import annotations

import torch

ALL_ONES = -1  # int32 with every bit set


def and_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise AND over ``dim`` (torch has no AND reduction), as a
    halving tree; an empty axis gives all ones."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.full(x.shape[1:], ALL_ONES, dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.full_like(x[:1], ALL_ONES)])
        half = x.shape[0] // 2
        x = x[:half] & x[half:]
    return x[0]


def counts_from_packed(packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample hit counts: int32[..., K, W], bool[..., K] ->
    int32[..., W * 32] in sample order."""
    masked = torch.where(mask[..., None], packed, 0)
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (masked[..., None] >> shifts) & 1  # [..., K, W, 32]
    return bits.sum(dim=-3, dtype=torch.int32).flatten(-2)


def exact_and_reduce(packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """AND over the valid k-mers: int32[..., K, W], bool[..., K] ->
    int32[..., W]."""
    return and_reduce(torch.where(mask[..., None], packed, ALL_ONES), -2)


def and_rows(words: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """Presence rows: int32[m, W], row ids int[K, h] -> int32[K, W],
    the AND of each k-mer's h rows."""
    rows = words[row_idx.reshape(-1).long()]
    return and_reduce(rows.reshape(*row_idx.shape, words.shape[1]), -2)


def query_counts(words, row_idx, mask):
    """One query: row ids int[K, h], bool[K] -> (counts int32[W * 32],
    exact int32[W])."""
    packed = and_rows(words, row_idx)
    return counts_from_packed(packed, mask), exact_and_reduce(packed, mask)


def batched_counts(words, row_idx, mask):
    """Classic layout, batched (plain kernel A): row ids int[B, K, h],
    bool[B, K] -> (counts int32[B, W * 32], exact int32[B, W])."""
    b, k, h = row_idx.shape
    packed = and_rows(words, row_idx.reshape(b * k, h))
    packed = packed.reshape(b, k, words.shape[1])
    return counts_from_packed(packed, mask), exact_and_reduce(packed, mask)


def blocked_presence(words, tile, smask, tile_rows: int) -> torch.Tensor:
    """Tiled layouts: int32[m_pad, W] (m_pad a multiple of ``tile_rows``),
    tile ids int[K], slot masks int64[K] -> int32[K, W], the AND of the
    tile rows whose bits are set in each mask (bit s = row s)."""
    w = words.shape[1]
    g = words.view(-1, tile_rows, w)[tile.long()]  # [K, tile_rows, W]
    slots = torch.arange(tile_rows, dtype=torch.int64, device=words.device)
    sel = ((smask.long()[:, None] >> slots) & 1).bool()
    return and_reduce(torch.where(sel[..., None], g, ALL_ONES), -2)


def blocked_counts(words, tile, smask, tile_rows: int):
    """Tiled layouts, batched (plain kernel B): tile ids int[B, K], slot
    masks int64[B, K] (0 = padding k-mer) -> (counts int32[B, W * 32],
    exact int32[B, W])."""
    b, k = tile.shape
    packed = blocked_presence(
        words, tile.reshape(-1), smask.reshape(-1), tile_rows
    ).reshape(b, k, words.shape[1])
    valid = smask != 0
    return counts_from_packed(packed, valid), exact_and_reduce(packed, valid)
