"""Plain PyTorch versions of the lookup kernels.

Counterparts of ``bigsi_tpu/ops/lookup.py`` (``and_rows_jnp``,
``counts_from_packed``, ``exact_and_reduce``, ``query_counts_jnp``,
``batched_counts_jnp``, ``blocked_presence``, ``blocked_counts``,
``build_grouped_streams``, ``grouped_counts``, ``cols_dtype``,
``pack_tile_cols``, ``grouped_counts_cols``, ``cols_presence``),
re-stated here because that module imports jax.  They are the
reference of the CUDA kernels in :mod:`bigsi_tpu_torch.ops.fused_lookup`:
the kernels' wrappers run them for tensors on the CPU, the CPU tests
hold them against the JAX functions, and ``chip_smoke.py`` holds the
kernels against them on the card.

The bitslice matrix is ``int32[m, W]`` holding uint32 bit words (torch
has no complete uint32 arithmetic): bit ``n % 32`` of ``words[r, n //
32]`` is sample ``n`` of row ``r``.  Single bits are read as ``(x >> j)
& 1``, which is right on int32 although ``>>`` is arithmetic there.
Slot masks are int64, so tile_rows 64 keeps rows 32-63.  Padding k-mers
add nothing to counts and all ones to the exact AND.  The carry-save
popcount tree of the JAX package is not ported: it works around the
TPU's vector unit.
"""

from __future__ import annotations

import torch

ALL_ONES = -1  # int32 with every bit set
GROUP_R = 6  # slots per grouped entry when the index persists no run_len
U_BUCKET = 16  # grouped entries per query round up to a multiple of this


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


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., W * 32] -> int32[..., W]: bit n % 32 of word n // 32."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (bits.unflatten(-1, (-1, 32)).long() << shifts).sum(-1)
    return narrow_bits(v, torch.int32)


def narrow_bits(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The low bits of integer ``x`` as ``dtype`` (uint8, int16 or int32
    holding the unsigned bits), as a cast to the unsigned type of that
    width would keep them."""
    nbits = torch.iinfo(dtype).bits
    v = x.long() & ((1 << nbits) - 1)
    if dtype.is_signed:
        v = v - ((v >> (nbits - 1)) << nbits)
    return v.to(dtype)


def _select_and(g: torch.Tensor, smask: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """Gathered tiles int32[..., tile_rows, W], slot masks int64[...] ->
    int32[..., W], the AND of the rows whose bits are set (bit s = row
    s; bits at or past tile_rows select nothing)."""
    slots = torch.arange(tile_rows, dtype=torch.int64, device=g.device)
    sel = ((smask.long()[..., None] >> slots) & 1).bool()
    return and_reduce(torch.where(sel[..., None], g, ALL_ONES), -2)


def blocked_presence(words, tile, smask, tile_rows: int) -> torch.Tensor:
    """Tiled layouts: int32[m_pad, W] (m_pad a multiple of ``tile_rows``),
    tile ids int[K], slot masks int64[K] -> int32[K, W], the AND of the
    tile rows whose bits are set in each mask (bit s = row s)."""
    g = words.view(-1, tile_rows, words.shape[1])[tile.long()]  # [K, tile_rows, W]
    return _select_and(g, smask, tile_rows)


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


# -- grouped (tile-deduplicated) streams of the minimizer layout ----------


def build_grouped_streams(tile, smask, r: int = GROUP_R):
    """Per-k-mer streams -> grouped streams, on the tensors' device.

    tile int32[B, K], slot masks int64[B, K] (0 = padding k-mer) ->
    (utile int32[B, U], gmask int64[B, U, r]).  Each run of consecutive
    valid k-mers on one tile becomes one entry whose slots hold the run's
    masks in order; a run longer than ``r`` spills into a new entry with
    the same tile.  U is the largest entry count in the batch rounded up
    to a multiple of U_BUCKET (never below it); unused entries and slots
    are 0.
    """
    b, k = tile.shape
    dev = tile.device
    valid = smask != 0
    tt = torch.where(valid, tile.long(), -1)
    new = valid.clone()
    new[:, 1:] &= tt[:, 1:] != tt[:, :-1]
    idx = torch.arange(k, device=dev).expand(b, k)
    run_start = torch.where(new, idx, 0)
    if k:
        run_start = run_start.cummax(dim=1).values
    pos = idx - run_start  # position within the run (valid k-mers only)
    new_entry = new | (valid & (pos % r == 0))
    u_max = int(new_entry.sum(dim=1).max()) if b and k else 0
    u = max(U_BUCKET, -(-u_max // U_BUCKET) * U_BUCKET)
    entry = new_entry.long().cumsum(dim=1) - 1
    # scatter every k-mer; the ones that open no entry (or are padding)
    # land in a spare column that is cut off
    to = torch.where(new_entry, entry, u)
    utile = torch.zeros((b, u + 1), dtype=torch.int32, device=dev)
    utile.scatter_(1, to, tile.to(torch.int32))
    to = torch.where(valid, entry * r + pos % r, u * r)
    gmask = torch.zeros((b, (u + 1) * r), dtype=torch.int64, device=dev)
    gmask.scatter_(1, to, smask.long())
    return utile[:, :u].contiguous(), gmask[:, : u * r].reshape(b, u, r).contiguous()


def grouped_counts(words, utile, gmask, tile_rows: int):
    """Grouped streams over the row-major matrix (plain kernel C).

    words int32[m_pad, W] (m_pad a multiple of ``tile_rows``), utile
    int32[B, U], gmask int64[B, U, R] -> (counts int32[B, W * 32], exact
    int32[B, W]).  Each entry's tile is gathered once; slot j of entry u
    ANDs the tile rows its mask selects; slots with mask 0 add nothing
    to counts and all ones to exact."""
    b, u = utile.shape
    w = words.shape[1]
    g = words.view(-1, tile_rows, w)[utile.long()]  # [B, U, tile_rows, W]
    counts = torch.zeros((b, w * 32), dtype=torch.int32, device=words.device)
    exact = torch.full((b, w), ALL_ONES, dtype=torch.int32, device=words.device)
    for j in range(gmask.shape[2]):
        p = _select_and(g, gmask[:, :, j], tile_rows)  # [B, U, W]
        valid = gmask[:, :, j] != 0
        counts += counts_from_packed(p, valid)
        exact &= exact_and_reduce(p, valid)
    return counts, exact


def cols_dtype(tile_rows: int):
    """Narrowest type holding one sample's tile column: uint8, or int16 /
    int32 holding the uint16 / uint32 bits; None past 32 rows (no cols
    layout, the grouped row-major path serves)."""
    if tile_rows <= 8:
        return torch.uint8
    if tile_rows <= 16:
        return torch.int16
    if tile_rows <= 32:
        return torch.int32
    return None


PACK_CHUNK_BITS = 1 << 26  # unpacked bits per chunk of the plain pack_tile_cols


def pack_tile_cols(words, tile_rows: int):
    """Row-major tiles -> column-major tile columns (plain kernel D).

    words int32[m_pad, W] (m_pad a multiple of ``tile_rows``) ->
    cols[T, W * 32] of ``cols_dtype(tile_rows)``, T = m_pad / tile_rows:
    bit s of ``cols[t, n]`` is sample n's bit in row ``t * tile_rows +
    s``.  Chunked over tiles only to bound the unpacked intermediate."""
    dtype = cols_dtype(tile_rows)
    if dtype is None:
        raise ValueError("no cols layout for tile_rows=%d" % tile_rows)
    m, w = words.shape
    t = m // tile_rows
    tiles = words.view(t, tile_rows, w)
    out = torch.empty((t, w * 32), dtype=dtype, device=words.device)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    rows = torch.arange(tile_rows, dtype=torch.int64, device=words.device)
    chunk = max(1, PACK_CHUNK_BITS // max(1, tile_rows * w * 32))
    for t0 in range(0, t, chunk):
        blk = tiles[t0 : t0 + chunk]
        bits = ((blk[..., None] >> shifts) & 1).long()  # [tc, tile_rows, W, 32]
        col = (bits << rows[:, None, None]).sum(dim=1)  # [tc, W, 32]
        out[t0 : t0 + chunk] = narrow_bits(col.flatten(1), dtype)
    return out


def cols_presence(cols, tile, smask) -> torch.Tensor:
    """Presence rows from the cols layout: tile ids int[K], slot masks
    int64[K] -> int32[K, W], bit n % 32 of word n // 32 set iff
    ``(cols[tile, n] & g) == g`` with g the mask cut to the cols type
    (a mask of 0 gives all ones)."""
    g = cols[tile.long()]  # [K, N]
    sm = narrow_bits(smask, cols.dtype)[:, None]
    return pack_bits((g & sm) == sm)


def grouped_counts_cols(cols, utile, gmask, n_valid):
    """Grouped streams over the cols layout (plain kernel E).

    cols [T, N] (:func:`pack_tile_cols`), utile int32[B, U], gmask
    int64[B, U, R] (0 = padding slot), n_valid int32[B] -> (counts
    int32[B, N], exact int32[B, N / 32]).  ``counts[b, n]`` is the number
    of slots whose mask g (cut to the cols type) has ``(cols[utile[b, u],
    n] & g) == g``, less ``U * R - n_valid[b]``: padding slots compare
    true and the subtraction takes them out.  ``exact`` ANDs the presence
    bits over the slots with g != 0 (all ones when there are none)."""
    b, u = utile.shape
    r = gmask.shape[2]
    g = cols[utile.long()]  # [B, U, N]
    gm = narrow_bits(gmask, cols.dtype)
    counts = torch.zeros((b, cols.shape[1]), dtype=torch.int32, device=cols.device)
    every = torch.ones((b, cols.shape[1]), dtype=torch.bool, device=cols.device)
    for j in range(r):
        gj = gm[:, :, j, None]
        hit = (g & gj) == gj  # [B, U, N]
        counts += hit.sum(dim=1, dtype=torch.int32)
        every &= (hit | (gj == 0)).all(dim=1)
    counts -= (u * r - n_valid.to(torch.int32))[:, None]
    return counts, pack_bits(every)
