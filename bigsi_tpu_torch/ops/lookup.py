"""Plain PyTorch versions of the lookup kernels.

Counterparts of ``bigsi_tpu/ops/lookup.py`` (``and_rows_jnp``,
``counts_from_packed``, ``exact_and_reduce``, ``query_counts_jnp``,
``batched_counts_jnp``, ``blocked_presence``, ``blocked_counts``,
``build_grouped_streams``, ``grouped_counts``, ``cols_dtype``,
``pack_tile_cols``, ``grouped_counts_cols``, ``cols_presence``),
re-stated here because that module imports jax, with
``make_full_query_step`` (kernels I and A on the card),
``presence_rows`` (the three presence programs behind one call, with a
tile window for row slabs), and the plain versions
of the probes' kernels (``gather_rows``, ``tile_xor``, and
``blocked_counts`` without exact); ``field_hits`` and
``grouped_counts_cols_live`` restate kernel E's own arithmetic (its
packed field test and its live-slot counts), and ``plane_counts`` the
bit-plane counter of kernels B and C.  They are the
reference of the CUDA kernels in :mod:`bigsi_tpu_torch.ops.fused_lookup`:
the kernels' wrappers run them for tensors on the CPU, the CPU tests
hold them against the JAX functions, and ``chip_smoke.py`` holds the
kernels against them on the card.

The bitslice matrix is ``int32[m, W]`` holding uint32 bit words (torch
has no complete uint32 arithmetic): bit ``n % 32`` of ``words[r, n //
32]`` is sample ``n`` of row ``r``.  Single bits are read as ``(x >> j)
& 1``, which is right on int32 although ``>>`` is arithmetic there.
Slot masks are int64, so tile_rows 64 keeps rows 32-63.  Padding k-mers
add nothing to counts and all ones to the exact AND.
"""

from __future__ import annotations

import torch

ALL_ONES = -1  # int32 with every bit set
GROUP_R = 6  # slots per grouped entry when the index persists no run_len
U_BUCKET = 16  # grouped entries per query round up to a multiple of this


def _reduce_tree(x: torch.Tensor, dim: int, op, identity: int) -> torch.Tensor:
    """Reduce ``dim`` with the bitwise ``op`` as a halving tree (torch
    has no bitwise reductions); an empty axis gives ``identity``."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.full(x.shape[1:], identity, dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.full_like(x[:1], identity)])
        half = x.shape[0] // 2
        x = op(x[:half], x[half:])
    return x[0]


def and_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise AND over ``dim``; an empty axis gives all ones."""
    return _reduce_tree(x, dim, torch.bitwise_and, ALL_ONES)


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise XOR over ``dim``; an empty axis gives zeros."""
    return _reduce_tree(x, dim, torch.bitwise_xor, 0)


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


def make_full_query_step(m: int, h: int):
    """One serving step from raw ASCII k-mers to hit counts, classic
    layout: the counterpart of ``bigsi_tpu/ops/lookup.py:make_full_query_step``.

    step(words int32[m, W], kmers uint8[B, K, k], mask bool[B, K]) ->
    counts int32[B, W * 32].  On a CUDA device kernel I
    (:func:`~bigsi_tpu_torch.ops.fused_lookup.kmer_rows`: canonical
    k-mers, murmur3, floor-mod m) writes the rows int32[B, K, h] on the
    card and kernel A (:func:`~bigsi_tpu_torch.ops.fused_lookup.classic_counts`)
    counts them; the host only pads the batch.  On the CPU both wrappers
    run their plain versions."""
    from bigsi_tpu_torch.ops import fused_lookup

    seeds = {}  # device -> the seeds 0 .. h-1, made once

    def step(words, kmers, mask):
        if not isinstance(kmers, torch.Tensor) or kmers.dim() != 3:
            raise ValueError("kmers must be a [B, K, k] tensor")
        b, k, klen = kmers.shape
        if kmers.device not in seeds:
            seeds[kmers.device] = torch.arange(h, dtype=torch.int32, device=kmers.device)
        rows = fused_lookup.kmer_rows(kmers.reshape(b * k, klen), seeds[kmers.device],
                                      "classic", canonical=True, m=m)
        return fused_lookup.classic_counts(words, rows.view(b, k, h), mask)[0]

    return step


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


def select_and(g: torch.Tensor, smask: torch.Tensor, tile_rows: int) -> torch.Tensor:
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
    return select_and(g, smask, tile_rows)


def blocked_counts(words, tile, smask, tile_rows: int, exact: bool = True):
    """Tiled layouts, batched (plain kernel B): tile ids int[B, K], slot
    masks int64[B, K] (0 = padding k-mer) -> (counts int32[B, W * 32],
    exact int32[B, W]); exact is None without ``exact``."""
    b, k = tile.shape
    packed = blocked_presence(
        words, tile.reshape(-1), smask.reshape(-1), tile_rows
    ).reshape(b, k, words.shape[1])
    valid = smask != 0
    return counts_from_packed(packed, valid), exact_and_reduce(packed, valid) if exact else None


# -- the probes' kernels ----------------------------------------------------


def gather_rows(mat, idx):
    """Random-row gather (plain kernel F): int32[m, Wr], row ids int[n]
    -> int32[n, Wr]."""
    return mat[idx.long()]


def tile_xor(words, tile, valid, tile_rows: int):
    """Whole-tile XOR (plain kernel G): int32[m_pad, W] (m_pad a multiple
    of ``tile_rows``), tile ids int[B, K], validity bool[B, K] ->
    int32[B, tile_rows, W], per query the XOR of the tiles
    ``words[t * tile_rows : (t + 1) * tile_rows]`` of its valid k-mers
    (zeros when none is valid)."""
    g = words.view(-1, tile_rows, words.shape[1])[tile.long()]  # [B, K, tile_rows, W]
    return xor_reduce(torch.where(valid[..., None, None], g, 0), 1)


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
        p = select_and(g, gmask[:, :, j], tile_rows)  # [B, U, W]
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


PRESENCE_SOURCES = ("classic", "slot", "cols")


def presence_rows(matrix, source: str, idx, smask=None, tile_rows: int = 1, window=None):
    """Scoring's presence rows (plain kernel L): -> int32[K, W], bit n %
    32 of word n // 32 set iff sample n holds the k-mer.

    ``source`` "classic": matrix int32[m, W], idx row ids int[K, h] ->
    :func:`and_rows`.  "slot": matrix int32[T * tile_rows, W], idx tile ids
    int[K], smask int64[K] -> :func:`blocked_presence`.  "cols": matrix
    cols[T, W * 32], idx and smask as for "slot" -> :func:`cols_presence`.
    The tiled sources take the tile window ``(t0, t1)`` (None: ``(0,
    T)``), the matrix holding tiles t0 onwards: a k-mer whose tile lies
    outside the window gives 0, so the rows of a mesh's or a fleet's row
    slabs OR into the whole."""
    if source == "classic":
        return and_rows(matrix, idx)
    if window is None:
        window = (0, matrix.shape[0] // (1 if source == "cols" else tile_rows))
    t0, t1 = window
    tile = idx.long()
    here = (tile >= t0) & (tile < t1)
    local = torch.where(here, tile - t0, 0)
    if source == "slot":
        rows = blocked_presence(matrix, local, smask, tile_rows)
    else:
        rows = cols_presence(matrix, local, smask)
    return torch.where(here[:, None], rows, 0)


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


FIELD_LOW = {8: 0x7F7F7F7F, 16: 0x7FFF7FFF}  # a field's bits below its top one


def field_hits(x: torch.Tensor, g: torch.Tensor, bits: int) -> torch.Tensor:
    """Kernel E's packed presence test on 32-bit words of ``bits``-wide
    fields (8 or 16): x and g int64 holding the words, g a slot mask
    repeated in every field -> the word with the top bit of field f set
    iff ``(x_f & g_f) == g_f``.  ``d = ~x & g`` is zero in exactly the
    fields that are in; adding the bits below a field's top one to
    ``low`` carries into the top bit iff any is set, and OR-ing ``d``
    adds the top bit itself; no carry crosses a field."""
    low = FIELD_LOW[bits]
    d = ~x & g & 0xFFFFFFFF
    return ~(((d & low) + low) | d) & (low ^ 0xFFFFFFFF)


PLANES = 16  # count bits per sample in kernels B's and C's counters
U32 = 0xFFFFFFFF


def csa(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Carry-save adder on u32 words held in int64: -> (hi, lo) with ``hi
    * 2 + lo == a + b + c`` at every bit."""
    u = a ^ b
    return (a & b) | (u & c), u ^ c


def unpack_planes(planes) -> torch.Tensor:
    """Bit planes [int64[...] holding u32] -> int64[..., 32]: count j is
    the sum over d of bit j of plane d, times 2**d."""
    shifts = torch.arange(32, dtype=torch.int64)
    out = 0
    for d, plane in enumerate(planes):
        out = out + (((plane[..., None] >> shifts.to(plane.device)) & 1) << d)
    return out


def plane_counts(words: torch.Tensor, planes: int = PLANES) -> torch.Tensor:
    """Kernels B's and C's bit-plane counter, plain: presence words
    int64[n, ...] holding u32 (0 adds nothing) -> int64[..., 32], per bit
    j the number of words with bit j set.  As a lane of the kernels
    counts: words enter eight at a time (the last eight padded with
    zeros) through a Harley-Seal tree of carry-save adders into planes
    0-2; its carry of eights ripples into planes 3 and up, only as deep
    as the bit length of ``since``, the words added since the last
    flush, which bounds every count; the planes flush into the counts
    before a count could pass ``2**planes - 1``, and at the end.  Fewer
    ``planes`` than the kernels' 16 make the flush testable at small n."""
    if planes < 4:
        raise ValueError("the counter needs at least 4 planes, got %d" % planes)
    w = words.long() & U32
    rest = w.shape[1:]
    w = torch.cat([w, w.new_zeros((-w.shape[0] % 8, *rest))])
    p = [w.new_zeros(rest) for _ in range(planes)]
    counts = w.new_zeros((*rest, 32))
    since, limit = 0, (1 << planes) - 1
    for g in range(0, w.shape[0], 8):
        if since > limit - 8:
            counts += unpack_planes(p[: since.bit_length()])
            p, since = [w.new_zeros(rest) for _ in range(planes)], 0
        c = w[g : g + 8]
        t1, p[0] = csa(p[0], c[0], c[1])
        t2, p[0] = csa(p[0], c[2], c[3])
        f1, p[1] = csa(p[1], t1, t2)
        t1, p[0] = csa(p[0], c[4], c[5])
        t2, p[0] = csa(p[0], c[6], c[7])
        f2, p[1] = csa(p[1], t1, t2)
        e, p[2] = csa(p[2], f1, f2)
        since += 8
        for d in range(3, since.bit_length()):
            p[d], e = p[d] ^ e, p[d] & e
    return counts + unpack_planes(p[: since.bit_length()])


def _in_flags(rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """cols rows [L, N], cut masks [L] -> bool [L, N], ``(x & g) == g``
    as kernel E tests it: narrow rows as 32-bit words through
    :func:`field_hits`."""
    bits = torch.iinfo(rows.dtype).bits
    if bits == 32:
        return (rows & g[:, None]) == g[:, None]
    words = rows.contiguous().view(torch.int32).long() & 0xFFFFFFFF  # little-endian fields
    rep = (g.long() & ((1 << bits) - 1)) * (0x01010101 if bits == 8 else 0x00010001)
    flags = field_hits(words, rep[:, None], bits)
    tops = torch.arange(bits - 1, 32, bits, device=rows.device)
    return ((flags[..., None] >> tops) & 1).bool().flatten(-2)


def grouped_counts_cols_live(cols, utile, gmask, n_valid):
    """Kernel E's own arithmetic, plain: per query, the live slots (mask
    nonzero once cut to the cols type) in entry order; ``counts = hits
    over the live slots + n_valid - live`` and ``exact`` the AND over
    them.  Equal to :func:`grouped_counts_cols` bit for bit, since a
    padding slot compares true."""
    b = utile.shape[0]
    gm = narrow_bits(gmask, cols.dtype)
    counts = torch.empty((b, cols.shape[1]), dtype=torch.int32, device=cols.device)
    every = torch.empty((b, cols.shape[1]), dtype=torch.bool, device=cols.device)
    for q in range(b):
        ent, slot = (gm[q] != 0).nonzero(as_tuple=True)  # row-major: entry order
        hit = _in_flags(cols[utile[q, ent].long()], gm[q, ent, slot])
        counts[q] = hit.sum(dim=0, dtype=torch.int32) + int(n_valid[q]) - ent.numel()
        every[q] = hit.all(dim=0)
    return counts, pack_bits(every)
