"""Plain PyTorch version of the seq serving arm's prep (kernel H).

The counterpart of ``bigsi_tpu/ops/prep_jax.py:prep_streams_device``,
re-stated here because that module imports jax: padded ASCII query bytes
-> the grouped streams of slot scheme 3 (2-bit codes, canonical k-mers,
splitmix64 slot fields, minimizer tiles, distinct-k-mer dedup, runs).
It is the reference of kernel H (:func:`bigsi_tpu_torch.ops.fused_lookup.
seq_streams`): the wrapper runs it for tensors on the CPU, the CPU tests
hold it bit for bit against the JAX function, and ``chip_smoke.py``
holds the kernel against it on the card.

Torch has no usable uint64, so 64-bit codes and hashes are int64 tensors
holding the same bits: multiplication and addition wrap alike, a logical
right shift masks off the sign fill (:func:`shr`), an unsigned compare
flips the sign bit on both sides (:func:`ult`), and the unsigned modulus
splits the value into 32-bit halves (:func:`umod`).  The TPU
workarounds of the JAX version (uint32 pairs, nibble long division,
one-hot compare-sums, ``PREP_CHUNK``) are not ported; the dedup is a
stable sort instead of the O(NK^2) pairwise compare.
"""

from __future__ import annotations

import torch

from bigsi_tpu.hashing.scheme import MINIMIZER_SEED

SIGN = -(1 << 63)  # int64 with only bit 63 set
MAX_SEQ_TILE_ROWS = 32  # slot masks of the seq arm are 32 bits, as in JAX
MAX_NUM_TILES = 1 << 31  # tile ids are int32


def as_int64(c: int) -> int:
    """A uint64 constant as the int64 holding the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


# splitmix64 (Steele et al. 2014), bigsi_tpu/hashing/scheme.py:splitmix64
SM_GAMMA = as_int64(0x9E3779B97F4A7C15)
SM_MUL1 = as_int64(0xBF58476D1CE4E5B9)
SM_MUL2 = as_int64(0x94D049BB133111EB)


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 <= n < 64."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (64 - n)) - 1)


def splitmix64(z: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer on int64 bit patterns."""
    z = z + SM_GAMMA
    z = (z ^ shr(z, 30)) * SM_MUL1
    z = (z ^ shr(z, 27)) * SM_MUL2
    return z ^ shr(z, 31)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b of int64 bit patterns."""
    return (a ^ SIGN) < (b ^ SIGN)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned minimum of int64 bit patterns."""
    return torch.where(ult(b, a), b, a)


def umod(x: torch.Tensor, d: int) -> torch.Tensor:
    """Unsigned x % d of int64 bit patterns, 1 <= d < 2^31: (hi * 2^32 +
    lo) % d from the halves, every term below 2^63."""
    hi, lo = shr(x, 32), x & 0xFFFFFFFF
    return ((hi % d) * ((1 << 32) % d) + lo) % d


def byte_codes(seqs: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> 2-bit codes (A and any other byte 0, C 1, G 2, T 3)."""
    b = seqs.long()
    return (b == ord("C")).long() + 2 * (b == ord("G")).long() + 3 * (b == ord("T")).long()


def byte_comp_codes(seqs: torch.Tensor) -> torch.Tensor:
    """2-bit codes of the complemented bases: only ACGT are complemented,
    any other byte keeps code 0 (scheme.py:pack_codes_v3)."""
    b = seqs.long()
    return 3 * (b == ord("A")).long() + 2 * (b == ord("C")).long() + (b == ord("G")).long()


def pack_windows(codes: torch.Tensor, length: int) -> torch.Tensor:
    """codes int64[B, L] -> int64[B, L - length + 1]: window i packs
    codes[i : i + length] MSB-first (the forward strand)."""
    count = codes.shape[1] - length + 1
    out = torch.zeros((codes.shape[0], count), dtype=torch.int64, device=codes.device)
    for j in range(length):
        out = (out << 2) | codes[:, j : j + count]
    return out


def pack_windows_rc(ccodes: torch.Tensor, length: int) -> torch.Tensor:
    """Complement codes -> reverse-complement windows: window i packs
    ccodes[i + length - 1], ..., ccodes[i] MSB-first."""
    count = ccodes.shape[1] - length + 1
    out = torch.zeros((ccodes.shape[0], count), dtype=torch.int64, device=ccodes.device)
    for j in reversed(range(length)):
        out = (out << 2) | ccodes[:, j : j + count]
    return out


def canonical(codes: torch.Tensor, ccodes: torch.Tensor, length: int):
    """-> (forward, canonical) codes of every window of ``length``: the
    canonical code is the unsigned minimum of the two strands'."""
    fwd = pack_windows(codes, length)
    return fwd, umin(fwd, pack_windows_rc(ccodes, length))


def check_prep_args(k, s, num_tiles, h, tile_rows, r, u_cap) -> None:
    """The limits kernel H and its plain version share."""
    if not 1 <= k <= 32 or not 1 <= s <= k:
        raise ValueError("the seq prep needs 1 <= s <= k <= 32, got k=%d s=%d" % (k, s))
    if not 1 <= h <= 10:
        raise ValueError("slot scheme 3 supports 1 <= h <= 10, got %d" % h)
    if tile_rows < 1 or tile_rows & (tile_rows - 1) or tile_rows > MAX_SEQ_TILE_ROWS:
        raise ValueError("the seq prep needs a power-of-two tile_rows up to %d, got %d"
                         % (MAX_SEQ_TILE_ROWS, tile_rows))
    if not 1 <= num_tiles < MAX_NUM_TILES:
        raise ValueError("num_tiles must be in [1, 2**31), got %d" % num_tiles)
    if r < 1 or u_cap < 0:
        raise ValueError("r must be positive and u_cap not negative, got %d, %d" % (r, u_cap))


def prep_streams(
    seqs: torch.Tensor, lens: torch.Tensor, *, k: int, s: int, num_tiles: int, h: int,
    tile_rows: int, r: int, u_cap: int, seed: int = MINIMIZER_SEED,
):
    """Slot-scheme-3 grouped streams from padded query bytes (plain kernel H).

    seqs uint8[B, L] (bytes past ``lens`` are any padding), lens
    int32[B] -> (utile int32[B, u_cap], gmask int64[B, u_cap, r] holding
    the uint32 masks, n_valid int32[B], ok bool[]), on the tensors'
    device; the contract of ``prep_streams_device``:

    * k-mer i of a query is valid when i < lens - k + 1; its slot mask
      ORs bit ``(hv >> 6j) & (tile_rows - 1)`` for j < h, hv the
      splitmix64 of its canonical code; its tile is the unsigned minimum
      of the seeded splitmix64 of the canonical s-mers it spans, modulo
      ``num_tiles``;
    * a valid k-mer whose forward code occurred at an earlier valid
      position is a duplicate: it keeps its slot with mask 0, and
      ``n_valid`` counts the rest (the reference's ``set(kmers)``);
    * a run of valid k-mers on one tile opens an entry at its start and
      every r positions after; slot j of entry u holds the run's k-mer
      at position ``u``'s start + j;
    * entries at or past ``u_cap`` are not written, ``ok`` is False when
      any query needs more, and everything not written is 0.
    """
    check_prep_args(k, s, num_tiles, h, tile_rows, r, u_cap)
    b, l = seqs.shape
    nk = l - k + 1
    if nk < 1:
        raise ValueError("the seq prep needs L >= k, got L=%d k=%d" % (l, k))
    dev = seqs.device
    codes, ccodes = byte_codes(seqs), byte_comp_codes(seqs)

    # per k-mer: forward code and slot mask
    fwd, canon = canonical(codes, ccodes, k)
    hv = splitmix64(canon)
    sm = torch.zeros_like(hv)
    for j in range(h):
        sm = sm | (1 << (shr(hv, 6 * j) & (tile_rows - 1)))

    # per k-mer: the minimizer tile over its w = k - s + 1 s-mers
    whash = splitmix64(canonical(codes, ccodes, s)[1] ^ seed)
    mn = (whash ^ SIGN).unfold(1, k - s + 1, 1).amin(dim=2) ^ SIGN  # [B, NK]
    tile = umod(mn, num_tiles)

    # dedup on the forward code: valid positions are a prefix, so a
    # stable sort puts each code's first valid occurrence at the head of
    # its group, and a valid k-mer behind an equal code is a duplicate
    iota = torch.arange(nk, device=dev)
    valid = iota[None, :] < (lens.long()[:, None] - (k - 1))
    order = torch.sort(fwd, dim=1, stable=True).indices
    ranked = fwd.gather(1, order)
    behind = torch.zeros_like(valid)
    behind[:, 1:] = ranked[:, 1:] == ranked[:, :-1]
    dup = torch.zeros_like(valid).scatter(1, order, behind) & valid
    appended = valid & ~dup
    n_valid = appended.sum(dim=1, dtype=torch.int32)
    sm = torch.where(appended, sm, 0)

    # runs and entries (duplicates keep their slot)
    prev = torch.cat([torch.full((b, 1), -1, dtype=torch.int64, device=dev), tile[:, :-1]], 1)
    new_run = valid & ((iota == 0) | (tile != prev))
    run_start = torch.where(new_run, iota, -1).cummax(dim=1).values
    pos = iota - run_start
    new_entry = valid & (pos % r == 0)
    entry = new_entry.long().cumsum(dim=1) - 1
    ok = (new_entry.sum(dim=1) <= u_cap).all()

    # scatter; what opens no entry, or lies past u_cap, lands in a spare
    # column that is cut off
    kept = entry < u_cap
    to = torch.where(new_entry & kept, entry, u_cap)
    utile = torch.zeros((b, u_cap + 1), dtype=torch.int64, device=dev).scatter_(1, to, tile)
    to = torch.where(valid & kept, entry * r + pos % r, u_cap * r)
    gmask = torch.zeros((b, (u_cap + 1) * r), dtype=torch.int64, device=dev).scatter_(1, to, sm)
    return (
        utile[:, :u_cap].to(torch.int32).contiguous(),
        gmask[:, : u_cap * r].reshape(b, u_cap, r).contiguous(),
        n_valid,
        ok,
    )
