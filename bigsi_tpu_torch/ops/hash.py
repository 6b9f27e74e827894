"""On-device k-mer hashing: MurmurHash3_x86_32, canonical k-mers, bloom rows.

The counterpart of ``bigsi_tpu/ops/hash_jax.py`` (``murmur3_32_jax``,
``canonicalize_jax``, ``row_indices_jax``), re-stated here because that
module imports jax, plus the blocked rows that
``bigsi_tpu/ops/build_jax.py:54-60`` computes.  Bit-exact with the host
hashers (:mod:`bigsi_tpu_torch.hashing.murmur3`, the reference's
``mmh3.hash``): golden value ``row_indices("ATT", 3, 25) == {2, 15, 17}``.

Every public function takes tensors where they lie, or numpy arrays,
which go to ``device`` (None means CUDA; a CUDA request without CUDA
raises).  For tensors on a CUDA device they launch kernel I
(:func:`bigsi_tpu_torch.ops.fused_lookup.kmer_rows`); for tensors on the
CPU they run the plain versions below, which ``chip_smoke.py`` also holds
the kernel to on the card.

The plain versions keep u32 values in int64 tensors masked with
``0xFFFFFFFF``: torch's ``>>`` on int32 is an arithmetic shift, where
murmur3's shifts are logical; an int64 product of two u32 values may
wrap, which leaves its low 32 bits right.  The signed hash then takes
Python's floor-mod (torch's ``%`` on int64), so -5 mod 25 is 20.
"""

from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF
C1, C2 = 0xCC9E2D51, 0x1B873593
KMER_OUTS = ("hashes", "classic", "blocked", "canonical")  # what kernel I writes

# ASCII complement: A<->T, C<->G, every other byte itself
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor where it lies; a numpy array on ``device`` (None: CUDA)."""
    if isinstance(x, torch.Tensor):
        return x
    from bigsi_tpu_torch.index.device_engine import resolve_device

    return torch.from_numpy(np.require(x, requirements=["C", "W"])).to(resolve_device(device))


def seed_tensor(seeds, device) -> torch.Tensor:
    """Seeds (any ints, taken mod 2^32) -> int32[S] holding the u32 bits."""
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    s = np.asarray(seeds, dtype=np.int64).reshape(-1) & U32
    return torch.from_numpy(s.astype(np.uint32).view(np.int32)).to(device)


# -- the plain versions (kernel I's reference) --------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & U32


def _block(kw: torch.Tensor) -> torch.Tensor:
    return (_rotl((kw * C1) & U32, 15) * C2) & U32


def murmur3_plain(data: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """uint8[K, k] x int32[S] (u32 bits) -> int64[K, S] holding the u32
    hashes."""
    n, k = data.shape
    d = data.long()
    h = (seeds.long() & U32)[None, :].expand(n, -1)
    for i in range(k // 4):
        b = d[:, 4 * i : 4 * i + 4]
        kw = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
        h = h ^ _block(kw)[:, None]
        h = (_rotl(h, 13) * 5 + 0xE6546B64) & U32
    if k % 4:
        kw = torch.zeros(n, dtype=torch.int64, device=data.device)
        for j in range(k % 4):
            kw = kw | (d[:, k // 4 * 4 + j] << (8 * j))
        h = h ^ _block(kw)[:, None]
    h = h ^ k
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & U32
    return h ^ (h >> 16)


def signed(h: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 bits -> the same bits' signed int32 value, int64."""
    return h - ((h >> 31) << 32)


def canonicalize_plain(kmers: torch.Tensor) -> torch.Tensor:
    """uint8[..., k] -> uint8[..., k]: each k-mer or its reverse
    complement, whichever is smaller in byte order."""
    if kmers.shape[-1] == 0 or kmers.numel() == 0:
        return kmers.clone()
    comp = torch.from_numpy(_COMP).to(kmers.device)
    rc = comp[kmers.flip(-1).long()]
    diff = kmers != rc
    first = diff.to(torch.uint8).argmax(dim=-1, keepdim=True)  # first differing byte
    take_rc = diff.any(dim=-1, keepdim=True) & (rc.gather(-1, first) < kmers.gather(-1, first))
    return torch.where(take_rc, rc, kmers)


def kmer_rows_plain(kmers: torch.Tensor, seeds: torch.Tensor, out: str,
                    canonical: bool = False, m: int = 1, tile_rows: int = 1) -> torch.Tensor:
    """Kernel I's contract, plain: kmers uint8[K, k], seeds int32[S] ->
    ``out`` "hashes" int32[K, S] (the signed hashes), "classic" int32[K, S]
    (floor-mod m), "blocked" int32[K, S - 1] (seed 0's hash floor-mod
    max(1, m // tile_rows) the tile, the others' floor-mod tile_rows the
    slots: tile * tile_rows + slot), "canonical" uint8[K, k].  With
    ``canonical`` the k-mers' canonical forms are hashed."""
    if out == "canonical" or canonical:
        kmers = canonicalize_plain(kmers)
        if out == "canonical":
            return kmers
    h = signed(murmur3_plain(kmers, seeds))
    if out == "hashes":
        return h.to(torch.int32)
    if out == "classic":
        return (h % m).to(torch.int32)
    num_tiles = max(1, m // tile_rows)
    return ((h[:, :1] % num_tiles) * tile_rows + h[:, 1:] % tile_rows).to(torch.int32)


# -- the public functions: kernel I on CUDA, the plain versions on the CPU --


def _kmer_rows(kmers, seeds, out, **kw):
    from bigsi_tpu_torch.ops import fused_lookup

    return fused_lookup.kmer_rows(kmers, seeds, out, **kw)


def murmur3_32(data, seeds, device=None) -> torch.Tensor:
    """MurmurHash3_x86_32: uint8[K, k] x seeds (any ints, mod 2^32) ->
    int32[K, len(seeds)], ``mmh3.hash``'s signed result for every row and
    seed."""
    data = as_tensor(data, device)
    return _kmer_rows(data, seed_tensor(seeds, data.device), "hashes")


def canonicalize(kmers, device=None) -> torch.Tensor:
    """uint8[..., k] -> uint8[..., k]: min(k-mer, reverse complement) in
    byte order (the reference's ``canonical``); bytes other than ACGT
    complement to themselves."""
    kmers = as_tensor(kmers, device)
    if kmers.dim() < 1:
        raise ValueError("kmers must be [..., k]")
    if kmers.numel() == 0:
        return kmers.clone()
    empty = torch.empty(0, dtype=torch.int32, device=kmers.device)
    flat = kmers.reshape(-1, kmers.shape[-1]).contiguous()
    return _kmer_rows(flat, empty, "canonical").view(kmers.shape)


def row_indices(kmers, h: int, m: int, device=None) -> torch.Tensor:
    """Classic bloom rows: uint8[K, k] -> int32[K, h], the hashes of seeds
    0 .. h-1 floor-mod m (``hashing.murmur3.hash_kmer_matrix``)."""
    kmers = as_tensor(kmers, device)
    seeds = torch.arange(h, dtype=torch.int32, device=kmers.device)
    return _kmer_rows(kmers, seeds, "classic", m=m)


def blocked_row_indices(kmers, h: int, m: int, tile_rows: int, device=None) -> torch.Tensor:
    """Blocked bloom rows: uint8[K, k] -> int32[K, h]; seed 0's hash
    floor-mod max(1, m // tile_rows) is the tile, seeds 1 .. h floor-mod
    tile_rows the slots, row = tile * tile_rows + slot
    (``hashing.scheme.row_indices`` with layout blocked)."""
    kmers = as_tensor(kmers, device)
    seeds = torch.arange(h + 1, dtype=torch.int32, device=kmers.device)
    return _kmer_rows(kmers, seeds, "blocked", m=m, tile_rows=tile_rows)
