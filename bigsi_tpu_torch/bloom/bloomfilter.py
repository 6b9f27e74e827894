"""Bloom filters over k-mers.

Reference behavior (``bigsi/bloom/bloomfilter.py``): h = ``mmh3`` hash
values per element, seeds ``0..h-1``, floor-mod ``m``; bits stored in a
length-``m`` bitarray; files are the raw bit bytes (MSB-first).  The
in-memory representation here is a numpy bool array; insertion is a
vectorized hash of the whole k-mer batch followed by one scatter —
no per-kmer Python loop.
"""

from __future__ import annotations

import numpy as np

from bigsi_tpu_torch.hashing.murmur3 import generate_hashes, hash_kmer_matrix
from bigsi_tpu_torch.kmers import ascii_to_strings, seq_to_ascii
from bigsi_tpu_torch.matrix.packing import bloom_bytes_to_bools, bools_to_bloom_bytes


def build_bloom_from_kmer_matrix(
    kmers: np.ndarray, m: int, h: int, out: np.ndarray | None = None,
    layout: str = "classic", tile_rows: int = 32,
    window: int | None = None, slot_scheme: int | None = None,
) -> np.ndarray:
    """Set the Bloom bits for an ASCII k-mer matrix [K, k] -> bool [m]."""
    import os

    if out is None:
        out = np.zeros(m, dtype=bool)
    if kmers.shape[0]:
        if (
            layout == "classic"
            and out.flags.c_contiguous
            and not os.environ.get("BIGSI_TPU_NO_NATIVE")
        ):
            from bigsi_tpu_torch import native

            # bool and uint8 share layout; the native hasher+setter skips
            # materializing the [K, h] index matrix entirely
            if native.bloom_insert_batch(kmers, h, m, out.view(np.uint8)):
                return out
        from bigsi_tpu_torch.hashing.scheme import default_slot_scheme, row_indices

        if slot_scheme is None:
            slot_scheme = default_slot_scheme(layout)
        idx = row_indices(
            kmers, h, m, layout, tile_rows, window=window,
            slot_scheme=slot_scheme,
        )
        out[idx.ravel()] = True
    return out


class BloomFilter:
    """API-compatible with the reference ``BloomFilter(m, h)``."""

    def __init__(
        self, m: int, h: int, layout: str = "classic", tile_rows: int = 32,
        window: int | None = None, slot_scheme: int | None = None,
    ):
        self.m = int(m)
        self.h = int(h)
        self.layout = layout
        self.tile_rows = int(tile_rows)
        self.window = window
        if slot_scheme is None:
            from bigsi_tpu_torch.hashing.scheme import default_slot_scheme

            slot_scheme = default_slot_scheme(layout)
        self.slot_scheme = int(slot_scheme)
        self.array = np.zeros(self.m, dtype=bool)

    @property
    def bitarray(self) -> np.ndarray:
        return self.array

    def add(self, element: str) -> None:
        if self.layout != "classic":
            from bigsi_tpu_torch.hashing.scheme import row_indices

            idx = row_indices(
                seq_to_ascii(element)[None, :], self.h, self.m,
                self.layout, self.tile_rows, window=self.window,
                slot_scheme=self.slot_scheme,
            )
            self.array[idx.ravel()] = True
            return
        for i in generate_hashes(element, self.h, self.m):
            self.array[i] = True

    def update(self, elements) -> "BloomFilter":
        elems = list(elements)
        if elems:
            k = len(elems[0])
            if all(len(e) == k for e in elems):
                mat = np.stack([seq_to_ascii(e) for e in elems])
                build_bloom_from_kmer_matrix(
                    mat, self.m, self.h, out=self.array, layout=self.layout,
                    tile_rows=self.tile_rows, window=self.window,
                    slot_scheme=self.slot_scheme,
                )
            else:
                for e in elems:
                    self.add(e)
        return self

    def tofile(self, fileobj) -> None:
        fileobj.write(bools_to_bloom_bytes(self.array))


def save_bloom_file(path: str, bits: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(bools_to_bloom_bytes(bits))


def load_bloom_file(path: str, m: int | None = None) -> np.ndarray:
    """Load a reference-layout ``.bloom`` file -> bool array.

    Mirrors ``bigsi/cmds/build.py:22-28``; without ``m`` the byte-padding
    bits are kept, as ``bitarray.fromfile`` does.
    """
    with open(path, "rb") as f:
        return bloom_bytes_to_bools(f.read(), m)


class LazyBloomFile:
    """A ``.bloom`` file as a lazily-unpacked bool sequence.

    Build-scale memory fix: a dense bool bloom costs ``m`` bytes of RAM
    (25 MB at the default m; 250 GB for a 10k-sample build), but the
    chunked transpose (``matrix.bitmatrix.transpose_blooms``) only ever
    reads ``b[r0:r1]`` slices.  This wrapper mmaps the packed bit bytes
    (``m/8``, OS page cache managed) and unpacks per-slice on demand.

    Duck-compatible with the dense path: ``len``, slice ``__getitem__``,
    ``__array__`` (full densify when a consumer truly needs it), and a
    ``bitarray`` property returning itself so ``KmerSignatureIndex.create``
    passes it through un-coerced.
    """

    def __init__(self, path: str, m: int | None = None):
        self._bytes = np.memmap(path, dtype=np.uint8, mode="r")
        self.m = int(m) if m is not None else len(self._bytes) * 8
        if self.m > len(self._bytes) * 8:
            raise ValueError(
                "%s holds %d bits, config expects m=%d"
                % (path, len(self._bytes) * 8, self.m)
            )

    @property
    def bitarray(self) -> "LazyBloomFile":
        return self

    def __len__(self) -> int:
        return self.m

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self.m)
            if step != 1:
                return self.__array__()[key]
            b0, b1 = start // 8, (stop + 7) // 8
            bits = np.unpackbits(self._bytes[b0:b1], bitorder="big")
            return bits[start - b0 * 8 : start - b0 * 8 + (stop - start)].astype(bool)
        i = key.__index__()
        if i < 0:
            i += self.m  # ndarray-style wraparound
        if not 0 <= i < self.m:
            raise IndexError("bit %d out of range for m=%d" % (key, self.m))
        return bool(self.__getitem__(slice(i, i + 1))[0])

    def __array__(self, dtype=None, copy=None):
        out = np.unpackbits(np.asarray(self._bytes), bitorder="big")[: self.m].astype(bool)
        return out.astype(dtype) if dtype is not None else out
