"""Bit-packing layouts.

Two layouts coexist:

* **Bloom-file layout** (reference-compatible): a Bloom filter is ``m``
  bits written as ``ceil(m/8)`` bytes, MSB-first within each byte —
  byte-identical to ``bitarray.tofile`` (``bigsi/cmds/bloom.py:26-27``),
  so reference ``.bloom`` files interoperate both ways.

* **Matrix layout** (TPU-native): sample/colour bits of one bitslice row
  are packed LSB-first into little-endian ``uint32`` lanes: sample ``n``
  lives at word ``n >> 5``, bit ``n & 31``.  ``W = ceil(N/32)`` words
  per row; a whole index is ``uint32[m, W]``.  LSB-first makes
  unpacking on device a shift-and-mask with ``n = 32*w + b`` row-major
  reshape, and 128-lane tiling wants the minor axis in words, not bytes.
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 32


def words_for(num_bits: int) -> int:
    return (num_bits + WORD_BITS - 1) // WORD_BITS


def pack_bits_lsb(bits: np.ndarray) -> np.ndarray:
    """Pack bool/0-1 array [..., N] -> uint32 [..., ceil(N/32)] LSB-first."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[-1]
    w = words_for(n)
    pad = w * WORD_BITS - n
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), dtype=np.uint8)], axis=-1
        )
    packed8 = np.packbits(bits, axis=-1, bitorder="little")
    return packed8.view(np.uint32) if packed8.dtype == np.uint8 else packed8


def unpack_bits_lsb(words: np.ndarray, num_bits: int | None = None) -> np.ndarray:
    """Unpack uint32 [..., W] -> uint8 0/1 array [..., num_bits]."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    if num_bits is not None:
        bits = bits[..., :num_bits]
    return bits


def bloom_bytes_to_bools(data: bytes, m: int | None = None) -> np.ndarray:
    """Reference ``.bloom`` bytes (MSB-first) -> bool array.

    Without ``m``, returns all ``8*len(data)`` bits (matching
    ``bitarray.fromfile``, which keeps byte-padding bits).
    """
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8), bitorder="big")
    if m is not None:
        bits = bits[:m]
    return bits.astype(bool)


def bools_to_bloom_bytes(bits: np.ndarray) -> bytes:
    """Bool array [m] -> reference-compatible MSB-first bytes."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), bitorder="big").tobytes()
