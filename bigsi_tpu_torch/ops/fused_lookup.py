"""Wrappers of the CUDA lookup kernels (``csrc/lookup.cu``).

* :func:`classic_counts` is kernel A.  It replaces the XLA program
  ``bigsi_tpu/index/device_engine.py:_counts_batch_fat`` (the contract of
  ``ops/lookup.py:batched_counts_jnp``) and adds the exact AND.
* :func:`tile_counts` is kernel B.  It replaces the Pallas kernel
  ``bigsi_tpu/ops/pallas_lookup.py:fused_query`` and its wrapper
  ``query_counts_exact``, at any W and tile_rows up to 64, in plain
  sample order; the same contract covers ``ops/lookup.py:blocked_counts``.

A wrapper checks its arguments, then runs the plain version from
:mod:`bigsi_tpu_torch.ops.lookup` for tensors on the CPU, and launches
its kernel for tensors on a CUDA device.  It never falls back: a build
or launch that fails raises.  Each wrapper counts its kernel's launches
in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.ops._build import load

MAX_TILE_ROWS = 64  # slot masks are 64 bits wide
MAX_HASHES = 8192  # row ids of one k-mer that fit the kernel's staging

_count_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    lib = load("lookup.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.classic_counts.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.tile_counts.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.classic_counts.restype = lib.tile_counts.restype = i32
    lib.lookup_error_string.argtypes = [i32]
    lib.lookup_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise TypeError("%s must be a %s tensor" % (name, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s" % (name, tuple(t.shape), tuple(shape)))
    if t.device != device:
        raise ValueError("%s is on %s, the matrix on %s" % (name, t.device, device))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _device_kind(words: torch.Tensor) -> str:
    kind = words.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError("lookup kernels run on cpu or cuda, not %s" % kind)
    return kind


def _empty(words, b, w):
    """Outputs of a launch with nothing to compute (a grid of 0 blocks)."""
    dev = words.device
    return (
        torch.empty((b, w * 32), dtype=torch.int32, device=dev),
        torch.empty((b, w), dtype=torch.int32, device=dev),
    )


def _launch(fn, name: str, words, args, out_shapes):
    """Allocate the outputs, launch on the current stream, raise on a
    launch error, count the launch."""
    counts = torch.empty(out_shapes[0], dtype=torch.int32, device=words.device)
    exact = torch.empty(out_shapes[1], dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        lib = _library()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            *args, counts.data_ptr(), exact.data_ptr(), stream
        )
    if err != 0:
        raise RuntimeError(
            "%s launch failed: %s" % (name, lib.lookup_error_string(err).decode())
        )
    with _count_lock:
        fn.launches += 1
    return counts, exact


def classic_counts(words: torch.Tensor, row_idx: torch.Tensor, mask: torch.Tensor):
    """Classic layout: per-query hit counts and exact AND.

    words int32[m, W] (uint32 bits), row_idx int32[B, K, h] (every id in
    [0, m); padding k-mers may hold any in-range id), mask bool[B, K] ->
    (counts int32[B, W * 32], exact int32[B, W]).
    """
    if words.dim() != 2 or row_idx.dim() != 3:
        raise ValueError("words must be [m, W] and row_idx [B, K, h]")
    b, k, h = row_idx.shape
    _check("words", words, torch.int32, words.shape, words.device)
    _check("row_idx", row_idx, torch.int32, (b, k, h), words.device)
    _check("mask", mask, torch.bool, (b, k), words.device)
    if _device_kind(words) == "cpu":
        return plain.batched_counts(words, row_idx, mask)
    w = words.shape[1]
    if b == 0 or w == 0:
        return _empty(words, b, w)
    if not 1 <= h <= MAX_HASHES:
        raise ValueError("classic_counts takes 1..%d rows per k-mer, got %d" % (MAX_HASHES, h))
    args = (words.data_ptr(), w, row_idx.data_ptr(), mask.data_ptr(), b, k, h)
    return _launch(classic_counts, "classic_counts", words, args, ((b, w * 32), (b, w)))


classic_counts.launches = 0


def tile_counts(
    words: torch.Tensor, tile: torch.Tensor, smask: torch.Tensor, tile_rows: int
):
    """Tiled layouts (blocked, minimizer): per-query hit counts and exact AND.

    words int32[m_pad, W] with m_pad a multiple of ``tile_rows``; tile
    int32[B, K] (every id below m_pad / tile_rows); smask int64[B, K],
    bit s selecting row ``tile * tile_rows + s``, 0 for a padding k-mer
    -> (counts int32[B, W * 32], exact int32[B, W]).
    """
    if words.dim() != 2 or tile.dim() != 2:
        raise ValueError("words must be [m_pad, W] and tile [B, K]")
    b, k = tile.shape
    _check("words", words, torch.int32, words.shape, words.device)
    _check("tile", tile, torch.int32, (b, k), words.device)
    _check("smask", smask, torch.int64, (b, k), words.device)
    if not 1 <= tile_rows <= MAX_TILE_ROWS or words.shape[0] % tile_rows:
        raise ValueError(
            "tile_rows must be in [1, %d] and divide the matrix's %d rows, got %d"
            % (MAX_TILE_ROWS, words.shape[0], tile_rows)
        )
    if _device_kind(words) == "cpu":
        return plain.blocked_counts(words, tile, smask, tile_rows)
    w = words.shape[1]
    if b == 0 or w == 0:
        return _empty(words, b, w)
    args = (words.data_ptr(), w, tile.data_ptr(), smask.data_ptr(), b, k, tile_rows)
    return _launch(tile_counts, "tile_counts", words, args, ((b, w * 32), (b, w)))


tile_counts.launches = 0
