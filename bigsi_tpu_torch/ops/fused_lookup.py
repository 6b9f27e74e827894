"""Wrappers of the CUDA lookup kernels (``csrc/lookup.cu``).

* :func:`classic_counts` is kernel A.  It replaces the XLA program
  ``bigsi_tpu/index/device_engine.py:_counts_batch_fat`` (the contract of
  ``ops/lookup.py:batched_counts_jnp``) and adds the exact AND.
* :func:`tile_counts` is kernel B.  It replaces the Pallas kernel
  ``bigsi_tpu/ops/pallas_lookup.py:fused_query`` and its wrapper
  ``query_counts_exact``, at any W and tile_rows up to 64, in plain
  sample order; the same contract covers ``ops/lookup.py:blocked_counts``.
* :func:`grouped_tile_counts` is kernel C.  It replaces the Pallas
  kernels ``bigsi_tpu/ops/pallas_lookup.py:grouped_fused`` (P2) and
  ``bigsi_tpu/ops/pallas_grouped.py:grouped_fused_v2`` (P3), at any W,
  U, R and tile_rows up to 64; the same contract covers
  ``ops/lookup.py:grouped_counts``.
* :func:`pack_tile_cols` is kernel D.  It replaces the XLA program
  ``bigsi_tpu/ops/lookup.py:pack_tile_cols``, which the JAX engine runs
  at load to derive the column-major tile layout of a minimizer index.
* :func:`cols_counts` is kernel E.  It replaces the XLA program
  ``bigsi_tpu/ops/lookup.py:grouped_counts_cols`` and adds the exact AND,
  so single queries on a cols engine take the same kernel.

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
MAX_RUN = 4095  # slots of one grouped entry that fit the kernels' staging
MAX_COLS_TILE_ROWS = 32  # the widest cols element is 32 bits
COLS_DTYPES = (torch.uint8, torch.int16, torch.int32)

_count_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    lib = load("lookup.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.classic_counts.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.tile_counts.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.grouped_tile_counts.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.pack_tile_cols.argtypes = [ptr, i32, i64, i32, i32, ptr, ptr]
    lib.cols_counts.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
    for fn in (lib.classic_counts, lib.tile_counts, lib.grouped_tile_counts,
               lib.pack_tile_cols, lib.cols_counts):
        fn.restype = i32
    lib.lookup_error_string.argtypes = [i32]
    lib.lookup_error_string.restype = ctypes.c_char_p
    return lib


def check_tensor(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise TypeError("%s must be a %s tensor" % (name, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s" % (name, tuple(t.shape), tuple(shape)))
    if t.device != device:
        raise ValueError("%s is on %s, the matrix on %s" % (name, t.device, device))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def device_kind(words: torch.Tensor) -> str:
    kind = words.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError("lookup kernels run on cpu or cuda, not %s" % kind)
    return kind


def count_outputs(t, b, w):
    """Uninitialised counts int32[B, W * 32] and exact int32[B, W] on
    ``t``'s device: what a kernel fills, or returns as they are when it
    has nothing to compute (a grid of 0 blocks)."""
    return (
        torch.empty((b, w * 32), dtype=torch.int32, device=t.device),
        torch.empty((b, w), dtype=torch.int32, device=t.device),
    )


def launch(fn, device, args, outs):
    """Launch the kernel of wrapper ``fn`` (the library function of its
    name) on the current stream of ``device`` with ``args`` and then the
    outputs' pointers, raise on a launch error, count the launch;
    returns ``outs``."""
    name = fn.__name__
    with torch.cuda.device(device):
        lib = _library()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*args, *(t.data_ptr() for t in outs), stream)
    if err != 0:
        raise RuntimeError("%s launch failed: %s" % (name, lib.lookup_error_string(err).decode()))
    with _count_lock:
        fn.launches += 1
    return outs


def classic_counts(words: torch.Tensor, row_idx: torch.Tensor, mask: torch.Tensor):
    """Classic layout: per-query hit counts and exact AND.

    words int32[m, W] (uint32 bits), row_idx int32[B, K, h] (every id in
    [0, m); padding k-mers may hold any in-range id), mask bool[B, K] ->
    (counts int32[B, W * 32], exact int32[B, W]).
    """
    if words.dim() != 2 or row_idx.dim() != 3:
        raise ValueError("words must be [m, W] and row_idx [B, K, h]")
    b, k, h = row_idx.shape
    check_tensor("words", words, torch.int32, words.shape, words.device)
    check_tensor("row_idx", row_idx, torch.int32, (b, k, h), words.device)
    check_tensor("mask", mask, torch.bool, (b, k), words.device)
    if device_kind(words) == "cpu":
        return plain.batched_counts(words, row_idx, mask)
    w = words.shape[1]
    if b == 0 or w == 0:
        return count_outputs(words, b, w)
    if not 1 <= h <= MAX_HASHES:
        raise ValueError("classic_counts takes 1..%d rows per k-mer, got %d" % (MAX_HASHES, h))
    args = (words.data_ptr(), w, row_idx.data_ptr(), mask.data_ptr(), b, k, h)
    return launch(classic_counts, words.device, args, count_outputs(words, b, w))


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
    check_tensor("words", words, torch.int32, words.shape, words.device)
    check_tensor("tile", tile, torch.int32, (b, k), words.device)
    check_tensor("smask", smask, torch.int64, (b, k), words.device)
    if not 1 <= tile_rows <= MAX_TILE_ROWS or words.shape[0] % tile_rows:
        raise ValueError(
            "tile_rows must be in [1, %d] and divide the matrix's %d rows, got %d"
            % (MAX_TILE_ROWS, words.shape[0], tile_rows)
        )
    if device_kind(words) == "cpu":
        return plain.blocked_counts(words, tile, smask, tile_rows)
    w = words.shape[1]
    if b == 0 or w == 0:
        return count_outputs(words, b, w)
    args = (words.data_ptr(), w, tile.data_ptr(), smask.data_ptr(), b, k, tile_rows)
    return launch(tile_counts, words.device, args, count_outputs(words, b, w))


tile_counts.launches = 0


def grouped_tile_counts(
    words: torch.Tensor, utile: torch.Tensor, gmask: torch.Tensor, tile_rows: int
):
    """Grouped streams over the row-major matrix: per-query hit counts
    and exact AND.

    words int32[m_pad, W] with m_pad a multiple of ``tile_rows``; utile
    int32[B, U] (every id below m_pad / tile_rows); gmask int64[B, U, R],
    slot j of entry u selecting rows ``utile * tile_rows + s`` for its
    set bits s, 0 for a padding slot -> (counts int32[B, W * 32], exact
    int32[B, W]).
    """
    if words.dim() != 2 or utile.dim() != 2 or gmask.dim() != 3:
        raise ValueError("words must be [m_pad, W], utile [B, U] and gmask [B, U, R]")
    b, u = utile.shape
    r = gmask.shape[2]
    check_tensor("words", words, torch.int32, words.shape, words.device)
    check_tensor("utile", utile, torch.int32, (b, u), words.device)
    check_tensor("gmask", gmask, torch.int64, (b, u, r), words.device)
    if not 1 <= tile_rows <= MAX_TILE_ROWS or words.shape[0] % tile_rows:
        raise ValueError(
            "tile_rows must be in [1, %d] and divide the matrix's %d rows, got %d"
            % (MAX_TILE_ROWS, words.shape[0], tile_rows)
        )
    if r > MAX_RUN:
        raise ValueError("grouped_tile_counts takes at most %d slots per entry, got %d"
                         % (MAX_RUN, r))
    if device_kind(words) == "cpu":
        return plain.grouped_counts(words, utile, gmask, tile_rows)
    w = words.shape[1]
    if b == 0 or w == 0:
        return count_outputs(words, b, w)
    args = (words.data_ptr(), w, utile.data_ptr(), gmask.data_ptr(), b, u, r, tile_rows)
    return launch(grouped_tile_counts, words.device, args, count_outputs(words, b, w))


grouped_tile_counts.launches = 0


def pack_tile_cols(words: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """Row-major tiles -> column-major tile columns.

    words int32[m_pad, W] with m_pad a multiple of ``tile_rows`` (1..32)
    -> cols[m_pad / tile_rows, W * 32] of ``plain.cols_dtype(tile_rows)``:
    bit s of ``cols[t, n]`` is sample n's bit in row ``t * tile_rows + s``.
    """
    if words.dim() != 2:
        raise ValueError("words must be [m_pad, W]")
    check_tensor("words", words, torch.int32, words.shape, words.device)
    if not 1 <= tile_rows <= MAX_COLS_TILE_ROWS or words.shape[0] % tile_rows:
        raise ValueError(
            "tile_rows must be in [1, %d] and divide the matrix's %d rows, got %d"
            % (MAX_COLS_TILE_ROWS, words.shape[0], tile_rows)
        )
    if device_kind(words) == "cpu":
        return plain.pack_tile_cols(words, tile_rows)
    dtype = plain.cols_dtype(tile_rows)
    m, w = words.shape
    t = m // tile_rows
    cols = torch.empty((t, w * 32), dtype=dtype, device=words.device)
    if t == 0 or w == 0:
        return cols
    args = (words.data_ptr(), w, t, tile_rows, dtype.itemsize)
    return launch(pack_tile_cols, words.device, args, (cols,))[0]


pack_tile_cols.launches = 0


def cols_counts(
    cols: torch.Tensor, utile: torch.Tensor, gmask: torch.Tensor, n_valid: torch.Tensor
):
    """Grouped streams over the cols layout: per-query hit counts and
    exact AND.

    cols [T, W * 32] (uint8, int16 or int32 holding the unsigned bits),
    utile int32[B, U] (every id below T), gmask int64[B, U, R] (0 = padding
    slot), n_valid int32[B] (valid k-mers per query) -> (counts
    int32[B, W * 32], exact int32[B, W]); see
    :func:`bigsi_tpu_torch.ops.lookup.grouped_counts_cols`.
    """
    if cols.dim() != 2 or utile.dim() != 2 or gmask.dim() != 3:
        raise ValueError("cols must be [T, N], utile [B, U] and gmask [B, U, R]")
    if cols.dtype not in COLS_DTYPES or cols.shape[1] % 32:
        raise TypeError("cols must be uint8, int16 or int32 with a multiple of 32 columns")
    b, u = utile.shape
    r = gmask.shape[2]
    check_tensor("cols", cols, cols.dtype, cols.shape, cols.device)
    check_tensor("utile", utile, torch.int32, (b, u), cols.device)
    check_tensor("gmask", gmask, torch.int64, (b, u, r), cols.device)
    check_tensor("n_valid", n_valid, torch.int32, (b,), cols.device)
    if r > MAX_RUN:
        raise ValueError("cols_counts takes at most %d slots per entry, got %d" % (MAX_RUN, r))
    if device_kind(cols) == "cpu":
        return plain.grouped_counts_cols(cols, utile, gmask, n_valid)
    w = cols.shape[1] // 32
    if b == 0 or w == 0:
        return count_outputs(cols, b, w)
    args = (cols.data_ptr(), w, cols.dtype.itemsize, utile.data_ptr(), gmask.data_ptr(),
            n_valid.data_ptr(), b, u, r)
    return launch(cols_counts, cols.device, args, count_outputs(cols, b, w))


cols_counts.launches = 0
