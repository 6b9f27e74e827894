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
  at load to derive the column-major tile layout of a minimizer index;
  ``out=`` packs a chunk of tiles into a slice of the cols.
* :func:`cols_counts` is kernel E.  It replaces the XLA program
  ``bigsi_tpu/ops/lookup.py:grouped_counts_cols`` and adds the exact AND,
  so single queries on a cols engine take the same kernel.
* :func:`gather_rows` is kernel F.  It replaces the Pallas kernel of the
  probe ``scripts/probe_multidma.py:62`` (S2), a random-row gather.
* :func:`tile_xor` is kernel G.  It replaces the XOR-consume floor of the
  probes of P1's loop (``scripts/bisect_kernel.py:49`` case k1,
  ``scripts/bisect_compile.py:107``, ``scripts/bisect_size.py:73``) and
  of ``scripts/microbench.py:233`` (S1).
* ``tile_counts(..., exact=False)`` launches kernel B's counts-only
  build, the k2 stage of ``scripts/bisect_kernel.py:49`` (S3).
* Kernels A, B and C all run on ``slot_counts_kernel`` (see
  ``csrc/lookup.cu``).
* :func:`seq_streams` is kernel H.  It replaces the XLA program
  ``bigsi_tpu/ops/prep_jax.py:prep_streams_device``, the seq serving
  arm's prep from query bytes to the grouped streams kernel E counts.
* :func:`kmer_rows` is kernel I.  It replaces the XLA programs of
  ``bigsi_tpu/ops/hash_jax.py`` (murmur3, canonical k-mers, classic rows)
  and the blocked rows of ``bigsi_tpu/ops/build_jax.py:device_bloom``;
  :mod:`bigsi_tpu_torch.ops.hash` and ``ops/lookup.py:make_full_query_step``
  call it.
* :func:`bloom_scatter` is kernel J.  It replaces the XLA program
  ``bigsi_tpu/ops/build_jax.py:device_bloom`` (one sample's bloom).
* :func:`bloom_transpose` is kernel K.  It replaces the XLA program
  ``bigsi_tpu/ops/build_jax.py:device_transpose`` (blooms to the
  bitslice matrix).
* :func:`presence_rows` is kernel L.  It replaces the XLA programs of
  scoring's presence rows, ``bigsi_tpu/index/device_engine.py:_and_rows_fat``
  (classic), ``:_blocked_and`` (slot) and ``:_cols_and`` (cols), each as
  one launch.
* :func:`presence_strings` is kernel L's strings form: the same three
  programs plus the facade's gather of each result's presence string
  (``bigsi_tpu/graph/bigsi.py:_score_results``), for a whole scored
  batch in one launch that writes only the result columns' strings.
* :func:`hits_compact` is kernel M.  It replaces no TPU kernel (the JAX
  package thresholds a batch's counts on the host): it thresholds the
  counts on the card and writes only each query's hits.

A wrapper checks its arguments, then runs the plain version from
:mod:`bigsi_tpu_torch.ops.lookup` (kernel H's from
:mod:`bigsi_tpu_torch.ops.prep`, I's from :mod:`bigsi_tpu_torch.ops.hash`,
J's and K's from :mod:`bigsi_tpu_torch.ops.build`) for tensors on the CPU, and launches
its kernel for tensors on a CUDA device.  It never falls back: a build
or launch that fails raises.  Each wrapper counts its kernel's launches
in its ``launches`` attribute; ``tile_counts`` also counts its
counts-only launches in ``counts_only_launches``, and ``classic_counts``
its launches that split queries over blocks in ``split_launches``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from bigsi_tpu_torch.ops import build as build_plain
from bigsi_tpu_torch.ops import hash as hash_plain
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.ops import prep
from bigsi_tpu_torch.ops._build import load

MAX_TILE_ROWS = 64  # slot masks are 64 bits wide
MAX_HASHES = 8192  # row ids of one k-mer that fit the kernel's staging
MAX_RUN = 4095  # slots of one grouped entry that fit the kernels' staging
MAX_COLS_TILE_ROWS = 32  # the widest cols element is 32 bits
COLS_DTYPES = (torch.uint8, torch.int16, torch.int32)
ROWS_IN_FLIGHT = (1, 2, 4, 8, 16, 32)  # gather_rows builds: rows a lane group keeps in flight
# kernel A's split of a query's k-mers over blocks: two 256-thread blocks
# share an SM, and a range gives each of a block's 8 warps a group of 8
BLOCKS_PER_SM = 2
MIN_RANGE_KMERS = 64

_count_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    lib = load("lookup.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.classic_counts.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.tile_counts.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.grouped_tile_counts.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.pack_tile_cols.argtypes = [ptr, i32, i64, i32, i32, ptr, ptr]
    lib.cols_counts.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.tile_counts_only.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, ptr, ptr]
    lib.gather_rows.argtypes = [ptr, i32, ptr, i64, i32, ptr, ptr]
    lib.tile_xor.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, ptr, ptr]
    lib.seq_streams.argtypes = [ptr, i32, i32, ptr, i32, i32, ctypes.c_uint64, i64, i32, i32,
                                i32, i32, ptr, ptr, ptr, ptr, ptr]
    lib.kmer_rows.argtypes = [ptr, i64, i32, i32, ptr, i32, i32, i32, i32, ptr, ptr]
    lib.bloom_scatter.argtypes = [ptr, i64, i32, ptr, i32, i32, i32, i32, i64, ptr, ptr]
    lib.bloom_transpose.argtypes = [ptr, i32, i64, i64, i32, ptr, ptr]
    lib.presence_rows_classic.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr]
    lib.presence_rows_slot.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, i32, ptr, ptr]
    lib.presence_rows_cols.argtypes = [ptr, i32, i32, ptr, ptr, i32, i32, i32, ptr, ptr]
    # rows, h, kmer_off, pos_kmer, pos_off, res_query, res_colour, res_off,
    # R, blocks per result, size, out, stream
    strings = [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i64, ptr, ptr]
    lib.presence_strings_classic.argtypes = [ptr, i32] + strings
    lib.presence_strings_slot.argtypes = [ptr, i32, i32] + strings
    lib.presence_strings_cols.argtypes = [ptr, i32, i32, i32] + strings
    lib.hits_compact.argtypes = [ptr, i32, i32, i64, ptr, ctypes.c_double, i32, i32, ptr, ptr]
    for fn in (lib.classic_counts, lib.tile_counts, lib.grouped_tile_counts,
               lib.pack_tile_cols, lib.cols_counts, lib.tile_counts_only,
               lib.gather_rows, lib.tile_xor, lib.seq_streams, lib.kmer_rows,
               lib.bloom_scatter, lib.bloom_transpose, lib.presence_rows_classic,
               lib.presence_rows_slot, lib.presence_rows_cols, lib.presence_strings_classic,
               lib.presence_strings_slot, lib.presence_strings_cols, lib.hits_compact):
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


def launch(fn, device, args, outs, symbol=None, counters=("launches",)):
    """Launch the kernel of wrapper ``fn`` (the library function
    ``symbol``, by default of the wrapper's name) on the current stream of
    ``device`` with ``args`` and then the outputs' pointers, raise on a
    launch error, add one to each of ``fn``'s ``counters``; returns
    ``outs``."""
    name = symbol or fn.__name__
    with torch.cuda.device(device):
        lib = _library()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*args, *(t.data_ptr() for t in outs), stream)
    if err != 0:
        raise RuntimeError("%s launch failed: %s" % (name, lib.lookup_error_string(err).decode()))
    with _count_lock:
        for counter in counters:
            setattr(fn, counter, getattr(fn, counter) + 1)
    return outs


def classic_splits(b: int, k: int, w: int, sms: int) -> int:
    """The ranges kernel A splits each query's k-mers into, one block
    each: 1 when the B * ceil(W / 32) blocks of one range a query already
    give each of the card's ``sms`` SMs one, else as many as give each SM
    BLOCKS_PER_SM blocks, with at least MIN_RANGE_KMERS k-mers a range."""
    blocks = b * -(-w // 32)
    if blocks >= sms:
        return 1
    return max(1, min(-(-BLOCKS_PER_SM * sms // blocks), k // MIN_RANGE_KMERS))


def classic_counts(words: torch.Tensor, row_idx: torch.Tensor, mask: torch.Tensor):
    """Classic layout: per-query hit counts and exact AND.

    words int32[m, W] (uint32 bits), row_idx int32[B, K, h] (every id in
    [0, m); padding k-mers may hold any in-range id), mask bool[B, K] ->
    (counts int32[B, W * 32], exact int32[B, W]).  On the card a batch too
    small to fill it splits each query's k-mers over several blocks
    (:func:`classic_splits`), counted in ``split_launches``.
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
    sms = torch.cuda.get_device_properties(words.device).multi_processor_count
    splits = classic_splits(b, k, w, sms)
    if splits == 1:
        outs, counters = count_outputs(words, b, w), ("launches",)
    else:  # the blocks of a query add into zero counts and AND into all-ones exact
        outs = (torch.zeros((b, w * 32), dtype=torch.int32, device=words.device),
                torch.full((b, w), plain.ALL_ONES, dtype=torch.int32, device=words.device))
        counters = ("launches", "split_launches")
    args = (words.data_ptr(), w, row_idx.data_ptr(), mask.data_ptr(), b, k, h, splits)
    return launch(classic_counts, words.device, args, outs, counters=counters)


classic_counts.launches = 0
classic_counts.split_launches = 0


def tile_counts(
    words: torch.Tensor, tile: torch.Tensor, smask: torch.Tensor, tile_rows: int,
    exact: bool = True,
):
    """Tiled layouts (blocked, minimizer): per-query hit counts and exact AND.

    words int32[m_pad, W] with m_pad a multiple of ``tile_rows``; tile
    int32[B, K] (every id below m_pad / tile_rows); smask int64[B, K],
    bit s selecting row ``tile * tile_rows + s``, 0 for a padding k-mer
    -> (counts int32[B, W * 32], exact int32[B, W]).  With ``exact``
    False the counts-only build runs and exact is None.
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
        return plain.blocked_counts(words, tile, smask, tile_rows, exact)
    w = words.shape[1]
    counts, exact_out = count_outputs(words, b, w)
    if b and w:
        args = (words.data_ptr(), w, tile.data_ptr(), smask.data_ptr(), b, k, tile_rows)
        if exact:
            launch(tile_counts, words.device, args, (counts, exact_out))
        else:
            launch(tile_counts, words.device, args, (counts,), "tile_counts_only",
                   ("launches", "counts_only_launches"))
    return counts, exact_out if exact else None


tile_counts.launches = 0
tile_counts.counts_only_launches = 0


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


def pack_tile_cols(
    words: torch.Tensor, tile_rows: int, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Row-major tiles -> column-major tile columns.

    words int32[m_pad, W] with m_pad a multiple of ``tile_rows`` (1..32)
    -> cols[m_pad / tile_rows, W * 32] of ``plain.cols_dtype(tile_rows)``:
    bit s of ``cols[t, n]`` is sample n's bit in row ``t * tile_rows + s``.
    With ``out`` (contiguous, of that shape and type, on the words'
    device) the cols are written there and ``out`` is returned: the
    engine packs each chunk of rows into its slice of one cols tensor.
    """
    if words.dim() != 2:
        raise ValueError("words must be [m_pad, W]")
    check_tensor("words", words, torch.int32, words.shape, words.device)
    if not 1 <= tile_rows <= MAX_COLS_TILE_ROWS or words.shape[0] % tile_rows:
        raise ValueError(
            "tile_rows must be in [1, %d] and divide the matrix's %d rows, got %d"
            % (MAX_COLS_TILE_ROWS, words.shape[0], tile_rows)
        )
    dtype = plain.cols_dtype(tile_rows)
    m, w = words.shape
    t = m // tile_rows
    if out is not None:
        check_tensor("out", out, dtype, (t, w * 32), words.device)
    if device_kind(words) == "cpu":
        cols = plain.pack_tile_cols(words, tile_rows)
        return cols if out is None else out.copy_(cols)
    cols = torch.empty((t, w * 32), dtype=dtype, device=words.device) if out is None else out
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
    if cols.data_ptr() % 16:
        raise ValueError("cols must start on a 16-byte boundary (the kernel's bulk copies)")
    args = (cols.data_ptr(), w, cols.dtype.itemsize, utile.data_ptr(), gmask.data_ptr(),
            n_valid.data_ptr(), b, u, r)
    return launch(cols_counts, cols.device, args, count_outputs(cols, b, w))


cols_counts.launches = 0


def gather_rows(mat: torch.Tensor, idx: torch.Tensor, rows_in_flight: int = 16) -> torch.Tensor:
    """Random-row gather: mat int32[m, Wr], idx int32[n] (every id in
    [0, m)) -> int32[n, Wr], row i a copy of ``mat[idx[i]]``.

    ``rows_in_flight`` (one of ROWS_IN_FLIGHT) is how many rows a group of
    lanes reads before it stores any, the counterpart of the Pallas
    probe's ``--chunk``; it changes the speed, never the result.
    """
    if mat.dim() != 2 or idx.dim() != 1:
        raise ValueError("mat must be [m, Wr] and idx [n]")
    check_tensor("mat", mat, torch.int32, mat.shape, mat.device)
    check_tensor("idx", idx, torch.int32, idx.shape, mat.device)
    if rows_in_flight not in ROWS_IN_FLIGHT:
        raise ValueError("rows_in_flight must be one of %s, got %r"
                         % (ROWS_IN_FLIGHT, rows_in_flight))
    if device_kind(mat) == "cpu":
        return plain.gather_rows(mat, idx)
    n, wr = idx.shape[0], mat.shape[1]
    out = torch.empty((n, wr), dtype=torch.int32, device=mat.device)
    if n == 0 or wr == 0:
        return out
    args = (mat.data_ptr(), wr, idx.data_ptr(), n, rows_in_flight)
    return launch(gather_rows, mat.device, args, (out,))[0]


gather_rows.launches = 0


def tile_xor(
    words: torch.Tensor, tile: torch.Tensor, valid: torch.Tensor, tile_rows: int
) -> torch.Tensor:
    """Per query, the XOR of the whole tiles of its valid k-mers.

    words int32[m_pad, W] with m_pad a multiple of ``tile_rows`` (1..64);
    tile int32[B, K] (every id below m_pad / tile_rows); valid bool[B, K]
    -> int32[B, tile_rows, W]: the XOR of ``words[t * tile_rows : (t + 1)
    * tile_rows]`` over the valid k-mers' tiles t (zeros when none is
    valid).
    """
    if words.dim() != 2 or tile.dim() != 2:
        raise ValueError("words must be [m_pad, W] and tile [B, K]")
    b, k = tile.shape
    check_tensor("words", words, torch.int32, words.shape, words.device)
    check_tensor("tile", tile, torch.int32, (b, k), words.device)
    check_tensor("valid", valid, torch.bool, (b, k), words.device)
    if not 1 <= tile_rows <= MAX_TILE_ROWS or words.shape[0] % tile_rows:
        raise ValueError(
            "tile_rows must be in [1, %d] and divide the matrix's %d rows, got %d"
            % (MAX_TILE_ROWS, words.shape[0], tile_rows)
        )
    if device_kind(words) == "cpu":
        return plain.tile_xor(words, tile, valid, tile_rows)
    w = words.shape[1]
    out = torch.empty((b, tile_rows, w), dtype=torch.int32, device=words.device)
    if b == 0 or w == 0:
        return out
    args = (words.data_ptr(), w, tile.data_ptr(), valid.data_ptr(), b, k, tile_rows)
    return launch(tile_xor, words.device, args, (out,))[0]


tile_xor.launches = 0


def seq_streams(
    seqs: torch.Tensor, lens: torch.Tensor, *, k: int, s: int, num_tiles: int, h: int,
    tile_rows: int, r: int, u_cap: int, seed: int = prep.MINIMIZER_SEED,
):
    """Padded query bytes -> grouped streams of slot scheme 3.

    seqs uint8[B, L], lens int32[B] -> (utile int32[B, u_cap], gmask
    int64[B, u_cap, r], n_valid int32[B], ok bool[]): the contract of
    :func:`bigsi_tpu_torch.ops.prep.prep_streams`.  On the card the
    kernel writes ``ok`` itself.
    """
    if seqs.dim() != 2:
        raise ValueError("seqs must be [B, L]")
    b, l = seqs.shape
    check_tensor("seqs", seqs, torch.uint8, (b, l), seqs.device)
    check_tensor("lens", lens, torch.int32, (b,), seqs.device)
    prep.check_prep_args(k, s, num_tiles, h, tile_rows, r, u_cap)
    if l < k:
        raise ValueError("seq_streams needs L >= k, got L=%d k=%d" % (l, k))
    if device_kind(seqs) == "cpu":
        return prep.prep_streams(seqs, lens, k=k, s=s, num_tiles=num_tiles, h=h,
                                 tile_rows=tile_rows, r=r, u_cap=u_cap, seed=seed)
    dev = seqs.device
    utile = torch.empty((b, u_cap), dtype=torch.int32, device=dev)
    gmask = torch.empty((b, u_cap, r), dtype=torch.int64, device=dev)
    n_valid = torch.empty(b, dtype=torch.int32, device=dev)
    if not b:
        return utile, gmask, n_valid, torch.ones((), dtype=torch.bool, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    args = (seqs.data_ptr(), b, l, lens.data_ptr(), k, s, seed & (2**64 - 1), num_tiles, h,
            tile_rows, r, u_cap)
    return launch(seq_streams, dev, args, (utile, gmask, n_valid, ok))


seq_streams.launches = 0


MAX_M = 2**31 - 1  # bloom rows are int32


def check_hash_args(kmers, seeds, out: str, outs, m: int, tile_rows: int) -> str:
    """Kernels I's and J's arguments: contiguous uint8[K, k] k-mers and
    int32[S] seeds on one device, ``out`` one of ``outs``, m and tile_rows
    in [1, MAX_M], seed 0 present for blocked rows; -> the device kind."""
    if not isinstance(kmers, torch.Tensor) or kmers.dim() != 2:
        raise ValueError("kmers must be a [K, k] tensor")
    check_tensor("kmers", kmers, torch.uint8, kmers.shape, kmers.device)
    if not isinstance(seeds, torch.Tensor) or seeds.dim() != 1:
        raise ValueError("seeds must be a 1-D tensor")
    check_tensor("seeds", seeds, torch.int32, seeds.shape, kmers.device)
    if out not in outs:
        raise ValueError("out must be one of %s, got %r" % (outs, out))
    for name, value in (("m", m), ("tile_rows", tile_rows)):
        if not 1 <= value <= MAX_M:
            raise ValueError("%s must be in [1, %d], got %r" % (name, MAX_M, value))
    if out == "blocked" and seeds.numel() < 1:
        raise ValueError("blocked rows need seed 0 for the tile")
    return device_kind(kmers)


def kmer_rows(kmers: torch.Tensor, seeds: torch.Tensor, out: str, *, canonical: bool = False,
              m: int = 1, tile_rows: int = 1) -> torch.Tensor:
    """Kernel I: kmers uint8[K, k], seeds int32[S] (u32 bits) -> ``out``
    "hashes" int32[K, S], "classic" int32[K, S], "blocked" int32[K, S - 1]
    or "canonical" uint8[K, k]; the contract of
    :func:`bigsi_tpu_torch.ops.hash.kmer_rows_plain`.  With ``canonical``
    the k-mers' canonical forms are hashed in the same launch."""
    if check_hash_args(kmers, seeds, out, hash_plain.KMER_OUTS, m, tile_rows) == "cpu":
        return hash_plain.kmer_rows_plain(kmers, seeds, out, canonical, m, tile_rows)
    n, k = kmers.shape
    if out == "canonical":
        res = torch.empty((n, k), dtype=torch.uint8, device=kmers.device)
    else:
        per = seeds.numel() - (out == "blocked")
        res = torch.empty((n, per), dtype=torch.int32, device=kmers.device)
    if n == 0 or res.numel() == 0:
        return res
    args = (kmers.data_ptr(), n, k, int(canonical), seeds.data_ptr(), seeds.numel(),
            hash_plain.KMER_OUTS.index(out), m, tile_rows)
    return launch(kmer_rows, kmers.device, args, (res,))[0]


kmer_rows.launches = 0


def bloom_scatter(kmers: torch.Tensor, seeds: torch.Tensor, out: str, m: int,
                  tile_rows: int = 1) -> torch.Tensor:
    """Kernel J: one sample's bloom from its k-mers, kmers uint8[K, k] ->
    int32[ceil(m / 32)] (u32 bits, bloom bit p at bit p % 32 of word p /
    32) with the rows that :func:`kmer_rows` gives the canonical k-mers
    (``out`` "classic" or "blocked", seeds int32[S]) set; rows past the
    last word are dropped.  The contract of
    :func:`bigsi_tpu_torch.ops.build.bloom_plain`."""
    if check_hash_args(kmers, seeds, out, ("classic", "blocked"), m, tile_rows) == "cpu":
        return build_plain.bloom_plain(kmers, seeds, out, m, tile_rows)
    mw = -(-m // 32)
    bloom = torch.zeros(mw, dtype=torch.int32, device=kmers.device)
    n, k = kmers.shape
    if n == 0 or seeds.numel() == 0:
        return bloom
    args = (kmers.data_ptr(), n, k, seeds.data_ptr(), seeds.numel(),
            hash_plain.KMER_OUTS.index(out), m, tile_rows, mw)
    return launch(bloom_scatter, kmers.device, args, (bloom,))[0]


bloom_scatter.launches = 0


def bloom_transpose(blooms: torch.Tensor, m: int, rows_chunk: int = 4096) -> torch.Tensor:
    """Kernel K: packed blooms int32[N, MW] (sample n's bit p at bit p % 32
    of ``blooms[n, p // 32]``) -> the bitslice matrix int32[m, ceil(N /
    32)] (bit n % 32 of ``words[p, n // 32]``), 1 <= m <= 32 * MW; the
    contract of :func:`bigsi_tpu_torch.ops.build.transpose_plain`, which
    runs on the CPU in chunks of ``rows_chunk`` rows (the kernel takes
    none)."""
    if not isinstance(blooms, torch.Tensor) or blooms.dim() != 2:
        raise ValueError("blooms must be a [N, MW] tensor")
    check_tensor("blooms", blooms, torch.int32, blooms.shape, blooms.device)
    n, mw = blooms.shape
    if not 1 <= m <= 32 * mw:
        raise ValueError("m must be in [1, 32 * MW = %d], got %r" % (32 * mw, m))
    if device_kind(blooms) == "cpu":
        return build_plain.transpose_plain(blooms, m, rows_chunk)
    w = -(-n // 32)
    words = torch.empty((m, w), dtype=torch.int32, device=blooms.device)
    if n == 0:
        return words
    args = (blooms.data_ptr(), n, mw, m, w)
    return launch(bloom_transpose, blooms.device, args, (words,))[0]


bloom_transpose.launches = 0


def presence_rows(matrix: torch.Tensor, source: str, idx: torch.Tensor,
                  smask: torch.Tensor | None = None, tile_rows: int = 1,
                  window: tuple[int, int] | None = None) -> torch.Tensor:
    """Kernel L: scoring's presence rows, int32[K, W] (u32 bits: bit n %
    32 of word n // 32 set iff sample n holds the k-mer), in one launch;
    the contract of :func:`bigsi_tpu_torch.ops.lookup.presence_rows`.

    ``source`` "classic": matrix int32[m, W], idx int32[K, h] (every id in
    [0, m)).  "slot": matrix int32[T * tile_rows, W] (tile_rows 1..64),
    idx int32[K] tile ids, smask int64[K].  "cols": matrix cols[T, W * 32]
    (uint8, int16 or int32), idx and smask as for "slot".  ``window`` (t0,
    t1), tiled sources only, with t1 - t0 <= T: the matrix holds tiles t0
    onwards, and a k-mer whose tile lies outside gives 0; None is (0, T).
    """
    if source not in plain.PRESENCE_SOURCES:
        raise ValueError("source must be one of %s, got %r" % (plain.PRESENCE_SOURCES, source))
    if not isinstance(matrix, torch.Tensor) or matrix.dim() != 2:
        raise ValueError("the matrix must be a 2-d tensor")
    dev = matrix.device
    if source == "cols":
        if matrix.dtype not in COLS_DTYPES or matrix.shape[1] % 32:
            raise TypeError("cols must be uint8, int16 or int32 with a multiple of 32 columns")
        w, tiles = matrix.shape[1] // 32, matrix.shape[0]
    else:
        w = matrix.shape[1]
        if source == "slot":
            if not 1 <= tile_rows <= MAX_TILE_ROWS or matrix.shape[0] % tile_rows:
                raise ValueError(
                    "tile_rows must be in [1, %d] and divide the matrix's %d rows, got %d"
                    % (MAX_TILE_ROWS, matrix.shape[0], tile_rows)
                )
            tiles = matrix.shape[0] // tile_rows
    check_tensor("matrix", matrix, matrix.dtype if source == "cols" else torch.int32,
                 matrix.shape, dev)
    if source == "classic":
        if not isinstance(idx, torch.Tensor) or idx.dim() != 2:
            raise ValueError("classic presence takes row ids [K, h]")
        k, h = idx.shape
        check_tensor("idx", idx, torch.int32, (k, h), dev)
        if smask is not None or window is not None:
            raise ValueError("classic presence takes no slot masks and no tile window")
        if not 1 <= h <= MAX_HASHES:
            raise ValueError("presence_rows takes 1..%d rows per k-mer, got %d" % (MAX_HASHES, h))
    else:
        if not isinstance(idx, torch.Tensor) or idx.dim() != 1:
            raise ValueError("%s presence takes tile ids [K]" % source)
        k = idx.shape[0]
        check_tensor("idx", idx, torch.int32, (k,), dev)
        check_tensor("smask", smask, torch.int64, (k,), dev)
        window = (0, tiles) if window is None else tuple(int(t) for t in window)
        if not (len(window) == 2 and 0 <= window[0] <= window[1] < 2**31
                and window[1] - window[0] <= tiles):
            raise ValueError("window must be (t0, t1) with 0 <= t0 <= t1 and t1 - t0 <= %d "
                             "tiles, got %r" % (tiles, window))
    if device_kind(matrix) == "cpu":
        return plain.presence_rows(matrix, source, idx, smask, tile_rows, window)
    out = torch.empty((k, w), dtype=torch.int32, device=dev)
    if k == 0 or w == 0:
        return out
    if source == "classic":
        args = (matrix.data_ptr(), w, idx.data_ptr(), k, h)
    elif source == "slot":
        args = (matrix.data_ptr(), w, idx.data_ptr(), smask.data_ptr(), k, tile_rows, *window)
    else:
        args = (matrix.data_ptr(), w, matrix.dtype.itemsize, idx.data_ptr(), smask.data_ptr(), k,
                *window)
    return launch(presence_rows, dev, args, (out,), "presence_rows_" + source)[0]


presence_rows.launches = 0


STRING_THREADS = 256  # positions a block of the strings form takes at a time
MAX_GRID = 2**31 - 1


def presence_strings(matrix: torch.Tensor, source: str, rows: torch.Tensor,
                     kmer_off: torch.Tensor, pos_kmer: torch.Tensor, pos_off: torch.Tensor,
                     res_query: torch.Tensor, res_colour: torch.Tensor, tile_rows: int = 1, *,
                     res_off: torch.Tensor, out: torch.Tensor):
    """Kernel L, strings form: the presence strings of a batch's results
    in one launch -> (uint8[S], res_off int64[R + 1]); the contract of
    :func:`bigsi_tpu_torch.ops.lookup.presence_strings`.

    ``matrix`` as for :func:`presence_rows` ("classic": int32[m, W];
    "slot": int32[T * tile_rows, W], tile_rows 1..64; "cols": cols[T, W *
    32] with tile_rows up to the element's bits).  ``rows`` int32[sum K,
    h] (every id in [0, m)), ``kmer_off`` and ``pos_off`` int32[Q + 1],
    ``pos_kmer`` int32[sum P], ``res_query`` and ``res_colour`` int32[R]
    (colours below W * 32), in any order.  ``res_off`` int64[R + 1] and
    ``out`` uint8[res_off[R]] are the caller's offsets
    (:func:`bigsi_tpu_torch.ops.lookup.string_offsets`) and output, so the
    wrapper reads nothing back from the card; the kernel writes no byte
    past ``out``'s end.
    """
    if source not in plain.PRESENCE_SOURCES:
        raise ValueError("source must be one of %s, got %r" % (plain.PRESENCE_SOURCES, source))
    if not isinstance(matrix, torch.Tensor) or matrix.dim() != 2:
        raise ValueError("the matrix must be a 2-d tensor")
    dev = matrix.device
    if source == "cols":
        if matrix.dtype not in COLS_DTYPES or matrix.shape[1] % 32:
            raise TypeError("cols must be uint8, int16 or int32 with a multiple of 32 columns")
        w, widest = matrix.shape[1] // 32, 8 * matrix.element_size()
    else:
        w, widest = matrix.shape[1], MAX_TILE_ROWS
    check_tensor("matrix", matrix, matrix.dtype if source == "cols" else torch.int32,
                 matrix.shape, dev)
    if source != "classic" and not (1 <= tile_rows <= widest
                                    and (source == "cols" or matrix.shape[0] % tile_rows == 0)):
        raise ValueError("tile_rows must be in [1, %d] and divide the matrix's rows, got %d"
                         % (widest, tile_rows))
    if not isinstance(rows, torch.Tensor) or rows.dim() != 2 or rows.shape[1] < 1:
        raise ValueError("rows must be row ids [sum K, h] with h >= 1")
    for name, t in (("kmer_off", kmer_off), ("pos_kmer", pos_kmer), ("pos_off", pos_off),
                    ("res_query", res_query)):
        if not isinstance(t, torch.Tensor) or t.dim() != 1:
            raise ValueError("%s must be a 1-d tensor" % name)
    q, r = kmer_off.shape[0] - 1, res_query.shape[0]
    if q < 0:
        raise ValueError("kmer_off must hold Q + 1 offsets")
    check_tensor("rows", rows, torch.int32, rows.shape, dev)
    check_tensor("kmer_off", kmer_off, torch.int32, (q + 1,), dev)
    check_tensor("pos_kmer", pos_kmer, torch.int32, pos_kmer.shape, dev)
    check_tensor("pos_off", pos_off, torch.int32, (q + 1,), dev)
    check_tensor("res_query", res_query, torch.int32, (r,), dev)
    check_tensor("res_colour", res_colour, torch.int32, (r,), dev)
    check_tensor("res_off", res_off, torch.int64, (r + 1,), dev)
    if not isinstance(out, torch.Tensor) or out.dim() != 1:
        raise ValueError("out must be a 1-d tensor")
    check_tensor("out", out, torch.uint8, out.shape, dev)
    if device_kind(matrix) == "cpu":
        got, offsets = plain.presence_strings(matrix, source, rows, kmer_off, pos_kmer, pos_off,
                                              res_query, res_colour, tile_rows)
        if not torch.equal(res_off, offsets) or out.shape != got.shape:
            raise ValueError("res_off and out do not match the queries' positions")
        out.copy_(got)
        return out, res_off
    if r == 0 or out.numel() == 0:
        return out, res_off
    # blocks a result: enough for the batch's mean query, each block's
    # threads striding over longer ones
    per = -(-pos_kmer.shape[0] // (max(1, q) * STRING_THREADS))
    per = max(1, min(per, MAX_GRID // r))
    tail = (rows.data_ptr(), rows.shape[1], kmer_off.data_ptr(), pos_kmer.data_ptr(),
            pos_off.data_ptr(), res_query.data_ptr(), res_colour.data_ptr(), res_off.data_ptr(),
            r, per, out.numel())
    if source == "classic":
        head = (matrix.data_ptr(), w)
    elif source == "slot":
        head = (matrix.data_ptr(), w, tile_rows)
    else:
        head = (matrix.data_ptr(), w, matrix.element_size(), tile_rows)
    launch(presence_strings, dev, head + tail, (out,), "presence_strings_" + source)
    return out, res_off


presence_strings.launches = 0


def hits_compact(counts: torch.Tensor, n_valid: torch.Tensor, threshold: float,
                 cap: int) -> torch.Tensor:
    """A batch's hits, thresholded and compacted on the counts' device.

    counts int32[B, N] (rows any stride apart, samples contiguous),
    n_valid int32[B] distinct k-mers a query, ``threshold`` at most 1,
    ``cap`` the hits the record has room for -> the hits record
    int32[``plain.hits_size(B, cap)``] of
    :func:`bigsi_tpu_torch.ops.lookup.hits_compact`: the total, each
    query's n_valid, segment start and hits, then (colour, count) pairs
    in ascending colour within a segment.  A total above ``cap`` means
    the segments that did not fit were not written.  On the card the
    segments lie in the order the kernel's blocks reserved them.
    """
    if counts.dim() != 2:
        raise ValueError("counts must be [B, N]")
    b, n = counts.shape
    if counts.dtype != torch.int32 or (n > 1 and counts.stride(1) != 1):
        raise TypeError("counts must be int32 with contiguous samples")
    check_tensor("n_valid", n_valid, torch.int32, (b,), counts.device)
    threshold = float(threshold)
    if not threshold <= 1.0:
        raise ValueError("threshold must be at most 1, got %r" % threshold)
    if cap < 0 or b * n >= 1 << 31:
        raise ValueError("cap must be >= 0 and B * N below 2**31")
    if device_kind(counts) == "cpu":
        return plain.hits_compact(counts, n_valid, threshold, cap)
    if b == 0:
        return torch.zeros(plain.hits_size(0, cap), dtype=torch.int32, device=counts.device)
    rec = torch.empty(plain.hits_size(b, cap), dtype=torch.int32, device=counts.device)
    ld = counts.stride(0) if b > 1 else n
    args = (counts.data_ptr(), b, n, ld, n_valid.data_ptr(), threshold, cap, plain.hits_head(b))
    return launch(hits_compact, counts.device, args, (rec,))[0]


hits_compact.launches = 0
