"""ctypes bindings for the port's native host runtime
(``bigsi_tpu_torch/csrc/host_native.cpp``, a copy of bigsi_tpu's
``native/bigsi_native.cpp``).

The library is optional: every entry point has a numpy implementation
and callers go through :func:`available` / the accelerated wrappers
which fall back transparently.  At first use the host C++ compiler
(``$CXX``, else ``g++``) builds it with the flags of bigsi_tpu's
``native/Makefile`` into ``build/bigsi_tpu_torch/`` at the root of the
checkout (:mod:`bigsi_tpu_torch.ops._build`: a file name hashed from the
source and flags, a private name renamed into place).
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

from bigsi_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

SOURCE = "host_native.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native", "-pthread",
             "-shared")  # native/Makefile's

_lib = None
_tried = False
_lock = threading.Lock()


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = _build.build(SOURCE, os.environ.get("CXX") or "g++", CXX_FLAGS)
        except (OSError, RuntimeError) as e:
            logger.warning(
                "native library build FAILED (%s) — host query prep falls "
                "back to numpy, a ~60x serving-path slowdown", e,
            )
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.murmur3_32.restype = ctypes.c_uint32
            lib.murmur3_32.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_uint32,
            ]
            lib.grouped_streams.restype = ctypes.c_int64
            lib.prep_minimizer_v2.restype = ctypes.c_int64
            lib.prep_minimizer_v3.restype = ctypes.c_int64
            lib.prep_minimizer_v3_seqs.restype = ctypes.c_int64
            _lib = lib
        except (OSError, AttributeError) as e:
            logger.warning(
                "could not load native lib (%s) — host query prep falls "
                "back to numpy, a ~60x serving-path slowdown",
                e,
            )
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def hash_kmer_batch(kmers: np.ndarray, h: int, m: int) -> np.ndarray | None:
    """Native fast path for hashing.murmur3.hash_kmer_matrix."""
    lib = _load()
    if lib is None:
        return None
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    K, k = kmers.shape
    out = np.empty((K, h), dtype=np.int64)
    lib.hash_kmer_batch(
        _ptr(kmers),
        ctypes.c_int64(K),
        ctypes.c_int(k),
        ctypes.c_int(h),
        ctypes.c_int64(m),
        _ptr(out),
    )
    return out


def minimizer_tiles_batch(
    kmers: np.ndarray, s: int, seed: int, num_tiles: int
) -> np.ndarray | None:
    """Native fast path for hashing.scheme.minimizer_tiles.

    Exploits k-mer matrix row overlap (rolling window reuse) — ~100x
    the numpy path on sliding-window query batches.
    """
    lib = _load()
    if lib is None:
        return None
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    K, k = kmers.shape
    if s < 1 or s > k or s > 64 or k - s + 1 > 64:
        return None  # numpy fallback handles out-of-range windows
    out = np.empty(K, dtype=np.int64)
    lib.minimizer_tiles_batch(
        _ptr(kmers),
        ctypes.c_int64(K),
        ctypes.c_int(k),
        ctypes.c_int(s),
        ctypes.c_uint32(seed & 0xFFFFFFFF),
        ctypes.c_int64(num_tiles),
        _ptr(out),
    )
    return out


def bloom_insert_batch(kmers: np.ndarray, h: int, m: int, bloom: np.ndarray) -> bool:
    """Set bloom bits for all kmers into a uint8 0/1 bitmap. True if native ran."""
    lib = _load()
    if lib is None:
        return False
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    assert bloom.dtype == np.uint8 and bloom.flags.c_contiguous
    K, k = kmers.shape
    lib.bloom_insert_batch(
        _ptr(kmers),
        ctypes.c_int64(K),
        ctypes.c_int(k),
        ctypes.c_int(h),
        ctypes.c_int64(m),
        _ptr(bloom),
    )
    return True


def transpose_blooms(blooms, num_rows: int, w_out: int) -> np.ndarray | None:
    """Native bitslice transpose: list of uint8 0/1 arrays -> uint32 rows."""
    lib = _load()
    if lib is None:
        return None
    arrs = [np.ascontiguousarray(b, dtype=np.uint8) for b in blooms]
    ptrs = (ctypes.c_void_p * len(arrs))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs]
    )
    out = np.zeros((num_rows, w_out), dtype=np.uint32)
    lib.transpose_blooms(
        ptrs,
        ctypes.c_int64(len(arrs)),
        ctypes.c_int64(num_rows),
        _ptr(out),
        ctypes.c_int64(w_out),
    )
    return out


def grouped_streams(
    tile: np.ndarray, smask: np.ndarray, r: int
) -> tuple[np.ndarray, np.ndarray, int] | None:
    """Native fast path for ops.lookup.build_grouped_streams.

    Returns (utile int32[B, K], gmask uint32[B, K, r], u_max) with only
    the first u_max entry columns populated, or None without the lib.
    """
    lib = _load()
    if lib is None:
        return None
    tile = np.ascontiguousarray(tile, dtype=np.int32)
    smask = np.ascontiguousarray(smask, dtype=np.uint32)
    b, k = tile.shape
    utile = np.zeros((b, k), dtype=np.int32)
    gmask = np.zeros((b, k, r), dtype=np.uint32)
    u_max = lib.grouped_streams(
        _ptr(tile),
        _ptr(smask),
        ctypes.c_int64(b),
        ctypes.c_int64(k),
        ctypes.c_int(r),
        _ptr(utile),
        _ptr(gmask),
    )
    return utile, gmask, int(u_max)


def minimizer_tiles_v2(
    kmers: np.ndarray, s: int, seed: int, num_tiles: int
) -> np.ndarray | None:
    """Slot-scheme-v2 tiles: canonical s-mer single-murmur window hash."""
    lib = _load()
    if lib is None:
        return None
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    K, k = kmers.shape
    if s < 1 or s > k or s > 64 or k - s + 1 > 64:
        return None
    out = np.empty(K, dtype=np.int64)
    lib.minimizer_tiles_v2(
        _ptr(kmers),
        ctypes.c_int64(K),
        ctypes.c_int(k),
        ctypes.c_int(s),
        ctypes.c_uint32(seed & 0xFFFFFFFF),
        ctypes.c_int64(num_tiles),
        _ptr(out),
    )
    return out


def prep_minimizer_v2(
    kmers: np.ndarray,
    qstart: np.ndarray,
    s: int,
    seed: int,
    num_tiles: int,
    h: int,
    tile_rows: int,
    r: int,
    nthreads: int = 0,
    u_bucket: int = 16,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Fused serving prep: ASCII k-mer rows -> grouped device streams.

    kmers uint8[n, k] (concatenated per-query rows), qstart int64[B+1]
    -> (utile int32[B, U], gmask uint32[B, U, r], n_valid int32[B])
    with U bucketed to ``u_bucket``.  One threaded C pass replaces the
    canonicalize / minimizer / hash / stream-build serving prep chain
    (slot scheme v2 only).  None without the lib or on bad parameters.
    """
    lib = _load()
    if lib is None:
        return None
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    qstart = np.ascontiguousarray(qstart, dtype=np.int64)
    b = len(qstart) - 1
    n, k = kmers.shape
    if b < 0 or qstart[-1] != n:
        return None
    k_cap = int(np.diff(qstart).max()) if b else 0
    k_cap = max(k_cap, 1)
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    utile = np.zeros((b, k_cap), dtype=np.int32)
    gmask = np.zeros((b, k_cap, r), dtype=np.uint32)
    n_valid = np.zeros(b, dtype=np.int32)
    u_max = lib.prep_minimizer_v2(
        _ptr(kmers),
        _ptr(qstart),
        ctypes.c_int64(b),
        ctypes.c_int(k),
        ctypes.c_int(s),
        ctypes.c_uint32(seed & 0xFFFFFFFF),
        ctypes.c_int64(num_tiles),
        ctypes.c_int(h),
        ctypes.c_int(tile_rows),
        ctypes.c_int(r),
        ctypes.c_int64(k_cap),
        ctypes.c_int(nthreads),
        _ptr(utile),
        _ptr(gmask),
        _ptr(n_valid),
    )
    if u_max < 0:
        return None
    u = max(u_bucket, ((int(u_max) + u_bucket - 1) // u_bucket) * u_bucket)
    u = min(u, k_cap)
    return (
        np.ascontiguousarray(utile[:, :u]),
        np.ascontiguousarray(gmask[:, :u]),
        n_valid,
    )


def minimizer_tiles_v3(
    kmers: np.ndarray, s: int, seed: int, num_tiles: int
) -> np.ndarray | None:
    """Slot-scheme-v3 tiles: rolling 2-bit codes + splitmix64 ordering."""
    lib = _load()
    if lib is None:
        return None
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    K, k = kmers.shape
    if s < 1 or s > k or k > 32 or k - s + 1 > 64:
        return None
    out = np.empty(K, dtype=np.int64)
    lib.minimizer_tiles_v3(
        _ptr(kmers),
        ctypes.c_int64(K),
        ctypes.c_int(k),
        ctypes.c_int(s),
        ctypes.c_uint64(seed),
        ctypes.c_int64(num_tiles),
        _ptr(out),
    )
    return out


def prep_minimizer_v3(
    kmers: np.ndarray,
    qstart: np.ndarray,
    s: int,
    seed: int,
    num_tiles: int,
    h: int,
    tile_rows: int,
    r: int,
    nthreads: int = 0,
    u_bucket: int = 16,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Fused serving prep, slot scheme v3 (rolling 2-bit codes +
    splitmix64 — O(1) per k-mer, no byte hashing).  Same contract as
    :func:`prep_minimizer_v2`."""
    lib = _load()
    if lib is None:
        return None
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    qstart = np.ascontiguousarray(qstart, dtype=np.int64)
    b = len(qstart) - 1
    n, k = kmers.shape
    if b < 0 or qstart[-1] != n:
        return None
    k_cap = int(np.diff(qstart).max()) if b else 0
    k_cap = max(k_cap, 1)
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    utile = np.zeros((b, k_cap), dtype=np.int32)
    gmask = np.zeros((b, k_cap, r), dtype=np.uint32)
    n_valid = np.zeros(b, dtype=np.int32)
    u_max = lib.prep_minimizer_v3(
        _ptr(kmers),
        _ptr(qstart),
        ctypes.c_int64(b),
        ctypes.c_int(k),
        ctypes.c_int(s),
        ctypes.c_uint64(seed),
        ctypes.c_int64(num_tiles),
        ctypes.c_int(h),
        ctypes.c_int(tile_rows),
        ctypes.c_int(r),
        ctypes.c_int64(k_cap),
        ctypes.c_int(nthreads),
        _ptr(utile),
        _ptr(gmask),
        _ptr(n_valid),
    )
    if u_max < 0:
        return None
    u = max(u_bucket, ((int(u_max) + u_bucket - 1) // u_bucket) * u_bucket)
    u = min(u, k_cap)
    return (
        np.ascontiguousarray(utile[:, :u]),
        np.ascontiguousarray(gmask[:, :u]),
        n_valid,
    )


def prep_minimizer_v3_seqs(
    seqs: np.ndarray,
    sstart: np.ndarray,
    k: int,
    s: int,
    seed: int,
    num_tiles: int,
    h: int,
    tile_rows: int,
    r: int,
    nthreads: int = 0,
    u_bucket: int = 16,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Fused serving prep straight from SEQUENCES (slot scheme v3).

    seqs uint8[total_len] (concatenated ACGT query bytes), sstart
    int64[B+1] -> (utile int32[B, U], gmask uint32[B, U, r], n_valid
    int32[B]).  The k-mer windows are implied — no [n, k] row
    materialization, no per-row overlap memcmp — and raw-kmer dedup
    (the reference's ``set(kmers)``) runs inline, so ``n_valid`` is the
    DISTINCT k-mer count.  ACGT-only input is the caller's contract
    (gate with :func:`ascii_acgt_only` or equivalent; other bytes make
    2-bit codes non-injective and dedup semantics drift from the
    reference's raw-string set).  None without the lib / bad params.
    """
    lib = _load()
    if lib is None:
        return None
    seqs = np.ascontiguousarray(seqs, dtype=np.uint8)
    sstart = np.ascontiguousarray(sstart, dtype=np.int64)
    b = len(sstart) - 1
    if b < 0 or sstart[-1] != seqs.shape[0]:
        return None
    lens = np.diff(sstart)
    k_cap = int(np.maximum(lens - k + 1, 0).max()) if b else 0
    k_cap = max(k_cap, 1)
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    utile = np.zeros((b, k_cap), dtype=np.int32)
    gmask = np.zeros((b, k_cap, r), dtype=np.uint32)
    n_valid = np.zeros(b, dtype=np.int32)
    u_max = lib.prep_minimizer_v3_seqs(
        _ptr(seqs),
        _ptr(sstart),
        ctypes.c_int64(b),
        ctypes.c_int(k),
        ctypes.c_int(s),
        ctypes.c_uint64(seed),
        ctypes.c_int64(num_tiles),
        ctypes.c_int(h),
        ctypes.c_int(tile_rows),
        ctypes.c_int(r),
        ctypes.c_int64(k_cap),
        ctypes.c_int(nthreads),
        _ptr(utile),
        _ptr(gmask),
        _ptr(n_valid),
    )
    if u_max < 0:
        return None
    u = max(u_bucket, ((int(u_max) + u_bucket - 1) // u_bucket) * u_bucket)
    u = min(u, k_cap)
    return (
        np.ascontiguousarray(utile[:, :u]),
        np.ascontiguousarray(gmask[:, :u]),
        n_valid,
    )


def decode_cortex_kmers(packed: np.ndarray, k: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint64)
    out = np.empty((len(packed), k), dtype=np.uint8)
    lib.decode_cortex_kmers(
        _ptr(packed), ctypes.c_int64(len(packed)), ctypes.c_int(k), _ptr(out)
    )
    return out


def canonicalize_kmers_inplace(kmers: np.ndarray) -> bool:
    lib = _load()
    if lib is None or kmers.shape[1] > 64:
        return False
    assert kmers.dtype == np.uint8 and kmers.flags.c_contiguous
    lib.canonicalize_kmers(
        _ptr(kmers), ctypes.c_int64(kmers.shape[0]), ctypes.c_int(kmers.shape[1])
    )
    return True


def and_count_rows(matrix: np.ndarray, idx: np.ndarray) -> np.ndarray | None:
    """Host query fast path: AND h rows per kmer + per-sample counts."""
    lib = _load()
    if lib is None:
        return None
    matrix = np.ascontiguousarray(matrix, dtype=np.uint32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    K, h = idx.shape
    counts = np.zeros(matrix.shape[1] * 32, dtype=np.int64)
    lib.and_count_rows(
        _ptr(matrix),
        ctypes.c_int64(matrix.shape[1]),
        _ptr(idx),
        ctypes.c_int64(K),
        ctypes.c_int(h),
        _ptr(counts),
    )
    return counts


def and_count_words(
    matrix: np.ndarray, idx: np.ndarray, word_ids: np.ndarray
) -> np.ndarray | None:
    """Classic verify fast path: AND the candidate WORD of each k-mer's
    h rows and count bits — int64 [nw*32].  ``matrix`` may be the
    rows.bin memmap (C-contiguous: no copy)."""
    lib = _load()
    if lib is None:
        return None
    matrix = np.ascontiguousarray(matrix, dtype=np.uint32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    word_ids = np.ascontiguousarray(word_ids, dtype=np.int32)
    K, h = idx.shape
    nw = word_ids.shape[0]
    counts = np.zeros(nw * 32, dtype=np.int64)
    lib.and_count_words(
        _ptr(matrix),
        ctypes.c_int64(matrix.shape[1]),
        _ptr(idx),
        ctypes.c_int64(K),
        ctypes.c_int(h),
        _ptr(word_ids),
        ctypes.c_int64(nw),
        _ptr(counts),
    )
    return counts


def and_count_words_batch(
    matrix: np.ndarray,
    idx: np.ndarray,
    qstart: np.ndarray,
    word_ids: np.ndarray,
    wstart: np.ndarray,
    nw_cap: int,
    nthreads: int = 0,
) -> np.ndarray | None:
    """Batched classic verify (threaded over queries).

    idx int64[sum_K, h] concatenated per-query rows; qstart int64[B+1];
    word_ids int32[sum_nw] concatenated per-query candidate words;
    wstart int64[B+1] -> counts int64[B, nw_cap*32] (query q's word j
    counts at [q, j*32 + bit]).
    """
    lib = _load()
    if lib is None:
        return None
    matrix = np.ascontiguousarray(matrix, dtype=np.uint32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    qstart = np.ascontiguousarray(qstart, dtype=np.int64)
    word_ids = np.ascontiguousarray(word_ids, dtype=np.int32)
    wstart = np.ascontiguousarray(wstart, dtype=np.int64)
    B = qstart.shape[0] - 1
    if idx.size == 0 or B <= 0:
        return np.zeros((max(B, 0), nw_cap * 32), dtype=np.int64)
    h = idx.shape[1]
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    out = np.zeros((B, nw_cap * 32), dtype=np.int64)
    lib.and_count_words_batch(
        _ptr(matrix),
        ctypes.c_int64(matrix.shape[1]),
        _ptr(idx),
        _ptr(qstart),
        ctypes.c_int64(B),
        ctypes.c_int(h),
        _ptr(word_ids),
        _ptr(wstart),
        ctypes.c_int64(nw_cap),
        ctypes.c_int(nthreads),
        _ptr(out),
    )
    return out
