"""CUDA compute engine: the bitslice matrix resident on the card.

The port of ``bigsi_tpu/index/device_engine.py:DeviceEngine`` for
search.  Same method surface as
:class:`bigsi_tpu_torch.index.host_engine.HostEngine` (numpy in, numpy out),
so it plugs into the facade's engine seam.  The matrix goes to the
device once, row-major, as ``int32[m_pad, W]`` holding the uint32 bits
(:func:`load_words`), or in the cols layout (:func:`load_cols`); the
tiled layouts zero-pad it to whole tiles, and tile ``t`` is rows
``t * tile_rows ... t * tile_rows + tile_rows - 1``.

* classic: kernel A (:func:`~bigsi_tpu_torch.ops.fused_lookup.classic_counts`)
  gathers each k-mer's h rows, ANDs them and counts hits per sample;
* blocked: kernel B (:func:`~bigsi_tpu_torch.ops.fused_lookup.tile_counts`)
  takes each k-mer's tile and a 64-bit slot mask instead;
* minimizer: consecutive k-mers share tiles, so the per-k-mer streams
  are grouped (:func:`~bigsi_tpu_torch.ops.lookup.build_grouped_streams`:
  one entry per run of a tile, a slot per k-mer).  At tile_rows up to
  32 the engine builds the cols layout at load with kernel D
  (:func:`~bigsi_tpu_torch.ops.fused_lookup.pack_tile_cols`), one chunk
  of rows at a time, never holding the row-major words, and counts with
  kernel E
  (:func:`~bigsi_tpu_torch.ops.fused_lookup.cols_counts`); at tile_rows 64
  kernel C (:func:`~bigsi_tpu_torch.ops.fused_lookup.grouped_tile_counts`)
  counts over the row-major words.

On a cols engine with slot scheme 3, ``counts_batch_seqs`` (the seq
serving arm) serves the facade's unscored all-ACGT batches from padded
query bytes, all on the card: kernel H
(:func:`~bigsi_tpu_torch.ops.fused_lookup.seq_streams`) builds the
grouped streams, kernel E counts them, and one read of ``ok`` is the
only sync before the counts come back; a batch that overflows the entry
budget, or that the geometry guard refuses, returns None and takes the
host paths.  On a cols engine with slot scheme 2 or 3 and the native
library, ``counts_batch_kmers`` serves the other batches straight from
ASCII k-mers: the threaded native prep builds the grouped
streams, the next chunk's prep overlapping the current chunk's kernel.
A single query reduces through its layout's kernel as a batch of one.
``counts_batch`` and ``counts_batch_seqs`` given a threshold keep the
counts on the card: kernel M
(:func:`~bigsi_tpu_torch.ops.fused_lookup.hits_compact`) thresholds
them and only each query's hits come back (:class:`Hits`), in one copy
into a pinned host buffer the engine keeps; a batch whose hits outgrow
the record's room takes the dense copy in the same call.
Scoring's presence strings come from kernel L's strings form
(``presence_strings``), one launch a scored search or batch; kernel L's
row form serves ``presence_matrix``.  A verified index's
verify runs on :class:`DeviceVerifier` (kernel A over
``rows.bin``, only the candidates' counts sent back).  PyTorch compiles
nothing per shape, so no bucketing of K is needed; the seq arm keeps
the JAX engine's byte and batch buckets, which its guard and its
per-bucket budgets are defined on.
"""

from __future__ import annotations

import contextvars
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from bigsi_tpu_torch import native
from bigsi_tpu_torch.hashing.scheme import (
    MINIMIZER_SEED,
    TILE_ROWS,
    default_minimizer_s,
    default_run_len,
    window_to_s,
)
from bigsi_tpu_torch.index.verify import live_queries
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.utils.profiling import metrics, phase
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.ops.fused_lookup import (
    classic_counts,
    cols_counts,
    grouped_tile_counts,
    hits_compact,
    pack_tile_cols,
    presence_rows,
    presence_strings,
    seq_streams,
    tile_counts,
)

TILED_LAYOUTS = ("blocked", "minimizer")
LOAD_CHUNK_ROWS = 1 << 20  # rows per host->device copy in load_words and load_cols
# the hits record's room a query (at most its samples): a query of the
# benchmark's gene and short traffic hits at most 4 of 8,192 (PERF.md
# section 4); a batch past the room takes the dense copy
HITS_PER_QUERY = 64

# long-query guards of the seq arm, kept equal to the JAX engine's routing
# (bigsi_tpu/index/device_engine.py): a hard NK ceiling, and a B*NK^2
# budget (256 queries of 1,024 k-mers) that bounds the JAX prep's
# quadratic passes.  Kernel H's dedup is linear (the whole kernel takes
# 0.042 ms at B = 8, NK = 4,066 on an H100 80GB HBM3 at 700 W), so here
# the guard only mirrors which batches the JAX engine sends to the seq arm.
SEQ_MAX_NK = 4096
SEQ_QUAD_WORK_BUDGET = 256 * 1024 * 1024


def seq_batch_geometry(seqs, lens, k: int, window: int, db: int = 1):
    """The JAX engine's bucketing and guards for ``counts_batch_seqs``:
    64-byte length buckets, a power-of-two batch bucket (at least 8)
    rounded up to a multiple of ``db`` (a mesh's batch axis), the
    quadratic-work guard and the grouped-entry budget.  Returns None
    when the batch must take a host path, else (padded uint8[BB, LB],
    lens int32[BB], lb, u_cap); padding bytes are ``A`` and padding
    queries have length 0."""
    b, l = seqs.shape
    lb = max(k, ((l + 63) // 64) * 64)
    bb = 8
    while bb < b:
        bb *= 2
    bb = -(-bb // db) * db
    nk = lb - k + 1
    if nk > SEQ_MAX_NK:
        return None
    if nk > 1024 and bb * nk * nk > SEQ_QUAD_WORK_BUDGET:
        return None
    padded = np.full((bb, lb), ord("A"), dtype=np.uint8)
    padded[:b, :l] = seqs
    lens_b = np.zeros(bb, dtype=np.int32)
    lens_b[:b] = lens
    u_cap = DeviceEngine._seq_u_cap(lb - k + 1, window)
    return padded, lens_b, lb, u_cap


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  A CUDA device without CUDA raises: the
    engine never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bigsi_tpu_torch's engine needs a CUDA device and none is "
            "available (device='cpu' runs the plain PyTorch versions)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %s" % dev)
    return dev


VERIFY_HEADROOM = 1 << 30  # device bytes left beside a staged rows.bin (A's batches)


def device_fits(nbytes: int, device: torch.device) -> bool:
    """Whether ``nbytes`` more fit on ``device`` now with
    VERIFY_HEADROOM to spare: the free memory CUDA reports plus what torch's
    allocator holds cached and unused.  The CPU always fits."""
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return nbytes + VERIFY_HEADROOM <= free + cached


def load_words(
    words: np.ndarray, device, tile_rows: int | None = None, shape: tuple | None = None
) -> torch.Tensor:
    """The JAX package's matrix (``BitSliceMatrix.words``, numpy
    uint32[m, W] in RAM or mmap, or a view of it) -> int32[m_pad, W] on
    ``device`` holding the same bits.  With ``tile_rows``, m_pad rounds m
    up to whole tiles and the added rows are zero.  ``shape`` (rows,
    words), at least that, makes the output larger, the added rows and
    words zero: a mesh's shard.  Copied in row chunks, so a mmap'd
    matrix (or a column slice of it) never has a second full copy in
    host RAM."""
    if words.ndim != 2 or words.dtype != np.uint32:
        raise ValueError("words must be uint32 [m, W]")
    m, w = words.shape
    m_pad = m if tile_rows is None else -(-m // tile_rows) * tile_rows
    rows, width = shape or (m_pad, w)
    if rows < m_pad or width < w:
        raise ValueError("shape %s is smaller than the matrix's %s" % ((rows, width), (m_pad, w)))
    out = torch.empty((rows, width), dtype=torch.int32, device=device)
    out[m:].zero_()
    out[:m, w:].zero_()
    for r0 in range(0, m, LOAD_CHUNK_ROWS):
        chunk = np.array(words[r0 : r0 + LOAD_CHUNK_ROWS]).view(np.int32)
        out[r0 : r0 + chunk.shape[0], :w].copy_(torch.from_numpy(chunk))
    return out


def load_cols(words: np.ndarray, device, tile_rows: int, width: int | None = None) -> torch.Tensor:
    """The JAX package's matrix (numpy uint32[m, W], or a view of it) ->
    its cols layout on ``device`` (kernel D's output over the matrix
    zero-padded to whole tiles, and to ``width`` words where that is
    given: a mesh's shard), built chunk by chunk so the row-major matrix
    is never whole on the device.  cols is allocated first; then each
    chunk of whole tiles (about LOAD_CHUNK_ROWS rows) is copied into a
    host staging buffer, on to a device staging buffer and packed into
    its slice of cols.  On CUDA the host buffers are pinned and there are
    two of each:
    a copy stream brings chunk i + 1 while the current stream packs chunk
    i, events ordering each buffer's reuse.  The load's device peak is
    cols plus two chunks."""
    if words.ndim != 2 or words.dtype != np.uint32:
        raise ValueError("words must be uint32 [m, W]")
    m, w = words.shape
    if width is not None:
        if width < w:
            raise ValueError("width %d is narrower than the matrix's %d words" % (width, w))
        w = width
    num_tiles = -(-m // tile_rows)
    cols = torch.empty((num_tiles, w * 32), dtype=plain.cols_dtype(tile_rows), device=device)
    chunk_tiles = max(1, LOAD_CHUNK_ROWS // tile_rows)
    spans = [(t0, min(num_tiles, t0 + chunk_tiles)) for t0 in range(0, num_tiles, chunk_tiles)]
    rows = min(num_tiles, chunk_tiles) * tile_rows
    cuda = cols.device.type == "cuda"
    slots = 2 if cuda else 1
    host = [torch.empty((rows, w), dtype=torch.int32, pin_memory=cuda) for _ in range(slots)]
    if not cuda:
        for t0, t1 in spans:
            buf = stage_rows(words, t0 * tile_rows, t1 * tile_rows, host[0])
            pack_tile_cols(buf, tile_rows, out=cols[t0:t1])
        return cols
    with torch.cuda.device(cols.device):
        dev = [torch.empty((rows, w), dtype=torch.int32, device=cols.device) for _ in range(slots)]
        compute = torch.cuda.current_stream()
        copier = torch.cuda.Stream()
        copied = [torch.cuda.Event() for _ in range(slots)]
        packed = [torch.cuda.Event() for _ in range(slots)]
        for i, (t0, t1) in enumerate(spans):
            k = i % slots
            if i >= slots:
                copied[k].synchronize()  # the host buffer's last copy is done
            buf = stage_rows(words, t0 * tile_rows, t1 * tile_rows, host[k])
            n = buf.shape[0]
            with torch.cuda.stream(copier):
                if i >= slots:
                    copier.wait_event(packed[k])  # the device buffer's last pack is done
                dev[k][:n].copy_(buf, non_blocking=True)
                copied[k].record(copier)
            compute.wait_event(copied[k])
            pack_tile_cols(dev[k][:n], tile_rows, out=cols[t0:t1])
            packed[k].record(compute)
        compute.wait_stream(copier)
    return cols


def stage_rows(words: np.ndarray, r0: int, r1: int, buf: torch.Tensor) -> torch.Tensor:
    """Rows [r0, r1) of ``words`` (uint32, rows past its end and words
    past its width read as zero) into the first r1 - r0 rows of the
    int32 staging ``buf``; returns that slice."""
    out = buf[: r1 - r0]
    host = out.numpy().view(np.uint32)
    n = max(0, min(r1, words.shape[0]) - r0)
    w = words.shape[1]
    host[:n, :w] = words[r0 : r0 + n]
    host[:n, w:] = 0
    host[n:] = 0
    return out


def tile_streams(row_idx: torch.Tensor, mask: torch.Tensor, tile_rows: int):
    """Row ids int[..., h] of a tiled layout (all h rows of a k-mer lie
    in one tile) and validity bool[...] -> (tile int32[...], slot mask
    int64[...]), on the tensors' device; bit s of a mask selects row s
    of the tile, and masked-out k-mers get tile 0 and mask 0.  The masks
    are 64 bits wide, so tile_rows 64 keeps rows 32-63 (the JAX engine's
    uint32 masks drop them)."""
    tile, smask = plain.slot_streams(row_idx, tile_rows)
    return torch.where(mask, tile, 0), torch.where(mask, smask, 0)


def counts_to_host(counts: torch.Tensor) -> np.ndarray:
    """Device counts -> int64 numpy, in two spans: ``engine.counts_back``
    (the copy, which waits for the kernels before it) and
    ``engine.widen`` (int32 -> int64 on the host)."""
    with phase("engine.counts_back"):
        host = counts.cpu()
    with phase("engine.widen"):
        return host.numpy().astype(np.int64)


class Hits(NamedTuple):
    """A batch's hits, query by query: query q's are ``colours[off[q] :
    off[q + 1]]`` (ascending) with their ``found`` counts, out of its
    ``nks[q]`` distinct k-mers.  int64 numpy arrays, the counts first as
    in the engine's dense returns."""

    found: np.ndarray  # [total]
    colours: np.ndarray  # [total]
    off: np.ndarray  # [B + 1]
    nks: np.ndarray  # [B]


def dense_hits(counts: np.ndarray, nks, threshold: float) -> Hits:
    """The host's threshold of dense counts int[B, N]: a sample is a hit
    of query q when its count reaches ``ceil(nks[q] * threshold)``
    (float64, the facade's ``math.ceil`` bit for bit); a query of no
    distinct k-mer has none."""
    nks = np.asarray(nks, dtype=np.int64).reshape(-1)
    mins = np.maximum(np.ceil(nks * float(threshold)), 0).astype(np.int64)
    sel = counts >= mins[:, None]
    sel[nks == 0] = False
    q, c = np.nonzero(sel)  # row-major: colours ascending within a query
    off = np.zeros(nks.size + 1, dtype=np.int64)
    np.cumsum(np.bincount(q, minlength=nks.size), out=off[1:])
    return Hits(counts[q, c].astype(np.int64), c.astype(np.int64), off, nks)


def decode_hits(rec: np.ndarray, b: int, cap: int) -> Hits:
    """A hits record (``ops/lookup.py:hits_compact``, int32, a total of at
    most ``cap``) -> :class:`Hits`, each query's segment read from its
    start; every array is a copy, so ``rec`` may be reused."""
    total = int(rec[0])
    nks, start, cnt = (rec[1 + i * b : 1 + (i + 1) * b].astype(np.int64) for i in range(3))
    off = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    src = np.repeat(start - off[:-1], cnt) + np.arange(total)
    head = plain.hits_head(b)
    ent = rec[head : head + 2 * cap].reshape(cap, 2)[src].astype(np.int64)
    return Hits(ent[:, 1], ent[:, 0], off, nks)


def kmer_streams_to_device(prep, device):
    """The native prep's (utile int32[B, U], gmask uint32[B, U, r],
    n_valid int32[B]) -> the same on ``device``, gmask as int64, as
    kernel E takes them.  The masks cross at their native 32 bits and
    are widened on the device."""
    utile, gmask, n_valid = (
        torch.from_numpy(np.ascontiguousarray(a, dtype=dtype).view(np.int32)).to(device)
        for a, dtype in zip(prep, (np.int32, np.uint32, np.int32))
    )
    return utile, gmask.long() & 0xFFFFFFFF, n_valid


def _counts_batch_seqs(cols, seqs, lens, *, k, s, num_tiles, h, tile_rows, r, u_cap, seed):
    """Padded query bytes to per-sample hit counts on ``cols``' device:
    kernel H builds the grouped streams, kernel E counts them.  seqs
    uint8[B, L], lens int32[B] -> (counts int32[B, N], n_valid int32[B]
    distinct k-mers, ok bool[]), ``ok`` False when a query needs more than
    ``u_cap`` grouped entries (the counts are then not valid)."""
    utile, gmask, n_valid, ok = seq_streams(
        seqs, lens, k=k, s=s, num_tiles=num_tiles, h=h, tile_rows=tile_rows, r=r,
        u_cap=u_cap, seed=seed,
    )
    counts, _ = cols_counts(cols, utile, gmask, n_valid)
    return counts, n_valid, ok


class DeviceEngine:
    SERVE_CHUNK = 256  # queries per kernel launch in counts_batch_kmers
    # clean big-budget batches (per length bucket) before
    # counts_batch_seqs retries the tight grouped-entry budget
    SEQ_CAP_DECAY = 64

    def __init__(
        self, matrix: BitSliceMatrix, device=None, layout: str = "classic",
        tile_rows: int = TILE_ROWS, minimizer_window: int | None = None,
        slot_scheme: int = 1, run_len: int | None = None,
    ):
        if layout != "classic" and layout not in TILED_LAYOUTS:
            raise ValueError("unknown layout %r" % layout)
        self.matrix = matrix
        self.device = resolve_device(device)
        self.layout = layout
        self.tile_rows = tile_rows
        self.tiled = layout in TILED_LAYOUTS
        self.minimizer_window = minimizer_window
        self.slot_scheme = slot_scheme
        # grouped-stream slots per entry: persisted per index, else the
        # JAX engine's default for the window (r = w + 1 for w >= 15)
        if run_len is None and layout == "minimizer":
            run_len = default_run_len(minimizer_window)
        self.run_len = run_len
        # counts_batch_seqs' escalation state: {padded length lb:
        # big-budget batches left before the tight budget is retried}
        self._seq_cap_esc = {}
        # each calling thread's pinned buffer of the hits record, reused
        # call after call (fresh pages every call cost the host, PERF.md §6)
        self._hits_host = threading.local()
        rows = matrix.num_rows
        if self.tiled:
            rows = -(-rows // tile_rows) * tile_rows
        if rows >= 1 << 31:
            raise ValueError("row ids are int32: at most 2**31 - 1 rows")
        self.words = self.cols = None
        if layout == "minimizer" and plain.cols_dtype(tile_rows) is not None:
            # the same bits, transposed within each tile, packed chunk by
            # chunk: the row-major matrix is never whole on the device
            self.cols = load_cols(np.asarray(matrix.words), self.device, tile_rows)
        else:
            self.words = load_words(
                np.asarray(matrix.words), self.device, tile_rows if self.tiled else None
            )

    def _to_device(self, arr: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)).to(self.device)

    def _check_rows(self, row_idx: np.ndarray) -> None:
        # an id past the matrix would read out of bounds on the card
        if row_idx.size and (row_idx.min() < 0 or row_idx.max() >= self.matrix.num_rows):
            raise IndexError("row ids must lie in [0, %d)" % self.matrix.num_rows)

    def _reduce(self, row_idx: np.ndarray, mask: np.ndarray):
        """row ids int[B, K, h], bool[B, K] -> (counts int32[B, W * 32],
        exact int32[B, W]) on the device, through the layout's kernel."""
        with phase("engine.rows_in"):  # the id check, conversions, copies in
            self._check_rows(row_idx)
            idx = self._to_device(row_idx, np.int32)
            valid = self._to_device(mask, bool)
        if not self.tiled:
            return classic_counts(self.words, idx, valid)
        tile, smask = tile_streams(idx, valid, self.tile_rows)
        if self.layout == "blocked":
            return tile_counts(self.words, tile, smask, self.tile_rows)
        utile, gmask = plain.build_grouped_streams(tile, smask, self.run_len or plain.GROUP_R)
        if self.cols is None:
            return grouped_tile_counts(self.words, utile, gmask, self.tile_rows)
        n_valid = valid.sum(dim=1, dtype=torch.int32)
        return cols_counts(self.cols, utile, gmask, n_valid)

    # -- single query: `packed` is an opaque handle the facade passes
    #    back; the empty query stays a numpy array, as on the host engine

    def and_rows(self, row_idx: np.ndarray):
        if row_idx.shape[0] == 0:
            return np.empty((0, self.matrix.num_words), dtype=np.uint32)
        return _PackedQuery(np.asarray(row_idx))

    def _single(self, packed) -> tuple[np.ndarray, np.ndarray]:
        idx = packed.row_idx[None]
        counts, exact = self._reduce(idx, np.ones(idx.shape[:2], dtype=bool))
        return counts[0].cpu().numpy(), exact[0].cpu().numpy().view(np.uint32)

    def exact_colours(self, packed) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty(0, dtype=np.int64)
        exact = self._single(packed)[1]
        bits = np.unpackbits(exact.view(np.uint8), bitorder="little")
        return np.flatnonzero(bits[: self.matrix.num_cols]).astype(np.int64)

    def counts(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.zeros(num_cols, dtype=np.int64)
        return self._single(packed)[0][:num_cols].astype(np.int64)

    def presence_matrix(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty((0, num_cols), dtype=np.uint8)
        self._check_rows(packed.row_idx)
        idx = self._to_device(packed.row_idx, np.int32)
        if self.tiled:
            valid = torch.ones(idx.shape[0], dtype=torch.bool, device=self.device)
            tile, smask = tile_streams(idx, valid, self.tile_rows)
            if self.cols is not None:
                rows = presence_rows(self.cols, "cols", tile, smask)
            else:
                rows = presence_rows(self.words, "slot", tile, smask, self.tile_rows)
        else:
            rows = presence_rows(self.words, "classic", idx)
        host = rows.cpu().numpy().view(np.uint32)
        bits = np.unpackbits(host.view(np.uint8), axis=-1, bitorder="little")
        return bits[:, :num_cols]

    def presence_strings(self, row_idx_list, inverse_list, colour_lists, num_cols: int) -> list:
        """Scoring's presence strings of Q queries in one launch of kernel
        L's strings form: query i's distinct k-mers' row ids int[K_i, h],
        the distinct k-mer of each of its positions ``inverse_list[i]``
        int[P_i] and its result colours ``colour_lists[i]`` (each below
        ``num_cols``) -> per query a list of str, one a colour in the
        given order, of P_i characters "0" or "1".  The ids, positions and
        results cross in one int32 buffer (pinned on CUDA), the strings
        come back in one copy; a batch with no colour touches nothing."""
        colours = [np.asarray(c, dtype=np.int64).reshape(-1) for c in colour_lists]
        nres = np.array([c.size for c in colours], dtype=np.int64)
        r = int(nres.sum())
        if r == 0:
            return [[] for _ in colours]
        q = len(colours)
        cs = np.concatenate(colours)
        if cs.min() < 0 or cs.max() >= min(num_cols, self.matrix.num_words * 32):
            raise IndexError("colours must lie in [0, %d)" % num_cols)
        rows = np.concatenate(row_idx_list)  # [sum K, h]
        self._check_rows(rows)
        ps = np.array([np.size(x) for x in inverse_list], dtype=np.int64)
        res_query = np.repeat(np.arange(q), nres)
        lens = ps[res_query]
        # rows, kmer_off, pos_kmer, pos_off, res_query, res_colour; then
        # res_off, int64 at an even int32 offset
        starts = np.cumsum([0, rows.size, q + 1, ps.sum(), q + 1, r, r])
        at = int(starts[-1]) + int(starts[-1]) % 2
        cuda = self.device.type == "cuda"
        buf = torch.empty(at + 2 * (r + 1), dtype=torch.int32, pin_memory=cuda)
        host = buf.numpy()
        for i, values in enumerate((
                rows.reshape(-1), np.cumsum([0] + [x.shape[0] for x in row_idx_list]),
                np.concatenate(inverse_list), np.cumsum(np.concatenate([[0], ps])), res_query,
                cs)):
            host[starts[i]:starts[i + 1]] = values
        res_off = host[at:].view(np.int64)
        res_off[0] = 0
        np.cumsum(lens, out=res_off[1:])
        offs = res_off.tolist()
        dev = buf.to(self.device, non_blocking=True)
        ins = [dev[starts[i]:starts[i + 1]] for i in range(6)]
        ins[0] = ins[0].view(-1, rows.shape[1])
        if not self.tiled:
            matrix, source = self.words, "classic"
        elif self.cols is not None:
            matrix, source = self.cols, "cols"
        else:
            matrix, source = self.words, "slot"
        out = torch.empty(offs[-1], dtype=torch.uint8, device=self.device)
        presence_strings(matrix, source, *ins, self.tile_rows,
                         res_off=dev[at:].view(torch.int64), out=out)
        back = torch.empty(offs[-1], dtype=torch.uint8, pin_memory=cuda)
        back.copy_(out)
        text = back.numpy().tobytes().decode("ascii")
        strings, i = [], 0
        for n in nres.tolist():
            strings.append([text[offs[j]:offs[j + 1]] for j in range(i, i + n)])
            i += n
        return strings

    # -- batched search (the serving path of search_batch / bulk_search)

    def counts_batch(
        self, row_idx: np.ndarray, mask: np.ndarray, num_cols: int,
        threshold: float | None = None, nks: np.ndarray | None = None,
    ):
        """row ids int[B, K, h] (padding k-mers hold any in-range id),
        mask bool[B, K] -> int64[B, num_cols], in one kernel launch.  The
        classic route's hits: given ``threshold`` and nks int[B], each
        query's valid k-mers, the batch's :class:`Hits` instead, the
        counts thresholded on the card (:meth:`_hits`)."""
        b, k = mask.shape
        if b == 0 or k == 0:
            counts = np.zeros((b, num_cols), dtype=np.int64)
            return counts if threshold is None else dense_hits(counts, nks, threshold)
        counts, _ = self._reduce(row_idx, mask)
        if threshold is None:
            return counts_to_host(counts[:, :num_cols])
        return self._hits(counts[:, :num_cols], self._to_device(nks, np.int32), threshold)

    def _hits(self, counts: torch.Tensor, n_valid: torch.Tensor, threshold: float) -> Hits:
        """Device counts int32[B, N] and n_valid int32[B] -> :class:`Hits`:
        kernel M writes the hits record, one copy brings it back (span
        ``engine.counts_back``: it waits for the kernels) into this
        thread's pinned buffer, and its decode is ``engine.widen``.  When
        the hits outgrow the record's room the dense counts come back
        instead (:func:`counts_to_host`) and the host thresholds them.
        Counters ``engine.hits_calls`` and ``engine.hits_overflow``."""
        metrics.incr("engine.hits_calls")
        b, n = counts.shape
        cap = b * min(n, HITS_PER_QUERY)
        rec = hits_compact(counts, n_valid, threshold, cap)
        with phase("engine.counts_back"):
            if rec.device.type == "cuda":
                host = getattr(self._hits_host, "buf", None)
                if host is None or host.numel() < rec.numel():
                    host = self._hits_host.buf = torch.empty(
                        rec.numel(), dtype=torch.int32, pin_memory=True)
                host = host[: rec.numel()].copy_(rec)
            else:
                host = rec
            out = host.numpy()
        if int(out[0]) > cap:
            metrics.incr("engine.hits_overflow")
            nks = out[1 : 1 + b].copy()
            return dense_hits(counts_to_host(counts), nks, threshold)
        with phase("engine.widen"):
            return decode_hits(out, b, cap)

    # -- the k-mer serving path (minimizer cols, slot scheme 2 or 3)

    def supports_kmer_batch(self) -> bool:
        """True when ``counts_batch_kmers`` serves: minimizer layout, slot
        scheme 2 or 3, cols resident, and the native prep library."""
        return (
            self.layout == "minimizer"
            and self.slot_scheme in (2, 3)
            and self.cols is not None
            and native.available()
        )

    def _prep_kmer_chunk(self, kmer_rows, qstart, h):
        """One threaded native pass: ASCII k-mer rows uint8[n, k], qstart
        int64[B+1] -> (utile, gmask uint32, n_valid) numpy grouped
        streams.  The native masks are 32 bits wide, enough for the cols
        layout's tile_rows of at most 32."""
        k = kmer_rows.shape[1]
        s = window_to_s(k, self.minimizer_window) or default_minimizer_s(k)
        num_tiles = max(1, self.matrix.num_rows // self.tile_rows)
        prep = native.prep_minimizer_v3 if self.slot_scheme == 3 else native.prep_minimizer_v2
        with phase("engine.kmer_prep"):
            out = prep(
                kmer_rows, qstart, s, MINIMIZER_SEED, num_tiles, h, self.tile_rows,
                self.run_len or plain.GROUP_R,
            )
        if out is None:
            raise RuntimeError(
                "native prep unavailable: call supports_kmer_batch() first"
            )
        return out

    def _dispatch_kmer_chunk(self, prep, num_cols: int) -> np.ndarray:
        """Copies in, kernel E, counts back (timed as one span)."""
        with phase("engine.kmer_counts"):
            utile, gmask, n_valid = kmer_streams_to_device(prep, self.device)
            counts, _ = cols_counts(self.cols, utile, gmask, n_valid)
            return counts_to_host(counts[:, :num_cols])

    def counts_batch_kmers(
        self, kmer_rows: np.ndarray, qstart: np.ndarray, h: int, num_cols: int
    ) -> np.ndarray:
        """ASCII k-mers straight to per-query counts: kmer_rows uint8[n, k]
        (each query's distinct k-mers, concatenated), qstart int64[B+1] ->
        int64[B, num_cols].  Batches past SERVE_CHUNK go in chunks, the
        next chunk's native prep (which releases the GIL) submitted to a
        worker thread before the current chunk's kernel is dispatched."""
        b = len(qstart) - 1
        if b == 0:
            return np.zeros((0, num_cols), dtype=np.int64)
        chunk = self.SERVE_CHUNK
        if b <= chunk:
            return self._dispatch_kmer_chunk(self._prep_kmer_chunk(kmer_rows, qstart, h), num_cols)
        spans = [(q0, min(q0 + chunk, b)) for q0 in range(0, b, chunk)]

        def prep(span):
            q0, q1 = span
            r0, r1 = qstart[q0], qstart[q1]
            return self._prep_kmer_chunk(kmer_rows[r0:r1], qstart[q0 : q1 + 1] - r0, h)

        out = np.zeros((b, num_cols), dtype=np.int64)
        # the worker's spans are children of the caller's
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(contextvars.copy_context().run, prep, spans[0])
            for i, (q0, q1) in enumerate(spans):
                ready = pending.result()
                if i + 1 < len(spans):
                    pending = pool.submit(contextvars.copy_context().run, prep, spans[i + 1])
                out[q0:q1] = self._dispatch_kmer_chunk(ready, num_cols)
        return out

    # -- the seq serving arm (minimizer cols, slot scheme 3)

    def supports_seq_batch(self) -> bool:
        """True when ``counts_batch_seqs`` serves: minimizer layout, slot
        scheme 3, cols resident, power-of-two tile_rows and fewer than
        2^28 tiles (the JAX engine's conditions)."""
        num_tiles = max(1, self.matrix.num_rows // self.tile_rows)
        return (
            self.layout == "minimizer"
            and self.slot_scheme == 3
            and self.cols is not None
            and self.tile_rows & (self.tile_rows - 1) == 0
            and num_tiles < (1 << 28)
        )

    @staticmethod
    def _seq_u_cap(nk: int, window: int) -> int:
        """The safe grouped-entry budget: expected entries nk / ((w + 1) /
        2) with 1.4x headroom, a multiple of 8, at most nk."""
        expect = nk / max(1.0, (window + 1) / 2.0)
        cap = int(expect * 1.4) + 8
        cap = ((cap + 7) // 8) * 8
        return min(nk, cap)

    @staticmethod
    def _seq_u_tight(nk: int, window: int) -> int:
        """The first-try budget, about 1.15x the expected entries: most
        batches fit, and one that does not costs one more launch."""
        expect = nk / max(1.0, (window + 1) / 2.0)
        return min(nk, ((int(expect * 1.15) + 4 + 7) // 8) * 8)

    def counts_batch_seqs(
        self, seqs: np.ndarray, lens: np.ndarray, k: int, h: int, num_cols: int,
        threshold: float | None = None,
    ):
        """Padded ASCII query bytes straight to per-query hit counts, on
        the card: seqs uint8[B, L] (rows padded with any byte), lens
        int32[B] -> (counts int64[B, num_cols], n_valid int32[B] distinct
        k-mers per query), or with ``threshold`` the batch's :class:`Hits`
        (:meth:`_hits`, inside ``engine.seq_out``); None when the geometry
        guard refuses the batch or a query overflows the safe entry
        budget (the caller falls back to the host paths).  ACGT-only
        bytes are the caller's contract.  The tight budget is tried
        first; an overflow escalates to the safe one in the same call and
        keeps it for the batch's length bucket for SEQ_CAP_DECAY clean
        batches.  Counters:
        ``engine.seq_calls`` (b > 0), ``engine.seq_launches`` (H and E,
        once a budget tried) and ``engine.seq_refused`` (None returned)."""
        b, _ = seqs.shape
        if b == 0:
            counts, nks = np.zeros((0, num_cols), dtype=np.int64), np.zeros(0, dtype=np.int32)
            return (counts, nks) if threshold is None else dense_hits(counts, nks, threshold)
        metrics.incr("engine.seq_calls")
        s = window_to_s(k, self.minimizer_window) or default_minimizer_s(k)
        window = k - s + 1
        num_tiles = max(1, self.matrix.num_rows // self.tile_rows)
        with phase("engine.seq_geometry"):
            geom = seq_batch_geometry(seqs, lens, k, window)
        if geom is None:
            metrics.incr("engine.seq_refused")
            return None
        padded, lens_b, lb, u_big = geom
        u_small = self._seq_u_tight(lb - k + 1, window)
        esc = self._seq_cap_esc
        remaining = esc.get(lb, 0)
        caps = [u_big] if remaining > 0 or u_small >= u_big else [u_small, u_big]
        with phase("engine.seq_in"):
            pd = self._to_device(padded, np.uint8)
            ld = self._to_device(lens_b, np.int32)
        for cap in caps:
            metrics.incr("engine.seq_launches")
            with phase("engine.seq_kernels"):  # kernels H and E, then the ok read
                counts, n_valid, ok = _counts_batch_seqs(
                    self.cols, pd, ld, k=k, s=s, num_tiles=num_tiles, h=h,
                    tile_rows=self.tile_rows, r=self.run_len or plain.GROUP_R, u_cap=cap,
                    seed=MINIMIZER_SEED,
                )
                fits = bool(ok)  # the one sync before the counts
            if fits:
                if cap == u_big and remaining > 0:
                    esc[lb] = remaining - 1
                with phase("engine.seq_out"):
                    if threshold is not None:
                        return self._hits(counts[:b, :num_cols], n_valid[:b], threshold)
                    return counts_to_host(counts[:b, :num_cols]), n_valid[:b].cpu().numpy()
            if cap != u_big:
                esc[lb] = self.SEQ_CAP_DECAY
        metrics.incr("engine.seq_refused")
        return None


class _PackedQuery:
    """One query's row ids; the engine reduces them on demand."""

    def __init__(self, row_idx: np.ndarray):
        self.row_idx = row_idx


class DeviceVerifier:
    """The classic matrix (``rows.bin``) resident on the card for the
    VERIFY stage of a verified index: the port of
    ``bigsi_tpu/index/device_engine.py:DeviceVerifier``, with the result
    contract of :func:`bigsi_tpu_torch.index.verify.verify_queries`.

    The matrix goes to the device once, row-major, as kernel A reads it
    (:func:`load_words`).  :meth:`counts_async` runs kernel A over the
    live queries on the verifier's own CUDA stream, gathers each query's
    candidate colours out of A's ``[Q, W * 32]`` counts on the card and
    copies back only those ``Σ|cand|`` counts; it returns without
    waiting for the device.  On ``device="cpu"`` the same steps run A's
    plain version."""

    def __init__(self, matrix: BitSliceMatrix, device=None):
        self.matrix = matrix
        self.device = resolve_device(device)
        if matrix.num_rows >= 1 << 31:
            raise ValueError("row ids are int32: at most 2**31 - 1 rows")
        self.words = load_words(np.asarray(matrix.words), self.device)
        self.cuda = self.device.type == "cuda"
        self.stream = None
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            # the words were copied on the current stream; freeing them
            # must wait for the verifier's stream too
            self.words.record_stream(self.stream)

    def _stage(self, row_idx_list, cand_list):
        """The live queries packed into row ids int32[Q, K_max, h]
        (padding rows at id 0) and a mask bool[Q, K_max], and the flat
        int64 index ``j * W * 32 + colour`` of every candidate into A's
        counts, each in a pinned host buffer on CUDA; -> (live, the
        candidates a live query, idx, mask, flat), or None when no query
        is live."""
        live = live_queries(row_idx_list, cand_list)
        if not live:
            return None
        q = len(live)
        rows = np.concatenate([row_idx_list[i] for i in live])  # [sum K, h]
        cands = np.concatenate([np.asarray(cand_list[i], dtype=np.int64) for i in live])
        lens = np.array([row_idx_list[i].shape[0] for i in live], dtype=np.int64)
        sizes = np.array([len(cand_list[i]) for i in live], dtype=np.int64)
        cols = self.matrix.num_words * 32
        if rows.min() < 0 or rows.max() >= self.matrix.num_rows:
            raise IndexError("row ids must lie in [0, %d)" % self.matrix.num_rows)
        if cands.min() < 0 or cands.max() >= cols:
            raise IndexError("candidate colours must lie in [0, %d)" % cols)
        idx = torch.empty((q, int(lens.max()), rows.shape[1]), dtype=torch.int32,
                          pin_memory=self.cuda)
        mask = torch.empty(idx.shape[:2], dtype=torch.bool, pin_memory=self.cuda)
        flat = torch.empty(cands.size, dtype=torch.int64, pin_memory=self.cuda)
        # filled through numpy, a copy a query: torch's threaded fill and
        # one fancy-indexed scatter of all the rows made this host-side
        # staging slower than the device work it feeds (PERF.md §6)
        idx_h, mask_h = idx.numpy(), mask.numpy()
        idx_h.fill(0)
        mask_h.fill(False)
        for j, i in enumerate(live):
            idx_h[j, : lens[j]] = row_idx_list[i]
            mask_h[j, : lens[j]] = True
        flat.numpy()[:] = np.repeat(np.arange(q) * cols, sizes) + cands
        return live, sizes, idx, mask, flat

    def counts_async(self, row_idx_list, cand_list) -> "_PendingCounts":
        """Dispatch the verify of the live queries; -> a resolver: call it
        for the per-query int64 counts aligned with ``cand_list`` (the
        contract of ``verify_queries``).  On CUDA the staged buffers, kernel
        A, the candidates' gather and their copy into a pinned host buffer
        are enqueued on the verifier's stream, after the caller's; nothing
        here waits on the device."""
        b = len(cand_list)
        staged = self._stage(row_idx_list, cand_list)
        if staged is None:
            return _PendingCounts(b, [], np.zeros(0, np.int64), (), torch.zeros(0), None)
        live, sizes, idx, mask, flat = staged
        if not self.cuda:
            counts, _ = classic_counts(self.words, idx, mask)
            got = counts.reshape(-1).index_select(0, flat)
            return _PendingCounts(b, live, sizes, (), got, None)
        dev = self.device
        caller = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(self.stream):
            self.stream.wait_stream(caller)  # what the caller enqueued before comes first
            idx_d = idx.to(dev, non_blocking=True)
            mask_d = mask.to(dev, non_blocking=True)
            flat_d = flat.to(dev, non_blocking=True)
            counts, _ = classic_counts(self.words, idx_d, mask_d)
            got = counts.reshape(-1).index_select(0, flat_d)
            host = torch.empty(got.shape, dtype=torch.int32, pin_memory=True)
            host.copy_(got, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return _PendingCounts(b, live, sizes, (idx, mask, flat), host, done)

    def counts(self, row_idx_list, cand_list) -> list:
        """Synchronous form of :meth:`counts_async`."""
        return self.counts_async(row_idx_list, cand_list)()


class _PendingCounts:
    """A dispatched verify: ``done()`` says whether the device finished,
    calling it waits for the event and splits the candidates' counts per
    query.  It holds the staged and the result buffers until then."""

    def __init__(self, b, live, sizes, staged, host: torch.Tensor, event):
        self.b, self.live, self.sizes = b, live, sizes
        self.staged, self.host, self.event = staged, host, event

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def __call__(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        vals = self.host.numpy().astype(np.int64)
        out = [np.zeros(0, dtype=np.int64)] * self.b
        for i, part in zip(self.live, np.split(vals, np.cumsum(self.sizes)[:-1])):
            out[i] = part
        return out
