"""K-mer signature index: hashing + bit-matrix lookups.

Parity with ``bigsi/graph/index.py``: parameters stored under
``ksi:bloomfilter_size`` / ``ksi:num_hashes``; lookups canonicalize the
query k-mer but report the query form; create = transpose blooms into
the bitslice matrix; merge = column concatenation.

The data plane differs by design: instead of h x |kmers| KV row fetches
(``index.py:72-73``), lookups are one vectorized hash of the whole
k-mer batch followed by a fused gather/AND on the selected engine
(numpy host oracle, or the CUDA engine in
:mod:`bigsi_tpu_torch.index.device_engine`).
"""

from __future__ import annotations

import logging

import numpy as np

from bigsi_tpu_torch.hashing.scheme import (
    CLASSIC,
    KNOWN_TILE_ROWS,
    LAYOUTS,
    SLOT_SCHEME_V1,
    SLOT_SCHEMES,
    TILE_ROWS as DEFAULT_TILE_ROWS,
    row_indices,
)
from bigsi_tpu_torch.index.host_engine import HostEngine
from bigsi_tpu_torch.kmers import (
    ascii_to_strings,
    canonicalize_kmer_matrix,
    seq_to_ascii,
    unique_rows_with_inverse,
)
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix, transpose_blooms
from bigsi_tpu_torch.matrix.packing import pack_bits_lsb, unpack_bits_lsb

logger = logging.getLogger(__name__)


def _make_engine(
    factory, matrix, layout, tile_rows, minimizer_window=None,
    slot_scheme=SLOT_SCHEME_V1, run_len=None,
):
    """Engines that understand hash layouts get told which one is live;
    plain row-gather engines (any layout is just absolute rows to them)
    are constructed bare."""
    import inspect

    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):
        params = {}
    kwargs = {}
    if "layout" in params:
        kwargs["layout"] = layout
    if "tile_rows" in params:
        kwargs["tile_rows"] = tile_rows
    if "minimizer_window" in params:
        kwargs["minimizer_window"] = minimizer_window
    if "slot_scheme" in params:
        kwargs["slot_scheme"] = slot_scheme
    if "run_len" in params:
        kwargs["run_len"] = run_len
    return factory(matrix, **kwargs)


BLOOMFILTER_SIZE_KEY = "ksi:bloomfilter_size"
NUM_HASH_FUNCTS_KEY = "ksi:num_hashes"
LAYOUT_KEY = "ksi:layout"
TILE_ROWS_KEY = "ksi:tile_rows"
MINIMIZER_WINDOW_KEY = "ksi:minimizer_window"
SLOT_SCHEME_KEY = "ksi:slot_scheme"
RUN_LEN_KEY = "ksi:run_len"
# verified indexes (two-stage search): the minimizer screen's params —
# the MAIN layout stays classic (rows.bin carries reference semantics)
SCREEN_M_KEY = "ksi:screen_m"
SCREEN_TILE_ROWS_KEY = "ksi:screen_tile_rows"
SCREEN_WINDOW_KEY = "ksi:screen_window"
SCREEN_SCHEME_KEY = "ksi:screen_scheme"
SCREEN_RUN_LEN_KEY = "ksi:screen_run_len"


def persist_index_params(
    kv,
    bloomfilter_size: int,
    num_hashes: int,
    layout: str = CLASSIC,
    tile_rows: int = DEFAULT_TILE_ROWS,
    minimizer_window: int | None = None,
    slot_scheme: int | None = None,
    run_len: int | None = None,
    screen: dict | None = None,
) -> None:
    """Validate and write EVERY ``ksi:*`` parameter key for an index.

    The single persistence point shared by :meth:`KmerSignatureIndex.create`
    and the streamed builders (``cmds/build.py:build_sharded``) — a build
    path that wrote only a subset of these keys would reopen with the
    legacy defaults (e.g. slot_scheme v1 against v3-hashed blooms) and
    silently return wrong results.
    """
    if screen is not None and layout != CLASSIC:
        raise ValueError(
            "a screened (verified) index keeps layout=classic; "
            "got layout=%r" % layout
        )
    if layout not in LAYOUTS:
        raise ValueError("unknown layout %r" % layout)
    if tile_rows not in KNOWN_TILE_ROWS:
        raise ValueError(
            "tile_rows must be one of %s, got %r"
            % (list(KNOWN_TILE_ROWS), tile_rows)
        )
    if slot_scheme is None:
        from bigsi_tpu_torch.hashing.scheme import default_slot_scheme

        slot_scheme = default_slot_scheme(layout)
    if slot_scheme not in SLOT_SCHEMES:
        raise ValueError("unknown slot scheme %r" % slot_scheme)
    kv.set_integer(BLOOMFILTER_SIZE_KEY, bloomfilter_size)
    kv.set_integer(NUM_HASH_FUNCTS_KEY, num_hashes)
    kv.set_string(LAYOUT_KEY, layout)
    kv.set_integer(TILE_ROWS_KEY, tile_rows)
    kv.set_integer(SLOT_SCHEME_KEY, int(slot_scheme))
    if minimizer_window is not None:
        kv.set_integer(MINIMIZER_WINDOW_KEY, int(minimizer_window))
    if layout == "minimizer":
        from bigsi_tpu_torch.hashing.scheme import default_run_len

        if run_len is None:
            run_len = default_run_len(minimizer_window)
        if run_len < 1:
            raise ValueError("run_len must be >= 1, got %r" % run_len)
        kv.set_integer(RUN_LEN_KEY, int(run_len))
    if screen is not None:
        kv.set_integer(SCREEN_M_KEY, int(screen["m"]))
        kv.set_integer(SCREEN_TILE_ROWS_KEY, int(screen["tile_rows"]))
        kv.set_integer(SCREEN_WINDOW_KEY, int(screen["window"]))
        kv.set_integer(SCREEN_SCHEME_KEY, int(screen["slot_scheme"]))
        kv.set_integer(SCREEN_RUN_LEN_KEY, int(screen["run_len"]))


class _BitSlice:
    """Read-only bit window [start, start+n) over a bloom bit sequence
    (dense bool array or LazyBloomFile) — lets verified builds feed the
    classic and screen halves of a concatenated bloom to the chunked
    transpose without materializing either half."""

    def __init__(self, bits, start: int, n: int):
        self.bits, self.start, self.n = bits, int(start), int(n)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, key):
        if isinstance(key, slice):
            a, b, step = key.indices(self.n)
            if step != 1:
                raise ValueError("_BitSlice supports step-1 slices only")
            return self.bits[self.start + a : self.start + b]
        return self.bits[self.start + key.__index__()]


class KmerSignatureIndex:
    def __init__(self, storage, engine_factory=None):
        self.storage = storage
        self.bloomfilter_size = storage.kv.get_integer(BLOOMFILTER_SIZE_KEY)
        self.num_hashes = storage.kv.get_integer(NUM_HASH_FUNCTS_KEY)
        try:
            self.layout = storage.kv.get_string(LAYOUT_KEY)
        except KeyError:
            self.layout = CLASSIC
        try:
            self.tile_rows = storage.kv.get_integer(TILE_ROWS_KEY)
        except KeyError:
            self.tile_rows = DEFAULT_TILE_ROWS
        try:
            self.minimizer_window = storage.kv.get_integer(
                MINIMIZER_WINDOW_KEY
            )
        except KeyError:
            self.minimizer_window = None  # default: w=11, runs ~6
        try:
            self.slot_scheme = storage.kv.get_integer(SLOT_SCHEME_KEY)
        except KeyError:
            self.slot_scheme = SLOT_SCHEME_V1  # legacy persisted indexes
        try:
            self.run_len = storage.kv.get_integer(RUN_LEN_KEY)
        except KeyError:
            # legacy indexes: query with the tuned per-window default
            # (r is query-time bucketing, not an index property)
            from bigsi_tpu_torch.hashing.scheme import default_run_len

            self.run_len = default_run_len(self.minimizer_window)
        self.bitmatrix = storage.load_matrix()
        self.side = storage.load_side()  # staged inserts, may be None
        self._engine_factory = engine_factory or HostEngine
        self.screen = None  # dict of screen params when verified
        self.screen_matrix = None
        try:
            screen_m = storage.kv.get_integer(SCREEN_M_KEY)
        except KeyError:
            screen_m = None
        if screen_m is not None:
            self.screen = {
                "m": screen_m,
                "tile_rows": storage.kv.get_integer(SCREEN_TILE_ROWS_KEY),
                "window": storage.kv.get_integer(SCREEN_WINDOW_KEY),
                "slot_scheme": storage.kv.get_integer(SCREEN_SCHEME_KEY),
                "run_len": storage.kv.get_integer(SCREEN_RUN_LEN_KEY),
            }
            self.screen_matrix = storage.load_screen()
        self._rebuild_engines()

    def _rebuild_engines(self) -> None:
        """Engines over the current matrices; called wherever a matrix
        changes.  A device engine copies its matrix once, at
        construction, so it must be rebuilt to see a change.  The old
        engines are dropped first: two device copies of the index are
        never alive at once."""
        self.engine = self.screen_engine = None
        if self.screen is None:
            self.engine = _make_engine(
                self._engine_factory, self.bitmatrix, self.layout,
                self.tile_rows, self.minimizer_window, self.slot_scheme,
                self.run_len,
            )
            return
        # the configured engine accelerates the SCREEN; the classic
        # matrix is verified host-side from rows.bin (never staged to
        # HBM — candidate-word verification reads a sliver of it)
        self.screen_engine = _make_engine(
            self._engine_factory, self.screen_matrix, "minimizer",
            self.screen["tile_rows"], self.screen["window"],
            self.screen["slot_scheme"], self.screen["run_len"],
        )
        self.engine = HostEngine(self.bitmatrix)

    @classmethod
    def create(
        cls,
        storage,
        bloomfilters,
        bloomfilter_size,
        num_hashes,
        lowmem=False,
        layout=CLASSIC,
        tile_rows=DEFAULT_TILE_ROWS,
        minimizer_window=None,
        slot_scheme=None,
        run_len=None,
        screen=None,
    ) -> "KmerSignatureIndex":
        bloomfilters = [
            bf.bitarray if hasattr(bf, "bitarray") else np.asarray(bf)
            for bf in bloomfilters
        ]
        if screen is not None:
            # verified build: each bloom is the CLASSIC bloom (m bits)
            # followed by the screen bloom (screen m bits); the main
            # layout is forced classic (rows.bin = reference semantics)
            total = bloomfilter_size + screen["m"]
            for bf in bloomfilters:
                if len(bf) != total:
                    raise ValueError(
                        "verified blooms carry m + screen-m = %d bits, "
                        "got %d (build blooms with the same 'screen' "
                        "config)" % (total, len(bf))
                    )
        persist_index_params(
            storage.kv, bloomfilter_size, num_hashes, layout=layout,
            tile_rows=tile_rows, minimizer_window=minimizer_window,
            slot_scheme=slot_scheme, run_len=run_len, screen=screen,
        )
        if screen is not None:
            screen_parts = [
                _BitSlice(bf, bloomfilter_size, screen["m"])
                for bf in bloomfilters
            ]
            bloomfilters = [
                _BitSlice(bf, 0, bloomfilter_size) for bf in bloomfilters
            ]
        from bigsi_tpu_torch.utils.profiling import phase

        if lowmem and hasattr(storage, "rows_path"):
            # streamed build (config low_mem_build): transpose chunks
            # append straight to rows.bin — peak RAM is one chunk block,
            # never the [m, W] matrix (the reference's chunked build is
            # broken, bigsi/cmds/build.py:50,79-85; its dense transpose
            # is the scaling wall, bigsi/matrix/transpose.py:33-43)
            from bigsi_tpu_torch.matrix.bitmatrix import transpose_blooms_to_file

            with phase("build.transpose_streamed"):
                w = transpose_blooms_to_file(
                    bloomfilters, bloomfilter_size, storage.rows_path()
                )
            storage.adopt_rows(
                num_rows=bloomfilter_size,
                num_words=w,
                num_cols=len(bloomfilters),
            )
            if screen is not None:
                with phase("build.transpose_screen_streamed"):
                    sw = transpose_blooms_to_file(
                        screen_parts, screen["m"], storage.screen_path()
                    )
                storage.adopt_screen(num_rows=screen["m"], num_words=sw)
            storage.sync()
            return cls(storage)

        with phase("build.transpose"):
            words = transpose_blooms(bloomfilters, bloomfilter_size)
        matrix = BitSliceMatrix(words, num_cols=len(bloomfilters))
        with phase("build.persist"):
            storage.save_matrix(matrix)
            if screen is not None:
                swords = transpose_blooms(screen_parts, screen["m"])
                storage.save_screen(
                    BitSliceMatrix(swords, num_cols=len(screen_parts))
                )
            storage.sync()
        return cls(storage)

    # -- hashing ------------------------------------------------------

    def kmer_matrix_to_row_idx(self, kmer_matrix: np.ndarray) -> np.ndarray:
        """Distinct ASCII k-mers [K, k] -> bloom row indices int64 [K, h].

        Hashes the *canonical* form, reports the query form — semantics
        of ``index.py:62-70``.
        """
        canon = canonicalize_kmer_matrix(kmer_matrix)
        return row_indices(
            canon, self.num_hashes, self.bloomfilter_size, self.layout,
            self.tile_rows, tile_source=kmer_matrix,
            window=self.minimizer_window, slot_scheme=self.slot_scheme,
        )

    def screen_row_idx(self, kmer_matrix: np.ndarray) -> np.ndarray:
        """Screen-stage rows (verified indexes): minimizer-layout
        indices into screen.bin, int64 [K, h]."""
        sc = self.screen
        canon = canonicalize_kmer_matrix(kmer_matrix)
        return row_indices(
            canon, self.num_hashes, sc["m"], "minimizer",
            sc["tile_rows"], tile_source=kmer_matrix,
            window=sc["window"], slot_scheme=sc["slot_scheme"],
        )

    # -- lookups ------------------------------------------------------

    def lookup_packed(self, kmer_matrix: np.ndarray) -> np.ndarray:
        """Distinct k-mer matrix [K, k] -> packed presence uint32 [K, W]."""
        row_idx = self.kmer_matrix_to_row_idx(kmer_matrix)
        return self.engine.and_rows(row_idx)

    def lookup(self, kmers, remove_trailing_zeros: bool = True) -> dict:
        """Public API parity: {query_kmer: presence bool array}.

        With ``remove_trailing_zeros`` the arrays have length
        ``num_cols``; otherwise the reference's byte-padded width
        (here: word-padded — padding bits are always zero).
        """
        if isinstance(kmers, str):
            kmers = [kmers]
        kmers = list(dict.fromkeys(kmers))  # dedupe, stable order
        if not kmers:
            return {}
        mat = np.stack([seq_to_ascii(k) for k in kmers])
        row_idx = self.kmer_matrix_to_row_idx(mat)
        packed = self.engine.and_rows(row_idx)
        n_main = self.bitmatrix.num_cols
        if isinstance(packed, np.ndarray):
            bits = unpack_bits_lsb(packed, None).astype(bool)  # word-padded
        else:  # device engines return an opaque presence handle
            bits = self.engine.presence_matrix(packed, n_main).astype(bool)
        total = n_main
        if self.side is not None:
            side = self.side.presence(row_idx)
            total = n_main + side.shape[1]
        if bits.shape[1] < total:
            bits = np.pad(bits, ((0, 0), (0, total - bits.shape[1])))
        if self.side is not None:
            bits[:, n_main:total] = side
        if remove_trailing_zeros:
            bits = bits[:, :total]
        return dict(zip(kmers, bits))

    # -- mutation -----------------------------------------------------

    def insert_bloom(self, bloomfilter, column_index: int) -> None:
        """Insert = STAGED append (SURVEY §7.4): the bloom lands in the
        side shard in O(m/8) — rows.bin is never rewritten (round 2
        copied the whole mmap into RAM here; the reference pokes every
        row, ``bigsi/matrix/bitmatrix.py:67-75``).  Queries AND the side
        columns on the host; :meth:`compact` folds them in."""
        bits = bloomfilter.bitarray if hasattr(bloomfilter, "bitarray") else bloomfilter
        bits = np.asarray(bits, dtype=bool)
        screen_bits = None
        if self.screen is not None:
            total = self.bloomfilter_size + self.screen["m"]
            if bits.shape[0] != total:
                raise ValueError(
                    "verified insert needs a concatenated bloom of "
                    "m + screen-m = %d bits, got %d" % (total, bits.shape[0])
                )
            screen_bits = bits[self.bloomfilter_size :]
            bits = bits[: self.bloomfilter_size]
        side_cols = self.side.num_cols if self.side is not None else 0
        if column_index == self.bitmatrix.num_cols + side_cols:
            self.storage.append_side_column(bits)
            if screen_bits is not None:
                # retained so compaction folds the new colour into the
                # screen too — otherwise its screen count reads 0 after
                # compact and the verify stage never sees it
                self.storage.append_screen_side_column(screen_bits)
            self.side = self.storage.load_side()
            return
        if self.screen is not None:
            raise ValueError(
                "verified indexes support append inserts only "
                "(column_index must equal the current colour count)"
            )
        # non-append insert (overwrite of an interior colour): legacy
        # dense path — not a supported operation at scale
        self.bitmatrix.ensure_writable()
        self.bitmatrix.insert_column(np.asarray(bits, dtype=bool), column_index)
        self.storage.save_matrix(self.bitmatrix)
        self._rebuild_engines()

    def compact(self) -> None:
        """Fold staged side columns into the main matrix + engine."""
        if self._fold_side():
            self._rebuild_engines()

    def _fold_side(self) -> bool:
        """Fold staged side columns into the main matrices, leaving the
        engines to the caller; -> whether there were any."""
        if self.side is None:
            return False
        self.storage.compact_side()
        self.side = None
        self.bitmatrix = self.storage.load_matrix()
        if self.screen is not None:
            self.screen_matrix = self.storage.load_screen()
        return True

    def side_presence(self, row_idx: np.ndarray) -> np.ndarray | None:
        """Per-kmer presence over STAGED columns: [K, h] -> bool [K, C]
        or None when no side shard exists."""
        if self.side is None:
            return None
        return self.side.presence(row_idx)

    def merge_indexes(self, ksi: "KmerSignatureIndex") -> None:
        if (self.screen is None) != (ksi.screen is None):
            raise ValueError(
                "cannot merge a verified (screened) index with an "
                "unscreened one"
            )
        if self.screen is not None and self.screen != ksi.screen:
            raise ValueError(
                "screen parameters differ: %r vs %r"
                % (self.screen, ksi.screen)
            )
        self._fold_side()  # the engines are rebuilt once, after the merge
        ksi.compact()
        self.bitmatrix.merge(ksi.bitmatrix)
        self.storage.save_matrix(self.bitmatrix)
        if self.screen is not None:
            sm = self.screen_matrix
            sm.ensure_writable()
            sm.merge(ksi.screen_matrix)
            # merge() widened sm but num_cols tracks the main matrix
            self.storage.save_screen(sm)
            self.screen_matrix = self.storage.load_screen()
        self._rebuild_engines()
