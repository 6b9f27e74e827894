"""One storage story.

The reference ships three KV backends (RocksDB / BerkeleyDB / Redis,
``bigsi/storage/``) because its matrix lives row-at-a-time in a
database.  Here the matrix is a dense packed array, so persistence is a
directory::

    index_dir/
      manifest.json   # format version, k/m/h, dims, metadata KV
      rows.bin        # uint32[m, W] little-endian, row-major, mmap-able

``rows.bin`` is written with a small header-free flat layout so it can
be ``np.memmap``'d on hosts and fed to the device in column shards.  A
:class:`MemoryStore` provides the same API fully in-process for tests;
reference engine names in configs ("berkeleydb", "rocksdb", "redis")
are accepted and mapped onto these two (drop-in config compatibility).
"""

from __future__ import annotations

import json
import logging
import os
import shutil

import numpy as np

from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.storage.kv import TypedKV

logger = logging.getLogger(__name__)

MANIFEST = "manifest.json"
ROWS_BIN = "rows.bin"
SIDE_BIN = "side.bin"
SCREEN_BIN = "screen.bin"  # verified indexes: minimizer screen matrix
SCREEN_SIDE_BIN = "screen_side.bin"  # staged inserts' screen columns
FORMAT_VERSION = 1


class SideShard:
    """Staged-insert column shard (SURVEY §7.4).

    ``insert`` appends each new sample's Bloom as one packed COLUMN
    (``ceil(m/8)`` LSB-first bytes appended to ``side.bin``) instead of
    rewriting the row-major matrix — the reference's per-row bit pokes
    (``bigsi/matrix/bitmatrix.py:67-75``) and round 2's ensure_writable
    full-matrix copy are both O(index); this is O(m/8) per insert.
    Queries AND the side columns on the host (the shard stays small
    between compactions); ``compact`` folds it into rows.bin once.
    """

    def __init__(self, data: np.ndarray, num_rows: int):
        self.data = data  # uint8 [C, ceil(m/8)], LSB-first within bytes
        self.num_rows = num_rows

    @property
    def num_cols(self) -> int:
        return self.data.shape[0]

    def presence(self, row_idx: np.ndarray) -> np.ndarray:
        """Per-kmer presence over side columns: row_idx int [K, h] ->
        bool [K, C] (all h bloom rows set)."""
        rows = np.asarray(row_idx)
        byts = self.data[:, rows >> 3]  # [C, K, h]
        bits = (byts >> (rows & 7).astype(np.uint8)) & np.uint8(1)
        return bits.all(axis=2).T

    def rows_block(self, r0: int, r1: int) -> np.ndarray:
        """Bit rows [r0, r1) for every column -> bool [r1-r0, C].
        ``r0`` must be byte-aligned (multiple of 8)."""
        assert r0 % 8 == 0
        byts = self.data[:, r0 // 8 : (r1 + 7) // 8]
        bits = np.unpackbits(
            np.ascontiguousarray(byts), axis=1, bitorder="little"
        )
        return bits[:, : r1 - r0].T.astype(bool)


def _pack_side_column(bits) -> np.ndarray:
    arr = np.asarray(bits)
    if arr.dtype != bool:
        arr = arr.astype(bool)
    return np.packbits(arr, bitorder="little")

# In-process registry so MemoryStore state survives re-instantiation via
# BIGSI(config), mirroring how the reference re-opens a database.
_MEMORY_REGISTRY: dict = {}


class BaseIndexStore:
    """Common surface: a TypedKV plus matrix load/save."""

    kv: TypedKV

    def has_index(self) -> bool:
        raise NotImplementedError

    def load_matrix(self) -> BitSliceMatrix:
        raise NotImplementedError

    def save_matrix(self, matrix: BitSliceMatrix) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass

    def delete_all(self) -> None:
        raise NotImplementedError

    # -- staged inserts (side shard) -----------------------------------

    def append_side_column(self, bits) -> None:
        raise NotImplementedError

    def load_side(self) -> SideShard | None:
        return None

    def compact_side(self) -> None:
        """Fold the side shard into the main matrix (no-op if empty)."""

    # -- verified indexes: the minimizer screen matrix -----------------

    def save_screen(self, matrix: BitSliceMatrix) -> None:
        raise NotImplementedError

    def load_screen(self) -> BitSliceMatrix | None:
        return None

    def append_screen_side_column(self, bits) -> None:
        raise NotImplementedError


class MemoryStore(BaseIndexStore):
    def __init__(self, name: str = "default"):
        self.name = name
        state = _MEMORY_REGISTRY.setdefault(name, {"kv": TypedKV(), "matrix": None})
        self.kv = state["kv"]

    def has_index(self) -> bool:
        return _MEMORY_REGISTRY[self.name]["matrix"] is not None

    def load_matrix(self) -> BitSliceMatrix:
        m = _MEMORY_REGISTRY[self.name]["matrix"]
        if m is None:
            raise KeyError("no index built in memory store %r" % self.name)
        return m

    def save_matrix(self, matrix: BitSliceMatrix) -> None:
        _MEMORY_REGISTRY[self.name]["matrix"] = matrix

    def delete_all(self) -> None:
        self.kv.delete_all()
        _MEMORY_REGISTRY[self.name] = {"kv": TypedKV(), "matrix": None}
        self.kv = _MEMORY_REGISTRY[self.name]["kv"]

    def append_side_column(self, bits) -> None:
        state = _MEMORY_REGISTRY[self.name]
        state.setdefault("side", []).append(_pack_side_column(bits))

    def load_side(self) -> SideShard | None:
        cols = _MEMORY_REGISTRY[self.name].get("side")
        if not cols:
            return None
        m = _MEMORY_REGISTRY[self.name]["matrix"].num_rows
        return SideShard(np.stack(cols), m)

    def compact_side(self) -> None:
        state = _MEMORY_REGISTRY[self.name]
        cols = state.pop("side", [])
        if not cols:
            return
        matrix = state["matrix"]
        matrix.ensure_writable()
        for packed in cols:
            bits = np.unpackbits(packed, bitorder="little")[: matrix.num_rows]
            matrix.insert_column(bits.astype(bool), matrix.num_cols)
        state["matrix"] = matrix
        scols = state.pop("screen_side", [])
        screen = state.get("screen")
        if scols and screen is not None:
            screen.ensure_writable()
            for packed in scols:
                bits = np.unpackbits(packed, bitorder="little")[
                    : screen.num_rows
                ]
                screen.insert_column(bits.astype(bool), screen.num_cols)
            state["screen"] = screen

    def save_screen(self, matrix: BitSliceMatrix) -> None:
        _MEMORY_REGISTRY[self.name]["screen"] = matrix

    def load_screen(self) -> BitSliceMatrix | None:
        return _MEMORY_REGISTRY[self.name].get("screen")

    def append_screen_side_column(self, bits) -> None:
        state = _MEMORY_REGISTRY[self.name]
        state.setdefault("screen_side", []).append(_pack_side_column(bits))


class IndexStore(BaseIndexStore):
    def __init__(self, directory: str, mmap: bool = True):
        self.directory = directory
        self.mmap = mmap
        self._manifest = None
        self.kv = TypedKV()
        if os.path.exists(self._manifest_path()):
            with open(self._manifest_path()) as f:
                self._manifest = json.load(f)
            self.kv = TypedKV.from_dict(self._manifest.get("kv", {}))

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST)

    def _rows_path(self) -> str:
        return os.path.join(self.directory, ROWS_BIN)

    def rows_path(self) -> str:
        """Target path for bulk builders that stream rows.bin directly
        (register the result with :meth:`adopt_rows`)."""
        os.makedirs(self.directory, exist_ok=True)
        return self._rows_path()

    def has_index(self) -> bool:
        return self._manifest is not None and "num_rows" in self._manifest

    def load_matrix(self) -> BitSliceMatrix:
        if not self.has_index():
            raise KeyError("no index at %s" % self.directory)
        man = self._manifest
        shape = (man["num_rows"], man["num_words"])
        if self.mmap:
            words = np.memmap(self._rows_path(), dtype=np.uint32, mode="r", shape=shape)
        else:
            words = np.fromfile(self._rows_path(), dtype=np.uint32).reshape(shape)
        return BitSliceMatrix(np.asarray(words), man["num_cols"])

    def save_matrix(self, matrix: BitSliceMatrix) -> None:
        os.makedirs(self.directory, exist_ok=True)
        tmp = self._rows_path() + ".tmp"
        arr = np.ascontiguousarray(matrix.words, dtype=np.uint32)
        with open(tmp, "wb") as f:
            arr.tofile(f)
        os.replace(tmp, self._rows_path())
        if self._manifest is None:
            self._manifest = {"format_version": FORMAT_VERSION}
        self._manifest.update(
            {
                "num_rows": matrix.num_rows,
                "num_words": matrix.num_words,
                "num_cols": matrix.num_cols,
                "dtype": "uint32",
                "layout": "lsb32-le",
            }
        )
        self.sync()

    def adopt_rows(self, num_rows: int, num_words: int, num_cols: int) -> None:
        """Register an externally written ``rows.bin`` (bulk-build path).

        Large builds stream packed rows straight into ``rows.bin``
        (uint32 little-endian row-major, the documented layout) instead
        of materializing the matrix in RAM for :meth:`save_matrix`.
        """
        expected = num_rows * num_words * 4
        actual = os.path.getsize(self._rows_path())
        if actual != expected:
            raise ValueError(
                "rows.bin is %d bytes, expected %d (%d x %d uint32)"
                % (actual, expected, num_rows, num_words)
            )
        if self._manifest is None:
            self._manifest = {"format_version": FORMAT_VERSION}
        self._manifest.update(
            {
                "num_rows": num_rows,
                "num_words": num_words,
                "num_cols": num_cols,
                "dtype": "uint32",
                "layout": "lsb32-le",
            }
        )
        self.sync()

    # -- staged inserts -------------------------------------------------

    def _side_path(self) -> str:
        return os.path.join(self.directory, SIDE_BIN)

    def append_side_column(self, bits) -> None:
        """O(m/8) insert: append one packed bloom column to side.bin —
        rows.bin is NOT touched (compact_side folds it in later)."""
        packed = _pack_side_column(bits)
        expected = (self._manifest["num_rows"] + 7) // 8
        if len(packed) != expected:
            raise ValueError(
                "side column is %d bytes, expected %d" % (len(packed), expected)
            )
        with open(self._side_path(), "ab") as f:
            f.write(packed.tobytes())
        self._manifest["side_cols"] = self.side_cols() + 1
        self.sync()

    def side_cols(self) -> int:
        return int((self._manifest or {}).get("side_cols", 0))

    def load_side(self) -> SideShard | None:
        c = self.side_cols()
        if not c:
            return None
        m = self._manifest["num_rows"]
        bpc = (m + 7) // 8
        data = np.memmap(
            self._side_path(), dtype=np.uint8, mode="r", shape=(c, bpc)
        )
        return SideShard(np.asarray(data), m)

    @staticmethod
    def _fold_side_into(
        path: str, side: SideShard, m: int, w: int, n: int,
        chunk_rows: int = 1 << 18,
    ) -> int:
        """Stream side columns into a widened matrix file, one row chunk
        at a time — peak RAM is one chunk block, never the matrix.
        Returns the new word count."""
        n_new = n + side.num_cols
        w_new = max(w, (n_new + 31) // 32)
        src = np.memmap(path, dtype=np.uint32, mode="r", shape=(m, w))
        chunk_rows = max(8, chunk_rows - chunk_rows % 8)  # byte-aligned
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            for r0 in range(0, m, chunk_rows):
                r1 = min(m, r0 + chunk_rows)
                block = np.zeros((r1 - r0, w_new), dtype=np.uint32)
                block[:, :w] = src[r0:r1]
                bits = side.rows_block(r0, r1)  # [rows, C]
                for c in range(side.num_cols):
                    col = n + c
                    block[:, col >> 5] |= bits[:, c].astype(
                        np.uint32
                    ) << np.uint32(col & 31)
                block.tofile(f)
        os.replace(tmp, path)
        return w_new

    def compact_side(self, chunk_rows: int = 1 << 18) -> None:
        side = self.load_side()
        if side is None:
            return
        man = self._manifest
        m, w, n = man["num_rows"], man["num_words"], man["num_cols"]
        w_new = self._fold_side_into(
            self._rows_path(), side, m, w, n, chunk_rows
        )
        os.remove(self._side_path())
        sside = self._load_screen_side()
        if sside is not None:
            sw_new = self._fold_side_into(
                self._screen_path(), sside, man["screen_rows"],
                man["screen_words"], n, chunk_rows,
            )
            os.remove(self._screen_side_path())
            man.update({"screen_words": sw_new, "screen_side_cols": 0})
        man.update({"num_words": w_new, "num_cols": n + side.num_cols,
                    "side_cols": 0})
        self.sync()

    # -- verified indexes: screen matrix --------------------------------

    def _screen_path(self) -> str:
        return os.path.join(self.directory, SCREEN_BIN)

    def _screen_side_path(self) -> str:
        return os.path.join(self.directory, SCREEN_SIDE_BIN)

    def save_screen(self, matrix: BitSliceMatrix) -> None:
        os.makedirs(self.directory, exist_ok=True)
        tmp = self._screen_path() + ".tmp"
        arr = np.ascontiguousarray(matrix.words, dtype=np.uint32)
        with open(tmp, "wb") as f:
            arr.tofile(f)
        os.replace(tmp, self._screen_path())
        if self._manifest is None:
            self._manifest = {"format_version": FORMAT_VERSION}
        self._manifest.update(
            {
                "screen_rows": matrix.num_rows,
                "screen_words": matrix.num_words,
            }
        )
        self.sync()

    def load_screen(self) -> BitSliceMatrix | None:
        man = self._manifest
        if man is None or "screen_rows" not in man:
            return None
        shape = (man["screen_rows"], man["screen_words"])
        if self.mmap:
            words = np.memmap(
                self._screen_path(), dtype=np.uint32, mode="r", shape=shape
            )
        else:
            words = np.fromfile(
                self._screen_path(), dtype=np.uint32
            ).reshape(shape)
        return BitSliceMatrix(np.asarray(words), man["num_cols"])

    def adopt_screen(self, num_rows: int, num_words: int) -> None:
        """Register an externally streamed ``screen.bin`` (bulk builds)."""
        expected = num_rows * num_words * 4
        actual = os.path.getsize(self._screen_path())
        if actual != expected:
            raise ValueError(
                "screen.bin is %d bytes, expected %d (%d x %d uint32)"
                % (actual, expected, num_rows, num_words)
            )
        if self._manifest is None:
            self._manifest = {"format_version": FORMAT_VERSION}
        self._manifest.update(
            {"screen_rows": num_rows, "screen_words": num_words}
        )
        self.sync()

    def screen_path(self) -> str:
        os.makedirs(self.directory, exist_ok=True)
        return self._screen_path()

    def append_screen_side_column(self, bits) -> None:
        packed = _pack_side_column(bits)
        expected = (self._manifest["screen_rows"] + 7) // 8
        if len(packed) != expected:
            raise ValueError(
                "screen side column is %d bytes, expected %d"
                % (len(packed), expected)
            )
        with open(self._screen_side_path(), "ab") as f:
            f.write(packed.tobytes())
        self._manifest["screen_side_cols"] = (
            int(self._manifest.get("screen_side_cols", 0)) + 1
        )
        self.sync()

    def _load_screen_side(self) -> SideShard | None:
        c = int((self._manifest or {}).get("screen_side_cols", 0))
        if not c:
            return None
        m = self._manifest["screen_rows"]
        bpc = (m + 7) // 8
        data = np.memmap(
            self._screen_side_path(), dtype=np.uint8, mode="r", shape=(c, bpc)
        )
        return SideShard(np.asarray(data), m)

    def sync(self) -> None:
        if self._manifest is None:
            self._manifest = {"format_version": FORMAT_VERSION}
        self._manifest["kv"] = self.kv.to_dict()
        os.makedirs(self.directory, exist_ok=True)
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp, self._manifest_path())
        self.kv.dirty = False

    def close(self) -> None:
        if self.kv.dirty:
            self.sync()

    def delete_all(self) -> None:
        if os.path.isdir(self.directory):
            shutil.rmtree(self.directory)
        self._manifest = None
        self.kv = TypedKV()


_WARNED_ENGINES = set()


def get_storage(config: dict) -> BaseIndexStore:
    """Storage factory — accepts reference configs verbatim.

    Reference factory: ``bigsi/storage/__init__.py:18-19``.  Engines map:
    ``bigsi-tpu``/``disk`` and the reference's ``berkeleydb``/``rocksdb``
    -> :class:`IndexStore` on ``storage-config.filename``;
    ``redis`` -> :class:`IndexStore` on a host-port-derived directory;
    ``memory`` -> :class:`MemoryStore`.
    """
    engine = config.get("storage-engine", "bigsi-tpu")
    sc = config.get("storage-config", {}) or {}
    if engine == "memory":
        return MemoryStore(sc.get("filename", "default"))
    if engine in ("bigsi-tpu", "disk", "berkeleydb", "rocksdb"):
        if engine in ("berkeleydb", "rocksdb") and engine not in _WARNED_ENGINES:
            _WARNED_ENGINES.add(engine)
            logger.warning(
                "storage-engine %r is emulated by the native index store", engine
            )
        filename = sc.get("filename", "bigsi-tpu-index")
        return IndexStore(filename)
    if engine == "redis":
        name = "bigsi-redis-%s-%s" % (sc.get("host", "localhost"), sc.get("port", 6379))
        if engine not in _WARNED_ENGINES:
            _WARNED_ENGINES.add(engine)
            logger.warning(
                "storage-engine 'redis' is emulated by a local index store at %s", name
            )
        return IndexStore(name)
    raise ValueError("unknown storage-engine %r" % engine)
