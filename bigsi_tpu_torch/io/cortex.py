"""Cortex graph (.ctx v6) reader, numpy-vectorized.

Format (as parsed by the reference at ``bigsi/utils/cortex.py:170-264``):
magic ``CORTEX``, uint32 version (6), kmer size, kmer storage words,
colour count; per-colour metadata blocks; records of
``8*words`` bytes of 2-bit-packed k-mer + per-colour uint32 coverage +
uint8 edges.

K-mer bit packing quirk (``cortex.py:34-50``): within the little-endian
uint64, base at position ``p`` (0 = leftmost) occupies bits
``2j`` / ``2j+1`` with ``j = kmer_size-1-p`` and code
``2*bit[2j] + bit[2j+1]`` mapping ``0,1,2,3 -> A,G,C,T`` — i.e. the
nibble order differs from the usual ACGT=0123.  This module decodes
whole files in one vectorized pass instead of per-record structs.
"""

from __future__ import annotations

import os
import struct
import subprocess

import numpy as np

from bigsi_tpu_torch.kmers import canonicalize_kmer_matrix, seq_to_kmers

_MAGIC = b"CORTEX"
# code -> base for the cortex bit layout described above
_CORTEX_BASES = np.frombuffer(b"AGCT", dtype=np.uint8)


class GraphReader:
    """Streams records of a .ctx file; also exposes bulk decoding."""

    def __init__(self, graph_file: str):
        self._file_name = graph_file
        self._file = open(graph_file, "rb")
        self._read_header()

    def _read_u32(self) -> int:
        return struct.unpack("<I", self._file.read(4))[0]

    def _read_header(self) -> None:
        if self._file.read(len(_MAGIC)) != _MAGIC:
            raise ValueError("File format mismatch")
        self.version = self._read_u32()
        if self.version != 6:
            raise ValueError("File format version error; only 6 supported")
        self.kmer_size = self._read_u32()
        self.kmer_storage_size = 8 * self._read_u32()
        self.num_colours = self._read_u32()
        self.record_size = self.kmer_storage_size + 5 * self.num_colours
        # per-colour mean read length + total sequence
        self._file.seek(self.num_colours * 12, os.SEEK_CUR)
        for _ in range(self.num_colours):  # sample names (length-prefixed)
            n = self._read_u32()
            self._file.seek(n, os.SEEK_CUR)
        self._file.seek(self.num_colours * 16, os.SEEK_CUR)  # long-double error rates
        for _ in range(self.num_colours):  # cleaning info
            self._file.seek(12, os.SEEK_CUR)
            n = self._read_u32()
            self._file.seek(n, os.SEEK_CUR)
        if self._file.read(len(_MAGIC)) != _MAGIC:
            raise ValueError("File format mismatch")
        self._payload_start = self._file.tell()
        self._file.seek(0, os.SEEK_END)
        payload = self._file.tell() - self._payload_start
        self.num_records = payload // self.record_size
        self._file.seek(self._payload_start, os.SEEK_SET)

    # -- bulk (vectorized) path ---------------------------------------

    def read_all(self):
        """Decode every record at once.

        Returns ``(kmers, coverages, edges)``: ASCII matrix
        [R, kmer_size] uint8, uint32 [R, colours], uint8 [R, colours].
        """
        self._file.seek(self._payload_start, os.SEEK_SET)
        raw = np.frombuffer(
            self._file.read(self.num_records * self.record_size), dtype=np.uint8
        ).reshape(self.num_records, self.record_size)
        packed = (
            raw[:, : self.kmer_storage_size]
            .copy()
            .view("<u8")
            .reshape(self.num_records, -1)
        )
        kmers = decode_kmers(packed[:, 0], self.kmer_size)
        c0 = self.kmer_storage_size
        coverages = (
            raw[:, c0 : c0 + 4 * self.num_colours]
            .copy()
            .view("<u4")
            .reshape(self.num_records, self.num_colours)
        )
        edges = raw[:, c0 + 4 * self.num_colours :]
        return kmers, coverages, edges

    # -- record-at-a-time parity API ----------------------------------

    def __iter__(self):
        self._file.seek(self._payload_start, os.SEEK_SET)
        return self

    def __next__(self):
        buf = self._file.read(self.record_size)
        if len(buf) < self.record_size:
            raise StopIteration()
        return CortexRecord(self, buf)

    def close(self) -> None:
        self._file.close()


class CortexRecord:
    """One graph record: kmer + per-colour coverage and edge bytes."""

    def __init__(self, reader: GraphReader, buf: bytes):
        packed = np.frombuffer(buf[:8], dtype="<u8")
        self.kmer = bytes(decode_kmers(packed, reader.kmer_size)[0]).decode("ascii")
        off = reader.kmer_storage_size
        self.coverages = struct.unpack_from("<" + "I" * reader.num_colours, buf, off)
        off += 4 * reader.num_colours
        self.edges = [decode_edges(e) for e in buf[off : off + reader.num_colours]]
        self.num_colours = reader.num_colours


def decode_kmers(packed: np.ndarray, kmer_size: int) -> np.ndarray:
    """Cortex-packed uint64 [R] -> ASCII matrix [R, kmer_size]."""
    j = (kmer_size - 1 - np.arange(kmer_size, dtype=np.uint64)).astype(np.uint64)
    lo = (packed[:, None] >> (np.uint64(2) * j)[None, :]) & np.uint64(1)
    hi = (packed[:, None] >> (np.uint64(2) * j + np.uint64(1))[None, :]) & np.uint64(1)
    codes = (lo * np.uint64(2) + hi).astype(np.intp)
    return _CORTEX_BASES[codes]


def encode_kmer(kmer: str) -> bytes:
    """String k-mer -> cortex 8-byte packed form (inverse of decode)."""
    codes = {"A": 0, "C": 1, "G": 2, "T": 3}
    ret = 0
    for j, nuc in enumerate(reversed(kmer)):
        ret |= codes[nuc] << (2 * j)
    return struct.pack("<Q", ret)


def decode_edges(edges: int):
    """Edge byte -> (forward, reverse) adjacent-base lists
    (``cortex.py:53-69`` semantics)."""
    bases = ["A", "C", "G", "T"]
    fwd = [bases[j] for j in range(4) if (1 << j) & edges]
    rev = [bases[3 - j] for j in range(4) if (1 << (j + 4)) & edges]
    return fwd, rev


def extract_kmer_matrix_from_ctx(ctx: str, k: int) -> np.ndarray:
    """All k-mers of every record's *canonical* value, vectorized.

    Matches ``extract_kmers_from_ctx`` (``cortex.py:23-27``): each
    record's k-mer is canonicalized, then sliding k-windows of that
    canonical string are emitted.  Returns an ASCII matrix [K_total, k]
    (duplicates retained, order = record-major).
    """
    reader = GraphReader(ctx)
    try:
        kmers, _, _ = reader.read_all()
    finally:
        reader.close()
    canon = canonicalize_kmer_matrix(kmers)
    size = reader.kmer_size
    if k > size:
        raise ValueError("requested k=%d exceeds graph kmer size %d" % (k, size))
    if k == size:
        return canon
    views = [canon[:, i : i + k] for i in range(size - k + 1)]
    return np.concatenate(
        [v[:, None, :] for v in views], axis=1
    ).reshape(-1, k)


def extract_kmers_from_ctx(ctx: str, k: int):
    """Generator parity API: yields k-mer strings."""
    mat = extract_kmer_matrix_from_ctx(ctx, k)
    for row in mat:
        yield bytes(row).decode("ascii")


def run_cortex(command, args, path="./ctx31"):
    """Invoke an external mccortex binary (optional tooling,
    ``cortex.py:445-452``)."""
    cmd = [path, command, "-q", "-f", "-m", "100M", "-t", "10"] + list(args)
    subprocess.check_call(cmd)


def build_graph(kmer_size, fasta_file, cortex_file, links_file=None, path="./ctx31"):
    """Build a .ctx from FASTA via mccortex (optional tooling)."""
    run_cortex(
        "build",
        ["-s", "sample", "-k", str(kmer_size), "-1", fasta_file, cortex_file],
        path=path,
    )
    if links_file is not None:
        run_cortex("thread", ["-1", fasta_file, "-o", links_file, cortex_file], path=path)
