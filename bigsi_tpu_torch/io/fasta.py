"""Minimal FASTA reader (replaces the reference's pyfasta dependency,
used for queries at ``bigsi/__main__.py:19,263``)."""

from __future__ import annotations

import gzip


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fasta(path: str) -> dict:
    """FASTA file -> ordered {record_id: sequence} dict."""
    records = {}
    name = None
    chunks = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    records[name] = "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            records[name] = "".join(chunks)
    return records
