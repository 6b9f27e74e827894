"""Shared helpers (reference: ``bigsi/utils/fncts.py``)."""

import os

from bigsi_tpu_torch.kmers import (
    canonical,
    convert_query_kmer,
    convert_query_kmers,
    reverse_comp,
    seq_to_kmers,
)

DEFAULT_LOGGING_LEVEL = os.environ.get("LOGGING_LEVEL", "INFO")


def chunks(l, n):
    """Yield successive n-sized chunks from l."""
    n = max(1, n)
    for i in range(0, len(l), n):
        yield l[i : i + n]


def batch(iterable, size):
    buf = []
    for item in iterable:
        buf.append(item)
        if len(buf) == size:
            yield buf
            buf = []
    if buf:
        yield buf


__all__ = [
    "canonical",
    "convert_query_kmer",
    "convert_query_kmers",
    "reverse_comp",
    "seq_to_kmers",
    "chunks",
    "batch",
    "DEFAULT_LOGGING_LEVEL",
]
