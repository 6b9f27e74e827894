"""The plain reference of a BIGSI search: the same answers as the
program, worked out again from the index words and the queries that the
benchmark made, and from nothing the program made.

A query's distinct k-mers are its distinct k-long windows (as written,
not canonical).  A sample holds a k-mer when the sample's bit is set in
every one of the k-mer's h rows (the layout module gives the rows).  A
sample is an answer when it holds at least ``ceil(distinct * threshold)``
of them; answers come in sample order at threshold 1.0 and by k-mers
found, most first, otherwise.  A scored answer adds the score of its
presence string (one character a position of the query) and the string
itself.
"""

from __future__ import annotations

import importlib
import math

import numpy as np

from benchmark.reference import score as scorer


class Reference:
    """Answers over ``words`` (uint32[m, W], sample c at bit c % 32 of word
    c // 32) of ``len(names)`` samples, whose k-mers' rows the module
    ``reference/<rows>.py`` works out under the index parameters ``cfg``.
    ``hashes`` below ``cfg["h"]`` ANDs only that many of each k-mer's
    rows: the control, which breaks the exactness the configuration
    states."""

    def __init__(self, words: np.ndarray, names: list[str], cfg: dict, rows: str,
                 hashes: int | None = None):
        self.words, self.names, self.cfg = words, names, cfg
        self.layout = importlib.import_module("benchmark.reference." + rows)
        self.hashes = cfg["h"] if hashes is None else hashes

    def presence(self, seq: str):
        """-> (bool[distinct k-mers, N] presence, the distinct k-mer of each
        position int64[P])."""
        fwd, rows = self.layout.position_rows(seq, self.cfg)
        _, first, inverse = np.unique(fwd, return_index=True, return_inverse=True)
        held = np.bitwise_and.reduce(self.words[rows[first][:, : self.hashes]], axis=1)
        bits = np.unpackbits(held.view(np.uint8), axis=1, bitorder="little")
        return bits[:, : len(self.names)], inverse.reshape(-1)

    def answer(self, seq: str, threshold: float, score: bool = False) -> list[dict]:
        bits, inverse = self.presence(seq)
        nk = bits.shape[0]
        if nk == 0:
            return []
        counts = bits.sum(axis=0, dtype=np.int64)
        keep = np.flatnonzero(counts >= math.ceil(nk * threshold))
        if threshold != 1.0:
            keep = keep[np.argsort(-counts[keep], kind="stable")]
        out = []
        for c in keep.tolist():
            found = int(counts[c])
            d = {"percent_kmers_found": round(100 * found / nk, 2), "num_kmers": nk,
                 "num_kmers_found": found, "sample_name": self.names[c]}
            if score:
                s = "".join("1" if v else "0" for v in bits[inverse, c])
                d.update(scorer.score(s, len(self.names)))
                d["kmer-presence"] = s
            out.append(d)
        return out
