"""Upstream BIGSI's scorer of k-mer presence strings (``bigsi/scoring/
score.py`` of BIGSI v0.3.8), frozen here in plain Python and NumPy with
its quirks: 1-runs shorter than 3 are eroded, every run but the last is
counted one too long, k is fixed at 31, and the running scores are
rounded to 2 decimals after every 0-run."""

from __future__ import annotations

import math

import numpy as np

K = 31
KMER_ADJUST = 3
MATCH, MISMATCH = 1, 2
LAMBDA, K_UNGAPPED = 1.330, 0.621


def erode(s: str) -> str:
    if len(s) < 3:
        return s
    a = np.frombuffer(s.encode("ascii"), dtype=np.uint8) - ord("0")
    padded = np.concatenate([a, np.ones(2, dtype=np.uint8)])
    out = padded[:-2] & padded[1:-1] & padded[2:]
    return "".join("1" if v else "0" for v in out)


def runs(s: str) -> tuple[list[int], list[int]]:
    """(0-runs, 1-runs) left to right, each but the last one too long."""
    zeros, ones = [], []
    if not s:
        return zeros, ones
    start = 0
    for i in range(1, len(s) + 1):
        if i == len(s) or s[i] != s[start]:
            n = i - start + (0 if i == len(s) else 1)
            (zeros if s[start] == "0" else ones).append(n)
            start = i
    return zeros, ones


def fold(base: float, deltas) -> float:
    acc = base
    for d in deltas:
        acc = round(acc + d, 2)
    return acc


def score(s: str, db_size: int) -> dict:
    """The score dict of presence string ``s`` over ``db_size`` samples."""
    ss = erode(s)
    seq_len = len(ss) + K - 1
    convert = seq_len / len(ss)
    zeros, ones = runs(ss)
    snp_t = K + KMER_ADJUST
    zf = np.asarray(zeros, dtype=np.float64)
    min_snps = zf / snp_t
    max_snps = np.maximum(zf - snp_t + 1, min_snps)
    mean_snps = min_snps + 0.05 * max_snps
    base = float(MATCH * sum(ones))

    def deltas(snps):
        return (MATCH * zf - (MATCH + 1) * (MISMATCH * snps)).tolist()

    min_total = float(np.cumsum(min_snps)[-1]) if len(zf) else 0.0
    max_total = float(np.cumsum(max_snps)[-1]) if len(zf) else 0.0
    d = {
        "score": round(fold(base, deltas(mean_snps)) * convert, 2),
        "min_score": round(fold(base, deltas(max_snps)) * convert, 2),
        "max_score": round(fold(base, deltas(min_snps)) * convert, 2),
        "max_mismatches": math.ceil(max_total),
        "min_mismatches": math.floor(min_total),
        "mismatches": math.ceil(math.ceil(min_total) + 0.05 * math.floor(max_total)),
        "length": seq_len,
    }
    d["max_nident"] = seq_len - d["min_mismatches"]
    d["nident"] = seq_len - d["mismatches"]
    d["min_nident"] = seq_len - d["max_mismatches"]
    for prefix in ("", "max_", "min_"):
        d[prefix + "pident"] = 100 * float(d[prefix + "nident"]) / seq_len
    d["evalue"] = K_UNGAPPED * db_size * seq_len * np.exp(-LAMBDA * d["score"])
    d["pvalue"] = 1 - np.exp(-d["evalue"])
    log_evalue = round(np.log10(K_UNGAPPED * (db_size or 1) * seq_len) - LAMBDA * d["score"], 2)
    d["log_evalue"] = round(log_evalue, 2)
    tail = 1 - np.exp(-(10 ** log_evalue))
    d["log_pvalue"] = round(np.log10(tail), 2) if tail > 0 else round(log_evalue, 2)
    return d
