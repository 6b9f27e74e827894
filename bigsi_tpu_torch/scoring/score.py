"""BLAST-ungapped-style scoring of k-mer presence strings.

Numeric parity with the reference scorer (``bigsi/scoring/score.py:35-151``,
golden dict in ``bigsi/tests/scoring.py:10-31``), including its quirks:

* ``remove_short_ones`` erodes 1-runs shorter than 3 by AND-ing the
  string with its two left-shifts, padding with ones at the end
  (``score.py:7-16``);
* ``tabulate_score`` reports every non-final run as ``length + 1`` and
  only the final run at its true length (``score.py:19-32``);
* the SNP threshold hard-codes k=31 (+3 ``kmer_adjust``) and ``seq_len``
  adds ``31 - 1`` (``score.py:61, 99``);
* BLAST constants: lambda=1.330, K=0.621 ungapped (``score.py:39-42``);
* the three score accumulators are re-rounded to 2 decimals after EVERY
  zero-run (``score.py:81-83``) — so they cannot be fully vectorized
  without changing results.  Everything per-run (SNP estimates, score
  deltas, mismatch totals) is computed vectorized over the run-length
  arrays; only the final rounded accumulation folds in Python, one
  add+round per zero-run.

Implementation is array-first: presence strings become uint8 arrays,
runs become int arrays; the dict-of-lists shape of ``tabulate_score``
exists only as the parity-facing helper.
"""

from __future__ import annotations

import math

import numpy as np

# Reference hard-codes k=31 throughout scoring (score.py:61,99)
_K_FIXED = 31
_KMER_ADJUST = 3
_SNP_T = _K_FIXED + _KMER_ADJUST


def _bits(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("ascii"), dtype=np.uint8) - ord("0")


def remove_short_ones(s: str) -> str:
    if len(s) < 3:
        return s
    a = _bits(s)
    padded = np.concatenate([a, np.ones(2, dtype=np.uint8)])
    out = padded[:-2] & padded[1:-1] & padded[2:]
    return "".join("1" if v else "0" for v in out)


def _run_arrays(ss: str) -> tuple[np.ndarray, np.ndarray]:
    """Run-length decomposition with the reference's off-by-one.

    Returns ``(zero_runs, one_runs)`` int64 arrays in left-to-right
    order, each non-final run reported as ``length + 1`` and the final
    run at its true length (``bigsi/scoring/score.py:19-32``).
    """
    if not ss:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    a = _bits(ss)
    boundaries = np.flatnonzero(a[1:] != a[:-1])
    starts = np.concatenate([[0], boundaries + 1])
    ends = np.concatenate([boundaries, [len(a) - 1]])
    lengths = ends - starts + 1
    lengths[:-1] += 1  # the reference quirk
    chars = a[starts]
    return lengths[chars == 0], lengths[chars == 1]


def tabulate_score(ss: str) -> dict:
    """Parity-facing wrapper: runs as ``{"0": [...], "1": [...]}``."""
    zeros, ones = _run_arrays(ss)
    return {"0": zeros.tolist(), "1": ones.tolist()}


def _fold_rounded(start: float, deltas: np.ndarray) -> float:
    """Left fold of ``round(acc + d, 2)`` — the reference re-rounds the
    running score after every zero-run, so this stays a (cheap) loop."""
    acc = start
    for d in deltas.tolist():
        acc = round(acc + d, 2)
    return acc


class Scorer:
    """Scores a 0/1 k-mer presence string against a database of
    ``db_size`` sequences: estimates SNP counts from zero-runs, converts
    them to a BLAST-ungapped-style score, E-value and p-value."""

    def __init__(
        self,
        DB_SIZE,
        MATCH=1,
        MISMATCH=2,
        LAMBDA_UNGAPPED=1.330,
        K_UNGAPPED=0.621,
        LAMBDA_GAPPED=1.28,
        K_GAPPED=0.46,
    ):
        self.DB_SIZE = DB_SIZE
        self.MATCH = MATCH
        self.MISMATCH = MISMATCH
        self.LAMBDA_UNGAPPED = LAMBDA_UNGAPPED
        self.K_UNGAPPED = K_UNGAPPED
        self.LAMBDA_GAPPED = LAMBDA_GAPPED
        self.K_GAPPED = K_GAPPED
        self.kmer_adjust = _KMER_ADJUST

    # -- core ---------------------------------------------------------

    def _zero_run_scores(self, zeros: np.ndarray, base: float) -> dict:
        """Vectorized per-zero-run math + the rounded folds.

        For each zero-run of (quirked) length ``i``:
          min_snps  = i / SNP_t            (SNPs if maximally spread)
          max_snps  = max(i - SNP_t + 1, min_snps)
          mean_snps = min_snps + 0.05 * max_snps
        and each snps estimate contributes a score delta of
        ``MATCH*i - (MATCH+1) * MISMATCH * snps`` — note the reference
        pairs the MIN penalty with the MAX score and vice versa
        (``score.py:81-82``).
        """
        snp_t = _K_FIXED + self.kmer_adjust
        zf = zeros.astype(np.float64)
        min_snps = zf / snp_t
        max_snps = np.maximum(zf - snp_t + 1, min_snps)
        mean_snps = min_snps + 0.05 * max_snps

        def deltas(snps):
            penalty = self.MISMATCH * snps
            return self.MATCH * zf - (self.MATCH + 1) * penalty

        # sequential (non-pairwise) sums: ceil/floor parity at the edges
        min_total = float(np.cumsum(min_snps)[-1]) if len(zf) else 0.0
        max_total = float(np.cumsum(max_snps)[-1]) if len(zf) else 0.0
        return {
            "max_score": _fold_rounded(base, deltas(min_snps)),
            "min_score": _fold_rounded(base, deltas(max_snps)),
            "mean_score": _fold_rounded(base, deltas(mean_snps)),
            "min_total_snps": min_total,
            "max_total_snps": max_total,
        }

    def calculate_score(self, score_counter: dict, convert: float) -> dict:
        """Parity-facing API: dict-of-lists in, score dict out."""
        zeros = np.asarray(score_counter["0"], dtype=np.int64)
        base = float(self.MATCH * sum(score_counter["1"]))
        r = self._zero_run_scores(zeros, base)
        return {
            "score": round(r["mean_score"] * convert, 2),
            "min_score": round(r["min_score"] * convert, 2),
            "max_score": round(r["max_score"] * convert, 2),
            "max_mismatches": math.ceil(r["max_total_snps"]),
            "min_mismatches": math.floor(r["min_total_snps"]),
            "mismatches": math.ceil(
                math.ceil(r["min_total_snps"])
                + 0.05 * math.floor(r["max_total_snps"])
            ),
        }

    def score(self, s: str) -> dict:
        ss = remove_short_ones(s)
        seq_len = len(ss) + _K_FIXED - 1
        convert = seq_len / len(ss)
        zeros, ones = _run_arrays(ss)
        base = float(self.MATCH * int(ones.sum()))
        r = self._zero_run_scores(zeros, base)

        d = {
            "score": round(r["mean_score"] * convert, 2),
            "min_score": round(r["min_score"] * convert, 2),
            "max_score": round(r["max_score"] * convert, 2),
            "max_mismatches": math.ceil(r["max_total_snps"]),
            "min_mismatches": math.floor(r["min_total_snps"]),
            "mismatches": math.ceil(
                math.ceil(r["min_total_snps"])
                + 0.05 * math.floor(r["max_total_snps"])
            ),
            "length": seq_len,
        }
        d["max_nident"] = seq_len - d["min_mismatches"]
        d["nident"] = seq_len - d["mismatches"]
        d["min_nident"] = seq_len - d["max_mismatches"]
        for prefix in ("", "max_", "min_"):
            d[prefix + "pident"] = 100 * float(d[prefix + "nident"]) / seq_len
        d["evalue"] = self.evalue(d["score"], seq_len)
        d["pvalue"] = self.pvalue(d["evalue"])
        d["log_evalue"] = round(self.log_evalue(d["score"], seq_len), 2)
        d["log_pvalue"] = round(self.log_pvalue(d["log_evalue"]), 2)
        return d

    # -- statistics ---------------------------------------------------

    def bitscore(self, s: str):
        raw = self.score(s)["score"]
        return (
            self.LAMBDA_UNGAPPED * raw - np.log(self.K_UNGAPPED)
        ) / np.log(2)

    def evalue(self, score, n):
        return (
            self.K_UNGAPPED
            * self.DB_SIZE
            * n
            * np.exp(-self.LAMBDA_UNGAPPED * score)
        )

    def pvalue(self, evalue):
        return 1 - np.exp(-evalue)

    def log_evalue(self, score, n):
        db = self.DB_SIZE or 1
        return round(
            np.log10(self.K_UNGAPPED * db * n) - self.LAMBDA_UNGAPPED * score,
            2,
        )

    def log_pvalue(self, log_evalue):
        evalue = 10 ** log_evalue
        tail = 1 - np.exp(-evalue)
        if tail > 0:
            return round(np.log10(tail), 2)
        return round(log_evalue, 2)
