"""The one traffic generator: reads a mix's parameters
(``traffic/<mix>.json``) and makes its queries and schedule from the seed.

Every seed gets the same work in another order: lengths are the
quantiles of the mix's log-uniform range, kinds come in equal shares,
thresholds in equal shares, and an open loop's gaps are the quantiles of
the exponential distribution at the mix's rate.  The seed permutes them
and draws what the queries hold: the source and the place a query is
cut from, its SNPs, and the bases of random queries.

A query is a substring of one of the planted samples' sources, with
SNPs at its kind's rate, or a random sequence; all bases are ACGT.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.harness.index import mutate, random_seq


def quantile_lengths(n: int, low: int, high: int) -> np.ndarray:
    """The n mid-quantiles of a log-uniform length on [low, high]."""
    q = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(np.log(low) + q * (np.log(high) - np.log(low)))).astype(np.int64)


def make_queries(mix: dict, sources: list[str], n: int, rng: np.random.Generator) -> list[str]:
    """n queries, in blocks of ``block`` (default n) that each hold every
    length quantile and every kind in equal shares, shuffled."""
    kinds = mix["kinds"]
    block = mix.get("block", n)
    src = [np.frombuffer(s.encode("ascii"), dtype=np.uint8) for s in sources]
    out = []
    for b0 in range(0, n, block):
        size = min(block, n - b0)
        lengths = quantile_lengths(size, mix["lengths"]["low"], mix["lengths"]["high"])
        kind = np.arange(size) % len(kinds)
        order = rng.permutation(size)
        for length, k in zip(lengths[order].tolist(), kind[order].tolist()):
            spec = kinds[k]
            if spec.get("random"):
                q = random_seq(rng, length)
            else:
                s = src[int(rng.integers(len(src)))]
                start = int(rng.integers(0, len(s) - length + 1))
                q = mutate(rng, s[start:start + length], spec["snp_rate"])
            out.append(q.tobytes().decode("ascii"))
    return out


@dataclasses.dataclass
class ClosedPool:
    """A closed loop's batches: call i sends ``batches[i % len]`` at
    ``thresholds[i % len]`` (an odd number of batches, so each meets
    every threshold)."""
    batches: list[list[str]]
    thresholds: list[float]
    score: bool

    def call(self, i: int) -> tuple[int, list[str], float]:
        j = i % len(self.batches)
        return j, self.batches[j], self.thresholds[i % len(self.thresholds)]


def closed_pool(mix: dict, sources: list[str], seed: int) -> ClosedPool:
    rng = np.random.default_rng([seed, 2])
    b, p = mix["batch"], mix["pool_batches"]
    batches = [make_queries(mix, sources, b, rng) for _ in range(p)]
    return ClosedPool(batches, [float(t) for t in mix["thresholds"]], bool(mix.get("score")))


@dataclasses.dataclass
class OpenSchedule:
    """An open loop's requests: request i is due at ``offsets[i]`` seconds
    after the window opens and sends ``queries[query[i]]`` at
    ``thresholds[i]``; the warm-up sends the same before it opens."""
    queries: list[str]
    offsets: np.ndarray
    query: np.ndarray
    thresholds: np.ndarray
    warmup: np.ndarray  # offsets of the warm-up requests


def gaps(n: int, rate: float, rng: np.random.Generator, block: int = 1024) -> np.ndarray:
    """n gaps of a Poisson arrival process at ``rate``: each block holds the
    mid-quantiles of the exponential distribution, shuffled."""
    out = []
    for b0 in range(0, n, block):
        size = min(block, n - b0)
        q = (np.arange(size) + 0.5) / size
        out.append(rng.permutation(-np.log1p(-q) / rate))
    return np.concatenate(out)


def open_schedule(mix: dict, sources: list[str], seed: int, seconds: float) -> OpenSchedule:
    rng = np.random.default_rng([seed, 3])
    rate = float(mix["rate_per_s"])
    queries = make_queries(mix, sources, mix["pool_queries"], rng)
    n = int(rate * seconds * 1.25) + 1024
    offsets = np.cumsum(gaps(n, rate, rng))
    offsets = offsets[offsets < seconds]
    thr = np.asarray(mix["thresholds"], dtype=np.float64)
    picks = np.concatenate([rng.permutation(np.arange(256) % len(thr))
                            for _ in range(-(-len(offsets) // 256))])[: len(offsets)]
    warm = np.cumsum(gaps(int(rate * mix["warmup_s"]) + 1, rate, rng))
    warm = warm[warm < mix["warmup_s"]]
    return OpenSchedule(queries, offsets, np.arange(len(offsets)) % len(queries),
                        thr[picks], warm)
