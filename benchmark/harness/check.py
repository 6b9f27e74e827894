"""Whether the answers that the timed path gave are right: each sampled
answer is held to the plain reference's (``benchmark/reference``),
exactly.  An answer that never came counts apart, as missing.

The numbers compared, each with its limit, are ``wrong_answers`` (of the
sampled answers) and ``missing_answers`` (of all the window's); both
limits are 0, since the configuration states exact answers.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.search import Reference

LIMITS = {"wrong_answers": 0, "missing_answers": 0}


def pick(rng: np.random.Generator, candidates: list, lengths: list[int], n: int) -> list:
    """n of ``candidates`` (or all of them): the longest quarter by
    ``lengths``, the rest drawn from the seed."""
    if len(candidates) <= n:
        return list(candidates)
    order = np.argsort(-np.asarray(lengths), kind="stable")
    chosen = set(order[: n // 4].tolist())
    rest = [i for i in range(len(candidates)) if i not in chosen]
    chosen.update(rng.choice(rest, size=n - len(chosen), replace=False).tolist())
    return [candidates[i] for i in sorted(chosen)]


def compare(reference: Reference, asked: list, got: list, score: bool) -> dict:
    """``asked``: (query, threshold) pairs; ``got``: the program's result
    lists for them, None for an answer that never came."""
    wrong = missing = 0
    for (seq, threshold), answer in zip(asked, got):
        if answer is None:
            missing += 1
        elif answer != reference.answer(seq, threshold, score):
            wrong += 1
    return {"wrong_answers": wrong, "missing_answers": missing}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= limit for k, limit in LIMITS.items())
