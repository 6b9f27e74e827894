"""Two-stage verified search: minimizer screen + classic verification.

A verified (screened) index keeps two structures over the same samples:

* ``rows.bin``, the canonical CLASSIC matrix, exactly as a classic index
  persists it (the reference's semantics and FPR story);
* ``screen.bin``, a minimizer-layout matrix used only to bound hit
  counts from above, cheaply.

A query screens, then verifies (the contract of bigsi_tpu's
``index/verify.py``, which this module copies):

1. SCREEN: per-colour screen counts of the whole batch, on the screen's
   engine (on the card: kernel D packs ``screen.bin``'s cols at load,
   kernel E counts them).
2. CANDIDATES: colours with ``screen_count >= min_kmers - margin``.  A
   Bloom filter has no false negatives, so ``screen_count >=
   true_count`` and ``classic_count <= true_count + classic_FP_count``;
   a colour passing the classic threshold is screened in whenever its
   classic false-positive count is at most ``margin``
   (:func:`screen_margin`).
3. VERIFY: recompute the candidates' counts with CLASSIC semantics, the
   h murmur3 rows of each k-mer from ``rows.bin`` restricted to the
   candidate words.  Where ``rows.bin`` is staged on the card, the
   whole verify runs there:
   :class:`~bigsi_tpu_torch.index.device_engine.DeviceVerifier` (kernel
   A over ``rows.bin``, only the candidates' counts sent back).  Else
   :func:`verify_queries`, the threaded native host pass, runs it.
   Result dicts equal a pure classic index's.

The port serves verified indexes through ``bigsi_tpu_torch.BIGSI``: on
the CPU (``device="cpu"``, the kernels' plain versions) in
``tests/test_torch_verified.py``, on the card in ``chip_smoke.py``'s
verified phase.
"""

from __future__ import annotations

import math
import os

import numpy as np

from bigsi_tpu_torch import native
from bigsi_tpu_torch.hashing.scheme import (
    MINIMIZER,
    SLOT_SCHEME_V3,
    default_run_len,
)

# the screen's defaults: the minimizer/16 w = 19 cols config
DEFAULT_SCREEN_WINDOW = 19
DEFAULT_SCREEN_TILE_ROWS = 16

# Margin policy: candidates must cover colours whose CLASSIC count clears
# the threshold only with the help of classic false positives (per-kmer
# FPR ~0.017 at reference sizing; FP counts ~Binomial(n, p)).  The default
# bounds p at MARGIN_FRACTION with an absolute floor, far above the
# expectation + 6 sigma at any query length.  ``verify-margin`` in the
# config overrides (0 reports only colours whose TRUE k-mer content clears
# the threshold: not reference-identical).
MARGIN_FRACTION = 0.08
MARGIN_FLOOR = 8


def screen_margin(num_kmers: int, config_margin=None) -> int:
    if config_margin is not None:
        return int(config_margin)
    return max(MARGIN_FLOOR, math.ceil(MARGIN_FRACTION * num_kmers))


def screen_params_from_config(config: dict) -> dict | None:
    """Resolve the screen build parameters, or None when not verified.

    Enabled by ``screen: minimizer`` (the only screen layout).  Keys:
    ``screen-m`` (default m), ``screen-tile-rows`` (default 16),
    ``screen-window`` (default 19), ``screen-run-len`` (default w+1).
    """
    screen = config.get("screen")
    if screen is None:
        return None
    if screen is not True and screen != MINIMIZER:
        raise ValueError(
            "config key 'screen' must be 'minimizer', got %r" % (screen,)
        )
    window = config.get("screen-window", DEFAULT_SCREEN_WINDOW)
    return {
        "m": int(config.get("screen-m", config["m"])),
        "tile_rows": int(
            config.get("screen-tile-rows", DEFAULT_SCREEN_TILE_ROWS)
        ),
        "window": int(window),
        "slot_scheme": SLOT_SCHEME_V3,
        "run_len": int(config.get("screen-run-len", default_run_len(window))),
    }


def _use_native() -> bool:
    return not os.environ.get("BIGSI_TPU_NO_NATIVE")


def live_queries(row_idx_list: list, cand_list: list) -> list:
    """Indices of the queries that have both rows and candidates."""
    return [
        i
        for i in range(len(cand_list))
        if cand_list[i] is not None
        and len(cand_list[i])
        and row_idx_list[i] is not None
        and len(row_idx_list[i])
    ]


def classic_counts_for_colours(
    words: np.ndarray, row_idx: np.ndarray, colours: np.ndarray
) -> np.ndarray:
    """Verify candidate colours: -> int64 counts aligned with ``colours``.

    ``words``: the classic matrix uint32[m, W] (a rows.bin memmap passes
    through un-copied); ``row_idx``: classic hash rows int64[K, h];
    ``colours``: candidate colour ids, any order, repeats allowed.  Colour
    c's count = |{kmer : all h rows have bit c set}|.
    """
    colours = np.asarray(colours, dtype=np.int64)
    if colours.size == 0 or row_idx.shape[0] == 0:
        return np.zeros(colours.size, dtype=np.int64)
    word_ids = np.unique(colours >> 5).astype(np.int32)
    per_word = None
    if _use_native():
        per_word = native.and_count_words(words, row_idx, word_ids)
    if per_word is None:
        per_word = _and_count_words_numpy(words, row_idx, word_ids)
    # map colour -> (word position, bit)
    order = np.searchsorted(word_ids, (colours >> 5).astype(np.int32))
    return per_word[order * 32 + (colours & 31)]


def _and_count_words_numpy(words, row_idx, word_ids) -> np.ndarray:
    """Numpy oracle for ``and_count_words``: one fused fancy-index gather
    of only the candidate words, never whole rows."""
    k, h = row_idx.shape
    sub = words[
        row_idx.reshape(-1)[:, None],
        np.asarray(word_ids)[None, :],
    ].reshape(k, h, -1)
    acc = sub[:, 0, :]
    for j in range(1, h):
        acc = acc & sub[:, j, :]
    bits = (acc[:, :, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return bits.sum(axis=0, dtype=np.int64).reshape(-1)


def verify_queries(
    words: np.ndarray,
    row_idx_list: list,
    cand_list: list,
    nthreads: int = 0,
) -> list:
    """Batched verification: one threaded native pass over all queries.

    ``row_idx_list``: per-query classic rows int64[K_i, h] (entries may be
    None or empty when the query has no candidates); ``cand_list``:
    per-query candidate colour arrays.  Returns per-query int64 counts
    aligned with each ``cand_list`` entry.
    """
    b = len(cand_list)
    out = [np.zeros(0, dtype=np.int64)] * b
    live = live_queries(row_idx_list, cand_list)
    if not live:
        return out
    word_lists = []
    orders = []
    for i in live:
        colours = np.asarray(cand_list[i], dtype=np.int64)
        wids = np.unique(colours >> 5).astype(np.int32)
        word_lists.append(wids)
        orders.append(
            np.searchsorted(wids, (colours >> 5).astype(np.int32)) * 32
            + (colours & 31)
        )
    if _use_native():
        qstart = np.zeros(len(live) + 1, dtype=np.int64)
        np.cumsum([row_idx_list[i].shape[0] for i in live], out=qstart[1:])
        idx = np.concatenate([row_idx_list[i] for i in live])
        wstart = np.zeros(len(live) + 1, dtype=np.int64)
        np.cumsum([len(w) for w in word_lists], out=wstart[1:])
        wids_all = np.concatenate(word_lists)
        nw_cap = int(max(len(w) for w in word_lists))
        got = native.and_count_words_batch(
            words, idx, qstart, wids_all, wstart, nw_cap, nthreads
        )
        if got is not None:
            for j, i in enumerate(live):
                out[i] = got[j][orders[j]]
            return out
    for j, i in enumerate(live):
        per_word = _and_count_words_numpy(
            words, row_idx_list[i], word_lists[j]
        )
        out[i] = per_word[orders[j]]
    return out
