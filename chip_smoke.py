#!/usr/bin/env python3
"""Smoke run of bigsi_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Drives the port's search path at BASELINE.json's second config: 1,024
samples, m = 2.5e7 bloom bits, h = 3, k = 31, so a uint32[25,000,000, 32]
matrix, 3.2 GB on the card; batches of 256 queries of 542 bp (512
k-mers each), the shape of bench.py.  Phases:

1. device: a CUDA device is required; prints its name and power limit;
2. build: nvcc of bigsi_tpu_torch/csrc/lookup.cu and g++ of the port's
   host native library (csrc/host_native.cpp), started together, both
   into this checkout's build/;
3. kernels: kernels A (classic_counts), B (tile_counts), C
   (grouped_tile_counts), D (pack_tile_cols) and E (cols_counts) agree
   bit for bit with their plain PyTorch versions, at the slice's shapes
   (the full-size matrix, B = 256, K = 512, grouped streams of runs of
   tiles as the minimizer layout makes them, D and E at tile_rows 16
   and 32) and at ragged ones (W 1, 33 and 64, tile_rows 8 to 64, so E on
   uint8, int16 and int32 cols, R 1, 6 and 20, U not a multiple of 16
   or of E's ring of 16, U = 4,000 at R = 20 (past a 16-bit field
   counter, many staged chunks), empty and all-padding queries, B or K
   of 0); then kernel H (seq_streams) agrees bit for bit with
   ops/prep.py:prep_streams on utile, gmask, n_valid and ok at the
   slice's shapes (B = 256 queries padded to 576 bytes, both cols
   configs, the engine's safe and tight budgets) and at ragged ones
   (B = 1, lengths 0, below k and k, k = 32 poly-T, k = 15, planted
   repeats, a query beside its reverse complement, num_tiles 2^20 and
   1, budgets that overflow, 4,096 bytes at B = 8 and 1, h = 10, and the
   dedup table's hazards: k = 32 poly-A and poly-T whole queries, whose
   codes are 0 and 2^64 - 1, a 40-mer repeated to 576 bytes, 256
   identical queries), and kernel
   E agrees with its plain version on every one of those streams,
   overflowed ones included, over random cols of the case's tiles; B's
   and C's bit-plane counters are driven past 2^16 on all-ones words
   (B's counts of 4,096 in both builds, C's of 80,000, A's of 70,000 in
   one query) and by masks of rows 32-63 alone; kernel D at tile_rows
   1, 5, 8, 12, 16, 31 and 32, W 1, 33 and 64, one tile, 3,001 and
   100,003 tiles, words and cols off the vector alignment, and packed in
   chunks of 7 tiles into slices of one cols; kernel A splits single
   queries and pairs (B 1 and 2, K 512 and 20,000) over blocks and a
   batch of 256 not, at h 1, 3, 5 and 8 (past the 4 rows read ahead),
   with half- and all-padding queries and K = 0; kernel L (presence_rows)
   at W 1, 33 and 64, K 1, 37 and 300, classic h 1, 3 and 8, slot at
   tile_rows 8 to 64 and cols of uint8, int16 and int32, masks of 0, of
   many rows and of rows 32-63, each tiled case whole and as two row
   slabs with their tile windows; kernel L's strings form
   (presence_strings) at W 1, 33 and 64, Q 1, 7 and 256 queries of up to
   K 1, 37 and 300 distinct k-mers, with duplicate positions, results in
   any order and in the last word beside phantom samples, on each source
   (classic h 1, 3 and 8; slot at tile_rows 8 to 64 with slots in rows
   32-63; cols of uint8, int16 and int32) and one 20 kb query, each
   given the plain version's offsets; and a mutation check:
   small blocked/32 and
   minimizer/64 indexes on the card, merged and then overwritten in one
   colour, give the host engine's results on a rebuilt engine;
4.-9. six indexes, each an in-memory index of random rows at the bit
   density of scripts/synth_index.py, drawn on the card, with 4 planted
   samples: classic (kernel A), blocked at tile_rows 32 (kernel B),
   minimizer at tile_rows 16 with w = 19, slot scheme 3, r = 20 (the
   JAX package's headline serving config), minimizer at the default
   tile_rows 32, window and slot scheme (w = 11, scheme 3, r = 6) --
   both cols indexes run kernel D at engine load, once per chunk of
   about 2^20 rows as the engine streams the matrix in, and the seq arm
   (counts_batch_seqs: kernels H and E) serves their all-ACGT batches
   -- minimizer at tile_rows 64 (kernel C through counts_batch), and
   (phase 9) a verified index: classic rows.bin plus a minimizer/16 w = 19
   screen.bin of the same size with the screen's defaults (scheme 3, r =
   20), both drawn with the planted blooms' halves.  Its screen runs
   kernel D at load and kernel E through counts_batch_kmers (the seq arm
   is gated off for screened indexes); its first batched verify stages
   rows.bin on the card (the staging time and device peak are printed),
   and from then on every verify, batched or single, runs on
   DeviceVerifier (kernel A, only the candidates' counts sent back).
   Each runs a single search, a scored search and a scored search_batch
   of the 256 queries at 0.7 (their times printed, the batch split by
   the facade's spans search.batch_counts, search.presence, search.score
   and search.batch_results; kernel L's strings form must launch once
   for the search and once for the batch, its row form never; on the
   verified index, which scores on its classic host engine, neither), a
   bulk_search of a
   256-record FASTA through the port's CLI at thresholds 1.0 and 0.7,
   and 3 GET, 1 POST
   and a burst of 8 concurrent GETs (coalesced by the server's batcher)
   against the port's HTTP server.  The cols indexes also search a batch
   with one N base (the k-mer path), 8 queries of 4,000 bp (the seq arm)
   and 248 queries of 542 bp with 8 of 20 kb (split by the facade; the
   guard refuses the 20 kb half).  Each counts_batch_seqs call is
   counted as served, overflowed or refused; minimizer/16 must serve
   every batch the guard admits, and each fall-back goes to
   counts_batch_kmers.  Every result dict must equal what the facade
   returns on the numpy host engine (``engine: numpy``) on the same
   index; the verified index's also equal a classic index's holding the
   same rows.bin (``engine: numpy``).  Each index's load, ``BIGSI(config, device)``, prints its wall
   time and its peak on the device (peak allocation less what was held
   before); a cols index's peak must stay under its row-major words plus
   its cols.  The launch counts are set to 0 before each index and read
   after it: its kernels must have run, and no other (the verified
   index: D, E and A);
10. times, each beside the GPU's name and power limit: search_batch
   latency and queries/s for 256 queries, split inside each call by the
   facade's timers into the host's part, the engine and result
   building, on the seq path also by the engine's spans (copies in,
   kernels H and E up to the ok read, counts back); on the cols indexes
   once on the seq path and once on the k-mer path (the seq arm turned
   off on the engine instance); each
   kernel beside its plain version on the inputs the facade gave the
   engine: kernel H on the facade's own bytes, kernel E on H's streams
   and on the native prep's, kernel C on H's streams over the row-major
   words, with E's and C's bounds, GB/s and shares of bound; kernel D on
   the full-size matrix (held to the cols the engine packed in chunks,
   then timed at tile_rows 16, 8 and 32 beside its plain version, its
   bound and a torch copy_ of the same bytes), and kernel C on the
   minimizer/16
   native prep streams; then (bigsi_tpu_torch.scripts.probe_ah) kernel A
   on the classic index's matrix at B = 256 and at single queries of 512
   and 20,000 k-mers, the classic index's single search of a 542 bp and
   a 20 kb query, and kernel H at B = 256, L = 576 (both cols configs)
   and B = 8, L = 4,096: wrapper, kernel alone and each pass; the
   verified index's search_batch at 1.0 and 0.7, split by the facade's
   timers (host k-mer prep, the screen, candidates and classic hashing,
   the verify, result building), and at two verify loads (the live
   queries of one search_batch; bench.py's B = 256, K = 512, 8 random
   candidates a query) DeviceVerifier held to kernel A's plain version
   plus the same gather and to the native host pass, counts_async shown
   to return before the device finishes, the device verify on CUDA
   events (each call's work queued behind a spin that outlasts its host
   part: copies in, A, gather, counts back) beside A alone and A's bound,
   and DeviceVerifier.counts, its staging and the host pass on the host
   clock; kernel L on every index (the verified one's screen) at the
   facade's k-mers of a 542 bp and a 20 kb query (K 512 and about
   20,000), held to its plain version and timed beside it and its bound;
   and kernel L's strings form on each index's own scored batch (the
   arguments its engine passed in a scored search_batch at 0.7), held to
   its plain version and timed beside it, its bound and the row form's
   launches over the same hit queries (each alone, summed, and back to
   back);
11. probes: the three probe entry points of bigsi_tpu_torch.scripts
   (probe_multidma, bisect, microbench) run in-process over the
   blocked/32 index's resident words (tile_rows 32: 4 KB tiles; S2 views
   them as [6.25e6, 128]).  First kernels F (gather_rows), G (tile_xor)
   and B's counts-only build are held bit for bit to their plain
   versions at the probes' shapes and at ragged ones (gather_rows at
   Wr 1, 33, 128 and 8,192, n 0, 1 and not a multiple of the rows in
   flight, every rows-in-flight build, a misaligned view, the last row of
   the full-size view; tile_xor and B's counts-only build at W 1 and 33,
   tile_rows 8 to 64, all-padding queries, B or K of 0).  Then the launch
   counts are set to 0 and the entry points run: the S2 gather (its
   default shape, then 128 B, 512 B and 4 KB rows at kernel B's 50 MB per
   batch, then 128 B rows drawn from the first 32 MB, 512 MB and 3.2 GB
   of the matrix), the bisection's kernel / compile / size subcommands and every
   microbench case, each kernel checked against its plain version and
   timed beside it, pallas-work (kernel C over the pre-gathered tiles)
   checked equal to kernel C over the words; kernels F, G, B (both
   builds) and C must have launched, and no other.  torch's
   index_select of S2's rows is timed as kernel F's yardstick;
12. hashing and build: kernel I (kmer_rows) bit for bit against its
   plain version (ops/hash.py) at k 1-9, 16, 31, 32 and 33, seeds [0, 1,
   99, 2^32 - 1], h 1, 3 and 8, K 0 and 1, N and lowercase bytes,
   palindromes, blocked rows at tile_rows 8, 32 and 64 with m below
   tile_rows and m not a multiple of 32, with and without canonical
   forms, the golden "ATT" rows, and on the classic index's phase-10
   batch (256 queries, 512 distinct 31-mers each), whose rows must be the
   facade's kmer_matrix_to_row_idx rows; the port's entry() on the card
   against its plain run; kernel J (bloom_scatter) against its plain
   version (ops/build.py) on one sample of KMERS_PER_SAMPLE distinct
   31-mers of a random genome (classic and blocked/32, m = 2.5e7, h = 3)
   and at small m, and 256 copies of one k-mer; kernel K
   (bloom_transpose) at N 1 to 4,096 (W 1 to 128) and m 1,000 to 70,001;
   then I and J at the edges of their staged reader: k 31, 63, 64, 100
   and 10,000, K 1, 255, 256, 257 and 4,097, views x[1:] and x[3:] whose
   bytes start off a 16-byte boundary, all-N, lowercase and palindromic
   k-mers in one run with ordinary ones, blocked J at tile_rows 24 and
   64, and at full size sample[1:], sample[3:] and a slice of the batch.
   Then, the launch counts set to 0: the full query step
   (ops/lookup.py:make_full_query_step, kernels I then A) on the classic
   words and that batch, whose counts must be kernel A's on the facade's
   host-hashed rows; device_bloom of the sample in both layouts (J),
   each equal to the port's host bloom, with its set-bit share beside
   synth.bloom_density; and the round trip words -> kernel D at
   tile_rows 32 -> the transposed cols (the 1,024 blooms) ->
   device_transpose (K), which must give the words back bit for bit.
   I, A, J, K and D must have launched, and no other.  Times on CUDA
   events with a cold L2: I, the full step, J (both layouts; J classic
   split by I on the sample, which is J without its atomics) and K beside
   their plain versions and bounds (K on a slice first held to its plain
   version), and K beside a torch copy_ of the blooms.  Phase 10 also
   prints each row-major index's host part split by the facade's spans
   (search.kmer_prep, search.hash, search.pad) and, beside the classic
   index's search.hash, kernel I on that batch's distinct k-mers with
   and without their copy-in;
13. the mesh: the indexes of phases 4-9 reopened one at a time with
   ``engine: mesh`` (bigsi_tpu_torch/parallel/sharding.py, the
   single-controller MeshEngine) and every position on cuda:0: classic
   on [2, 2, 2] (kernel A; the k-axis sum and exact AND) and [1, 1, 3]
   (phantom samples, W 32 -> 33), blocked/32 on [2, 2, 2] (A over row
   ids), minimizer/16 on [2, 1, 4] on the seq arm (H per batch shard,
   E per position) and with supports_seq_batch off (E), minimizer/64 on
   [2, 1, 2] (C) and [2, 1, 2, 2] (C over row slabs) and the verified
   index's screen on [2, 1, 4] (E; it scores on the host).  Each
   handle's search_batch of the
   256 queries at 1.0 and 0.7, search of 542 bp and 20 kb at 1.0 and
   0.7, and scored search and search_batch at 0.7 must equal the
   single-device handle's result dicts; one search_batch must launch
   its step's kernel once per position and no other, the scored search
   and search_batch kernel L once per sample shard (and slab) for the
   search and for each hit query, each of a scored search's L launches
   (every sample shard and slab) held to its plain version; its load (wall
   time, device peak under the shards plus staging), the median of 5
   search_batch calls split by search.batch_counts beside the
   single-device handle's, and A, C and E on the shards (W_l 16, 11 and
   8 words) beside their plain versions and bounds are printed; A's
   exact words of empty k-slices are all ones at one block a query and
   split; dropping a handle frees its shards.  Then an interior insert
   on a small [2, 2, 2] mesh index frees the old shards before the new
   ones are placed, and dryrun_multichip(8, device="cuda:0") runs every
   step once.  Only A, C, D, E, H and L may launch;
14. multi-process serving (bigsi_tpu_torch/parallel/distributed.py):
   a classic and a minimizer/16 (w = 19, slot scheme 3, r = 20) index of
   the same size written to disk (storage-engine bigsi-tpu, under
   build/chip_smoke/distributed, its free space printed first, deleted
   at the end).  A fleet of 2 ranks, fresh processes of this script
   (--dist-rank) joined over gloo, both on cuda:0, each reading its
   shards from the minimizer/16 rows.bin mmap: on mesh [2, 1, 2] rank 0
   dispatches query (kernel A) on the facade's rows of the 256 queries,
   query_grouped (C) on their grouped streams, query_seqs (D at the
   first, then H and E) on their bytes and presence on one query, then
   query_grouped and presence with 2 row shards (C over slabs); every
   output bit-equal to the single-device engine's on the same inputs
   (query to kernel A's plain version on the whole matrix), each rank's
   launches counted from 0 (A, C, D, E, H and L, no other; L once per
   local sample shard, or slab, a presence op), each op's
   median dispatch of 5 beside the single-device call, split into its
   legs on rank 0's host clock (pad, pack, the header's and the buffer's
   broadcasts, rank 0's part, the gather, the join).  After each
   service each rank in turn, uncounted, holds A, C, E, H and L to their
   plain versions on the inputs of their first launch there (L also on
   every shard and slab of its presence part) and every cols chunk to
   D's plain version, and times them.  Then, for
   each index, both ranks run `python -m bigsi_tpu_torch serve
   --distributed` from the BIGSI_TPU_* variables; GET /search (542 bp,
   20 kb, one scored), /bulk_search of the 256-record FASTA at 1.0 and
   0.7 and 8 concurrent GETs must equal the single-device handle's,
   POST /insert answers 403, the median of 5 /bulk_search calls is
   printed beside the single-device search_batch, and SIGINT to rank 0
   stops both ranks (exit 0 within 60 s).  A rank that fails or runs
   over fails the run with its stderr tail.

Then a check that no module of bigsi_tpu or jax was loaded, one JSON
line of the kernels (each with its launches on the main path, phase 13's
included, and for kernel L's row form, which serves only the meshes and
the fleets since the strings form took the single device's scoring,
phase 13's; its time, its plain version's, the least time its bytes allow
on an H100 (3.35 TB/s) for this run's inputs, the one-call PyTorch
yardstick where there is one, for A, C, E and L their times on the mesh
shards, and the launches of phase 14's service ranks summed as
dist_launches with their times on the ranks' shards as dist_shards), and
last the JSON line {"ok": true, "device": {...}}.  Any failure exits
non-zero; with no CUDA device it exits 1 before printing any result.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"  # configs and the FASTA of this run

M = 25_000_000  # bloom bits = bitslice rows
N = 1024  # samples
W = N // 32
H = 3
K_LEN = 31
B = 256  # queries per batch
QUERY_LEN = 542  # 512 k-mers per query
# k-mers per synthetic sample: sets the bit density (scripts/synth_index.py)
KMERS_PER_SAMPLE = 4_000_000
PLANTED = 4
PLANTED_LEN = 2000
DEVICE = "cuda"
# slots per grouped entry (default_run_len) and k-mers per minimizer run,
# (w + 1) / 2: at w = 19 (the headline config) and the default w = 11
HEADLINE_R, HEADLINE_RUN = 20, 10
DEFAULT_R, DEFAULT_RUN = 6, 6
SOURCE = "bigsi_tpu_torch/csrc/lookup.cu"
# the kernels, L in both its forms: (name, TPU kernels or XLA program it replaces)
KERNELS = (
    ("classic_counts", "bigsi_tpu/index/device_engine.py:89"),
    ("tile_counts", "bigsi_tpu/ops/pallas_lookup.py:203, scripts/bisect_kernel.py:49"),
    ("grouped_tile_counts",
     "bigsi_tpu/ops/pallas_lookup.py:322, bigsi_tpu/ops/pallas_grouped.py:149, "
     "scripts/microbench.py:233"),
    ("pack_tile_cols", "bigsi_tpu/ops/lookup.py:338"),
    ("cols_counts", "bigsi_tpu/ops/lookup.py:419"),
    ("gather_rows", "scripts/probe_multidma.py:62"),
    ("tile_xor", "scripts/microbench.py:233, scripts/bisect_kernel.py:49, "
     "scripts/bisect_compile.py:107, scripts/bisect_size.py:73"),
    ("seq_streams", "bigsi_tpu/ops/prep_jax.py:260"),
    ("kmer_rows", "bigsi_tpu/ops/hash_jax.py:32, :72, :104; bigsi_tpu/ops/build_jax.py:54-60"),
    ("bloom_scatter", "bigsi_tpu/ops/build_jax.py:41"),
    ("bloom_transpose", "bigsi_tpu/ops/build_jax.py:78"),
    ("presence_rows", "bigsi_tpu/index/device_engine.py:79, :151, :158"),
    ("presence_strings",
     "bigsi_tpu/index/device_engine.py:79, :151, :158; bigsi_tpu/graph/bigsi.py:713-726"),
    ("hits_compact",
     "none: the JAX package thresholds on the host (bigsi_tpu/graph/bigsi.py:627-628)"),
)
COLS_KERNELS = ("pack_tile_cols", "cols_counts", "seq_streams")
PRESENCE = "presence_rows"  # kernel L's row form: a mesh's and a fleet's scored presence
STRINGS = "presence_strings"  # kernel L's strings form: every scored search on a DeviceEngine
HITS = "hits_compact"  # kernel M: the classic native route's and the seq arm's unscored batches
# the indexes of phases 4-9: name -> (config entries, kernels of its path)
INDEXES = {
    "classic": ({"layout": "classic"}, ("classic_counts", HITS, STRINGS)),
    "blocked/32": ({"layout": "blocked", "tile-rows": 32}, ("tile_counts", STRINGS)),
    "minimizer/16": ({"layout": "minimizer", "tile-rows": 16, "minimizer-window": 19},
                     COLS_KERNELS + (HITS, STRINGS)),
    "minimizer/32": ({"layout": "minimizer", "tile-rows": 32}, COLS_KERNELS + (HITS, STRINGS)),
    "minimizer/64": ({"layout": "minimizer", "tile-rows": 64},
                     ("grouped_tile_counts", STRINGS)),
    # rows.bin classic, screen.bin minimizer/16 w = 19 (the screen's
    # defaults); its scored searches run on the classic host engine
    "verified": ({"layout": "classic", "screen": "minimizer"},
                 ("pack_tile_cols", "cols_counts", "classic_counts")),
}
VERIFIED = "verified"
HEADLINE = "minimizer/16"
# the engine's spans inside counts_batch_kmers and counts_batch_seqs, and
# the facade's over the host part of a search_batch off the seq arm
SPANS = ("engine.kmer_prep", "engine.kmer_counts", "engine.seq_in", "engine.seq_kernels",
         "engine.seq_out", "search.kmer_prep", "search.hash", "search.pad")
HOST_SPANS = ("search.kmer_prep", "search.hash", "search.pad")
PROBE_INDEX = "blocked/32"  # whose resident words the probes of phase 11 read
PROBE_KERNELS = ("gather_rows", "tile_xor", "tile_counts", "grouped_tile_counts")
# the cols indexes, with their r: the seq arm (kernels H and E) serves
# their unscored all-ACGT batches, counts_batch_kmers the rest
COLS_INDEXES = {HEADLINE: HEADLINE_R, "minimizer/32": DEFAULT_R}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + what)


def kernel_fns():
    from bigsi_tpu_torch.ops import fused_lookup

    return {name: getattr(fused_lookup, name) for name, _ in KERNELS}


# -- the least time of each kernel's work ---------------------------------

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA's data sheet)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def popcount64(x):
    """The set bits of each int64 of ``x``."""
    import torch

    count = torch.zeros_like(x)
    for bit in range(64):
        count += (x >> bit) & 1
    return count


def count_bytes(b: int, w: int) -> int:
    """counts int32[B, W * 32] and exact int32[B, W], written once."""
    return b * w * 33 * 4


def bound_bytes(name: str, *args) -> int:
    """The bytes kernel ``name`` must move on the arguments of the timed
    call: each input it needs read once, each output written once.  A
    gathered row counts once per k-mer or entry that selects it (the
    rows are random, the L2 holds 50 MB); padding selects nothing, and
    a grouped entry reads the rows its slots' masks select (kernel C)
    or its cols row when any slot is live (kernel E)."""
    from bigsi_tpu_torch.ops import lookup as plain

    if name == "classic_counts":
        words, idx, mask = args
        w = words.shape[1]
        rows = int(mask.sum()) * idx.shape[2]
        return rows * w * 4 + nbytes(idx, mask) + count_bytes(idx.shape[0], w)
    if name == "tile_counts":
        words, tile, smask = args[:3]
        w = words.shape[1]
        rows = int(popcount64(smask).sum())
        return rows * w * 4 + nbytes(tile, smask) + count_bytes(tile.shape[0], w)
    if name == "grouped_tile_counts":
        words, utile, gmask, tile_rows = args
        union = gmask[..., 0]
        for j in range(1, gmask.shape[2]):
            union = union | gmask[..., j]
        if tile_rows < 64:
            union = union & ((1 << tile_rows) - 1)
        w = words.shape[1]
        rows = int(popcount64(union).sum())
        return rows * w * 4 + nbytes(utile, gmask) + count_bytes(utile.shape[0], w)
    if name == "pack_tile_cols":
        words, tile_rows = args
        cols = words.shape[0] // tile_rows * words.shape[1] * 32
        return nbytes(words) + cols * plain.cols_dtype(tile_rows).itemsize
    if name == "cols_counts":
        cols, utile, gmask, n_valid = args
        live = ((gmask & ((1 << cols.element_size() * 8) - 1)) != 0).any(dim=2)
        return (int(live.sum()) * cols.shape[1] * cols.element_size()
                + nbytes(utile, gmask, n_valid) + count_bytes(utile.shape[0], cols.shape[1] // 32))
    if name == "gather_rows":
        mat, idx = args
        return 2 * idx.numel() * mat.shape[1] * 4 + nbytes(idx)
    if name == "tile_xor":
        words, tile, valid, tile_rows = args
        out = tile.shape[0] * tile_rows * words.shape[1] * 4
        return int(valid.sum()) * tile_rows * words.shape[1] * 4 + nbytes(tile, valid) + out
    if name == "seq_streams":  # outs: utile, gmask, n_valid; and the ok byte
        seqs, lens, outs = args
        return nbytes(seqs, lens, *outs) + 1
    if name in ("kmer_rows", "bloom_scatter", "bloom_transpose"):  # inputs, outputs
        return nbytes(*args)
    if name == PRESENCE:  # the rows (or cols rows) its k-mers select, inputs, output
        from bigsi_tpu_torch.scripts.probe_presence import presence_bytes

        return presence_bytes(*args)
    if name == STRINGS:
        return strings_bytes(*args)
    raise ValueError(name)


SECTOR = 32  # bytes: the least the card's memory moves for one random word


def strings_bytes(matrix, source, rows, kmer_off, pos_kmer, pos_off, res_query, res_colour,
                  tile_rows=1) -> int:
    """The bytes kernel L's strings form must move: one 32-byte sector for
    each distinct (row, word of a result's sample) that a result's query's
    k-mers select (on the cols source the sector of each distinct (tile,
    sample) element), its inputs read once (the offsets int64[R + 1]
    among them) and its strings written once.  Distinct, because a
    minimizer query's k-mers share tiles and results may share words."""
    import torch

    from bigsi_tpu_torch.ops import lookup as plain

    q = res_query.long()
    first = kmer_off.long()[q]
    ks = kmer_off.long()[q + 1] - first
    res = torch.repeat_interleave(torch.arange(q.shape[0], device=q.device), ks)
    start = torch.cumsum(ks, 0) - ks
    kmer = first[res] + torch.arange(res.shape[0], device=q.device) - start[res]
    c = res_colour.long()[res]
    ids = rows.long()[kmer]  # [(result, k-mer) pairs, h]
    if source == "cols":
        at = (ids[:, 0] // tile_rows * matrix.shape[1] + c) * matrix.element_size()
    else:
        if source == "slot":
            ids = ids[:, :1] // tile_rows * tile_rows + ids % tile_rows
        at = (ids * matrix.shape[1] + (c >> 5)[:, None]) * 4
    sectors = int(torch.unique(at // SECTOR).numel())
    size = int(plain.string_offsets(pos_off, res_query)[-1])
    return (sectors * SECTOR + nbytes(rows, kmer_off, pos_kmer, pos_off, res_query, res_colour)
            + (q.shape[0] + 1) * 8 + size)


def bound_ms(nbytes_moved: int) -> float:
    return nbytes_moved / HBM_BYTES_PER_S * 1e3


def record(kernel_ms: dict, name: str, ms: float, plain_ms: float, moved: int,
           library_ms: float | None = None) -> None:
    """Keep the first timing of kernel ``name`` for the kernels line."""
    kernel_ms.setdefault(name, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(moved),
                                "library_ms": library_ms})


# -- phase 1 ------------------------------------------------------------


def phase_device() -> str:
    import torch

    from bigsi_tpu_torch.scripts.timing import gpu_name_and_power

    gpu = gpu_name_and_power()
    print(gpu)
    print(
        "phase 1 device: %s (%d visible), torch %s, CUDA %s"
        % (torch.cuda.get_device_name(0), torch.cuda.device_count(),
           torch.__version__, torch.version.cuda),
        flush=True,
    )
    return gpu


# -- phase 2 ------------------------------------------------------------


def phase_build() -> None:
    """nvcc of the kernels and g++ of the port's host native library,
    started together; both must load from this checkout's build/."""
    from bigsi_tpu_torch import native
    from bigsi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    source = Path(SOURCE).name
    with ThreadPoolExecutor(max_workers=2) as pool:
        cuda = pool.submit(_build.load, source)
        host = pool.submit(native.available)
        cuda.result()
        check(host.result(), "the port's native library built and loaded")
    host_lib = _build.library_path(native.SOURCE, native.CXX_FLAGS)
    check(host_lib.parent == ROOT / "build" / "bigsi_tpu_torch" and host_lib.exists(),
          "the native library is the port's own build")
    print("phase 2 build: %s and %s ready in %.1f s"
          % (_build.library_path(source).relative_to(ROOT), host_lib.relative_to(ROOT),
             time.perf_counter() - t0), flush=True)


# -- phase 3 ------------------------------------------------------------


class Errors:
    """Largest |kernel - plain| seen per kernel; any nonzero fails."""

    def __init__(self):
        self.max = {name: 0 for name, _ in KERNELS}

    def compare(self, name, got, want, case):
        import torch

        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  "%s %s: shape/dtype %s %s vs %s %s"
                  % (name, case, g.shape, g.dtype, w.shape, w.dtype))
            err = 0
            if g.dim() == 0:  # a flag, such as kernel H's ok
                err = int(not torch.equal(g, w))
            elif not torch.equal(g, w):  # in row chunks: a full-size int64 copy is 12.8 GB
                step = max(1, (1 << 26) // max(1, g[0].numel()))
                err = max(int((g[i:i + step].long() - w[i:i + step].long()).abs().max())
                          for i in range(0, g.shape[0], step))
            self.max[name] = max(self.max[name], err)
            check(err == 0, "%s %s differs from its plain version by %d"
                  % (name, case, err))


def random_tile_inputs(gen, b, k, num_tiles, tile_rows, pad_frac, dev, mean_run=2, low_row=0):
    """Tile ids in runs of about ``mean_run`` k-mers (as the minimizer
    layout makes them) and 64-bit slot masks of H random rows in
    [low_row, tile_rows); a fraction of k-mers are padding (mask 0)."""
    import torch

    run_id = (torch.rand((b, k), generator=gen, device=dev) < 1.0 / mean_run).long().cumsum(1)
    per_run = torch.randint(0, num_tiles, (b, k + 1), generator=gen, device=dev, dtype=torch.int32)
    tile = per_run.gather(1, run_id).contiguous()
    slots = torch.randint(low_row, tile_rows, (b, k, H), generator=gen, device=dev)
    smask = (torch.ones_like(slots) << slots)
    smask = smask[..., 0] | smask[..., 1] | smask[..., 2]
    pad = torch.rand((b, k), generator=gen, device=dev) < pad_frac
    return tile, torch.where(pad, 0, smask).contiguous()


def random_grouped_inputs(gen, b, u, r, num_tiles, tile_rows, pad_frac, dev, low_row=0):
    """Grouped streams drawn directly: any U, padding slots (mask 0)."""
    import torch

    utile = torch.randint(0, num_tiles, (b, u), generator=gen, device=dev, dtype=torch.int32)
    _, gmask = random_tile_inputs(gen, b, u * r, num_tiles, tile_rows, pad_frac, dev,
                                  low_row=low_row)
    return utile, gmask.view(b, u, r).contiguous()


def phase_kernels(gen, errors: Errors) -> None:
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    dev = torch.device(DEVICE)
    cases = 0

    def classic(words, b, k, h, pad_frac, case, split=None):
        """Kernel A; with ``split`` True (False) it must (must not) have
        split the queries' k-mers over blocks."""
        m = words.shape[0]
        idx = torch.randint(0, m, (b, k, h), generator=gen, device=dev, dtype=torch.int32)
        mask = torch.rand((b, k), generator=gen, device=dev) >= pad_frac
        before = fl.classic_counts.split_launches
        got = fl.classic_counts(words, idx, mask)
        errors.compare("classic_counts", got, plain.batched_counts(words, idx, mask), case)
        if split is not None:
            check((fl.classic_counts.split_launches > before) == split,
                  "classic_counts %s: split over blocks %s" % (case, split))
        return got

    def tiled(words, b, k, tile_rows, pad_frac, case, low_row=0, both=False):
        """Kernel B; with ``both`` its counts-only build too."""
        tile, smask = random_tile_inputs(
            gen, b, k, words.shape[0] // tile_rows, tile_rows, pad_frac, dev, low_row=low_row)
        want = plain.blocked_counts(words, tile, smask, tile_rows)
        got = fl.tile_counts(words, tile, smask, tile_rows)
        errors.compare("tile_counts", got, want, case)
        if both:
            only = fl.tile_counts(words, tile, smask, tile_rows, False)
            errors.compare("tile_counts", only[:1], want[:1], "counts-only " + case)
        return got

    def grouped(words, cols, utile, gmask, tile_rows, case):
        """Kernel C over the row-major words and, with cols, kernel E."""
        want = plain.grouped_counts(words, utile, gmask, tile_rows)
        got = fl.grouped_tile_counts(words, utile, gmask, tile_rows)
        errors.compare("grouped_tile_counts", got, want, case)
        if cols is not None:
            n_valid = (gmask != 0).sum(dim=(1, 2), dtype=torch.int32)
            errors.compare("cols_counts", fl.cols_counts(cols, utile, gmask, n_valid),
                           plain.grouped_counts_cols(cols, utile, gmask, n_valid), case)
        return got

    def streams(words, b, k, tile_rows, r, pad_frac, mean_run=HEADLINE_RUN):
        tile, smask = random_tile_inputs(
            gen, b, k, words.shape[0] // tile_rows, tile_rows, pad_frac, dev, mean_run)
        return plain.build_grouped_streams(tile, smask, r)

    # the slice's shapes: the full-size matrix, B = 256, K = 512, h = 3
    words = torch.randint(-2**31, 2**31, (M, W), generator=gen, device=dev,
                          dtype=torch.int32)
    classic(words, B, 512, H, 0.05, "slice", split=False)
    # single queries and pairs: each query's k-mers split over blocks
    for b in (1, 2):
        for k in (512, 20_000):
            classic(words, b, k, H, 0.0 if b == 1 else 0.3, "B=%d K=%d" % (b, k), split=True)
            cases += 1
    tiled(words, B, 512, 32, 0.05, "slice")
    utile, gmask = streams(words, B, 512, 64, DEFAULT_R, 0.05, DEFAULT_RUN)
    grouped(words, None, utile, gmask, 64, "slice tile_rows=64 R=6 U=%d" % utile.shape[1])
    cases += 3
    # the cols indexes: tile_rows 16 at w = 19 and 32 at the default w = 11
    for tile_rows, r, mean_run in ((16, HEADLINE_R, HEADLINE_RUN), (32, DEFAULT_R, DEFAULT_RUN)):
        cols = fl.pack_tile_cols(words, tile_rows)
        errors.compare("pack_tile_cols", (cols,), (plain.pack_tile_cols(words, tile_rows),),
                       "slice tile_rows=%d" % tile_rows)
        utile, gmask = streams(words, B, 512, tile_rows, r, 0.05, mean_run)
        grouped(words, cols, utile, gmask, tile_rows,
                "slice tile_rows=%d R=%d U=%d" % (tile_rows, r, utile.shape[1]))
        del cols
        cases += 2
    del words
    # counts past 2^16 that carry into every plane of B's and C's
    # counters: all-ones words, so every count is the valid k-mers or
    # slots; then masks that select only rows 32-63 of 64-row tiles
    for w in (33, 64):
        ones = torch.full((64 * 3001, w), -1, dtype=torch.int32, device=dev)
        for tile_rows in (32, 64):
            counts, exact = tiled(ones, 2, 4096, tile_rows, 0.0, "all ones W=%d tile_rows=%d "
                                  "K=4096" % (w, tile_rows), both=True)
            check(bool((counts == 4096).all()) and bool((exact == -1).all()),
                  "kernel B counts every one of 4,096 k-mers")
            utile, gmask = random_grouped_inputs(gen, 1, 4000, 20, 3001 * 64 // tile_rows,
                                                 tile_rows, 0.0, dev)
            counts, _ = grouped(ones, None, utile, gmask, tile_rows,
                                "all ones W=%d tile_rows=%d U=4000 R=20" % (w, tile_rows))
            check(bool((counts == 80_000).all()), "kernel C counts every one of 80,000 slots")
            cases += 3
        # a 70 kb assembly as one query: kernel A's counts of 70,000 k-mers,
        # past 2^16, added over the split's blocks
        counts, exact = classic(ones, 1, 70_000, H, 0.0, "all ones W=%d B=1 K=70000" % w,
                                split=True)
        check(bool((counts == 70_000).all()) and bool((exact == -1).all()),
              "kernel A counts every one of 70,000 k-mers")
        cases += 1
        words = torch.randint(-2**31, 2**31, (64 * 3001, w), generator=gen, device=dev,
                              dtype=torch.int32)
        case = "rows 32-63 W=%d tile_rows=64" % w
        tiled(words, 5, 700, 64, 0.2, case, low_row=32, both=True)
        for r in (6, 20):
            utile, gmask = random_grouped_inputs(gen, 3, 50, r, 3001, 64, 0.2, dev, low_row=32)
            grouped(words, None, utile, gmask, 64, "%s U=50 R=%d" % (case, r))
        cases += 4
        del ones, words
    # ragged shapes
    for w in (1, 33, 64):
        for tile_rows in (8, 16, 32, 64):
            words = torch.randint(-2**31, 2**31, (tile_rows * 3001, w),
                                  generator=gen, device=dev, dtype=torch.int32)
            num_tiles = words.shape[0] // tile_rows
            cols = None
            if tile_rows <= 32:
                cols = fl.pack_tile_cols(words, tile_rows)
                errors.compare("pack_tile_cols", (cols,),
                               (plain.pack_tile_cols(words, tile_rows),),
                               "W=%d tile_rows=%d" % (w, tile_rows))
                cases += 1
            for b, k, pad in ((5, 700, 0.3), (3, 0, 0.0), (2, 64, 1.0), (2, 3000, 0.1)):
                case = "W=%d tile_rows=%d B=%d K=%d pad=%.1f" % (w, tile_rows, b, k, pad)
                tiled(words, b, k, tile_rows, pad, case)
                for r in (1, 6, 20):
                    utile, gmask = streams(words, b, k, tile_rows, r, pad)
                    grouped(words, cols, utile, gmask, tile_rows, "%s R=%d" % (case, r))
                cases += 4
            # U = 4,000 at R = 20: 80,000 live slots, past a 16-bit
            # field counter, in 42 of kernel E's staged chunks
            for b, u, r, pad in ((5, 13, 6, 0.3), (3, 37, 20, 0.1), (4, 7, 1, 0.0),
                                 (2, 21, 6, 1.0), (0, 16, 6, 0.0), (1, 4000, 20, 0.0)):
                utile, gmask = random_grouped_inputs(gen, b, u, r, num_tiles, tile_rows, pad, dev)
                grouped(words, cols, utile, gmask, tile_rows,
                        "W=%d tile_rows=%d B=%d U=%d R=%d pad=%.1f" % (w, tile_rows, b, u, r, pad))
                cases += 1
            if tile_rows == 32:
                # h 5 and 8 read rows past the 4 read ahead; B = 1 and 2
                # split, all-padding ones too
                for b, k, h, pad in ((5, 700, 3, 0.3), (1, 1, 1, 0.0), (3, 0, 3, 0.0),
                                     (2, 64, 3, 1.0), (2, 3000, 3, 0.1), (4, 200, 1, 0.5),
                                     (3, 300, 5, 0.5), (2, 1000, 8, 0.2), (1, 5000, 5, 0.0),
                                     (1, 3000, 8, 0.5), (1, 2000, 3, 1.0), (1, 0, 3, 0.0)):
                    case = "W=%d B=%d K=%d h=%d pad=%.1f" % (w, b, k, h, pad)
                    classic(words, b, k, h, pad, case)
                    cases += 1
    cases += pack_checks(gen, errors)
    cases += presence_checks(gen, errors)
    cases += strings_checks(np.random.default_rng(int(torch.randint(
        0, 2**31, (1,), generator=gen, device=DEVICE))), errors)
    torch.cuda.synchronize()
    print("phase 3 kernels: kernels A-E and L (both forms) bit-exact with their plain versions in %d "
          "cases (slice shapes W=%d m=%d B=%d K=512 h=%d; A at B 1 and 2, K 512 and 20,000 "
          "split over blocks, at all-ones B=1 K=70,000 (counts past 2^16), h 1/3/5/8, "
          "half- and all-padding, K=0; grouped streams of runs of ~%d "
          "k-mers at R=%d and ~%d at R=%d, D and E at tile_rows 16 and 32; all-ones words "
          "at W 33/64 with B's counts of 4,096 (both builds) and C's of 80,000 (U=4,000 "
          "R=20), masks of rows 32-63 only; ragged W 1/33/64, tile_rows 8/16/32/64 (E on "
          "uint8, int16 and int32 cols), R 1/6/20, U 7/13/21/37 and 4,000 at R=20 (80,000 "
          "live slots), all-padding queries, B or K of 0; D at tile_rows 1/5/8/12/16/31/32, "
          "W 1/33/64, T 1, 3,001 and 100,003, misaligned words and cols, and packed in odd "
          "chunks into slices of one cols; L at W 1/33/64, K 1/37/300, classic h 1/3/8, slot "
          "at tile_rows 8/16/32/64 and cols of uint8/int16/int32, masks of 0, of many rows and "
          "of rows 32-63 alone, whole and in two row slabs with their tile windows; L's strings "
          "form at W 1/33/64, Q 1/7/256, K 1/37/300, duplicate positions, results in the last "
          "word beside phantom samples and in any order, classic h 1/3/8, slot at tile_rows "
          "8/16/32/64 (slots in rows 32-63), cols of uint8/int16/int32, a 20 kb query)"
          % (cases, W, M, B, H, HEADLINE_RUN, HEADLINE_R, DEFAULT_RUN, DEFAULT_R), flush=True)


def presence_checks(gen, errors: Errors) -> int:
    """Kernel L against its plain version at ragged shapes: W 1, 33 and
    64; K 1, 37 and 300 (not a multiple of a block's 32 k-mers); classic
    at h 1, 3 and 8 (past the 4 rows read ahead); slot at tile_rows 8,
    16, 32 and 64 and cols at 8, 16 and 32 (uint8, int16 and int32), with
    random masks of many rows, masks of 0 (all ones) and at 64 of rows
    32-63 alone; each tiled case whole and as two row slabs with their
    tile windows, whose rows must OR to the whole's.  -> the cases."""
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    def one(case, matrix, source, idx, smask=None, tile_rows=1, window=None):
        got = fl.presence_rows(matrix, source, idx, smask, tile_rows, window)
        errors.compare(PRESENCE, (got,), (plain.presence_rows(matrix, source, idx, smask,
                                                              tile_rows, window),), case)
        return got

    def slabs(case, matrix, source, tile, smask, tile_rows, tiles):
        """The whole, then two slabs of it: -> 3 cases."""
        whole = one(case, matrix, source, tile, smask, tile_rows)
        joined, r = torch.zeros_like(whole), 1 if source == "cols" else tile_rows
        for q, (t0, t1) in enumerate(((0, tiles // 2), (tiles // 2, tiles))):
            joined |= one("%s slab %d" % (case, q), matrix[t0 * r: t1 * r], source, tile, smask,
                          tile_rows, (t0, t1))
        check(torch.equal(joined, whole), "L's slabs OR to the whole: %s" % case)
        return 3

    cases, m = 0, 64 * 97
    for w in (1, 33, 64):
        words = torch.randint(-2**31, 2**31, (m, w), generator=gen, device=DEVICE,
                              dtype=torch.int32)
        for k in (1, 37, 300):
            for h in (1, 3, 8):
                rows = torch.randint(0, m, (k, h), generator=gen, device=DEVICE, dtype=torch.int32)
                one("classic W=%d K=%d h=%d" % (w, k, h), words, "classic", rows)
                cases += 1
            for tr in (8, 16, 32, 64):
                tiles = m // tr
                tile = torch.randint(0, tiles, (k,), generator=gen, device=DEVICE,
                                     dtype=torch.int32)
                smask = torch.randint(-2**63, 2**63 - 1, (k,), generator=gen, device=DEVICE)
                if tr < 64:
                    smask &= (1 << tr) - 1
                else:
                    smask[1::5] &= ~0xFFFFFFFF  # rows 32-63 alone
                smask[::5] = 0
                case = "W=%d K=%d tile_rows=%d" % (w, k, tr)
                cases += slabs("slot " + case, words, "slot", tile, smask, tr, tiles)
                if tr <= 32:
                    cols = fl.pack_tile_cols(words, tr)
                    cases += slabs("cols " + case, cols, "cols", tile, smask, tr, tiles)
    return cases


def strings_batch(rng, w: int, q: int, k: int, tiled: int, h: int = H):
    """Q random queries of up to K distinct k-mers (the first exactly K)
    over an m = 64 * 97 row matrix of W words: row ids int32[sum K, h]
    (``tiled`` > 0: in one tile of that many rows, half the queries' slots
    in rows 32-63 at 64), each query's positions visiting every k-mer and
    a third of them again, and 0-3 results a query in a shuffled order,
    every third query's last sample (past which the last word holds
    phantom samples) among them.  -> the strings form's arguments after
    the matrix and source, on the card."""
    import torch

    m, n = 64 * 97, 32 * w - (12 if w == 1 else 5)
    rows, ko, pos, po, rq, rc = [], [0], [], [0], [], []
    for i in range(q):
        ki = k if i == 0 else int(rng.integers(1, k + 1))
        if tiled:
            low = 32 if tiled == 64 and i % 2 else 0
            rows.append(rng.integers(0, m // tiled, size=(ki, 1)) * tiled
                        + rng.integers(low, tiled, size=(ki, h)))
        else:
            rows.append(rng.integers(0, m, size=(ki, h)))
        p = rng.permutation(np.concatenate([np.arange(ki), rng.integers(0, ki, ki // 3 + 1)]))
        pos.append(p)
        ko.append(ko[-1] + ki)
        po.append(po[-1] + p.size)
        colours = list(rng.choice(n, size=int(rng.integers(0, 4)), replace=False))
        if i % 3 == 0 and n - 1 not in colours:
            colours.append(n - 1)
        rq += [i] * len(colours)
        rc += colours
    order = rng.permutation(len(rq))
    dev = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(DEVICE)
           for a in (np.concatenate(rows), ko, np.concatenate(pos), po, np.array(rq)[order],
                     np.array(rc)[order])]
    return dev


def strings_checks(rng, errors: Errors) -> int:
    """Kernel L's strings form against its plain version at ragged
    shapes: W 1, 33 and 64, Q 1, 7 and 256 queries of up to K 1, 37 and
    300 distinct k-mers (:func:`strings_batch`: duplicate positions,
    results in any order, in the last word beside phantom samples);
    classic at h 1, 3 and 8, slot at tile_rows 8, 16, 32 and 64, cols of
    uint8, int16 and int32; then one 20 kb query (19,970 distinct k-mers)
    on the classic and the int16 cols source.  Each case gives the
    wrapper the plain version's offsets and an output filled with 0xEE
    first.  -> the cases."""
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    def one(case, matrix, source, args, tile_rows=1):
        want = plain.presence_strings(matrix, source, *args, tile_rows)
        out = torch.full_like(want[0], 0xEE)
        got = fl.presence_strings(matrix, source, *args, tile_rows, res_off=want[1].clone(),
                                  out=out)
        errors.compare(STRINGS, got, want, case)
        return 1

    cases, m = 0, 64 * 97
    sources = [("slot", tr) for tr in (8, 16, 32, 64)] + [("cols", tr) for tr in (8, 16, 32)]
    for w in (1, 33, 64):
        words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(m, w), dtype=np.int32)).to(
            DEVICE)
        cols = {tr: fl.pack_tile_cols(words, tr) for tr in (8, 16, 32)}
        for q in (1, 7, 256):
            for k in (1, 37, 300):
                case = "W=%d Q=%d K=%d" % (w, q, k)
                h = (1, 3, 8)[cases % 3]
                args = strings_batch(rng, w, q, k, 0, h)
                cases += one("classic %s h=%d" % (case, h), words, "classic", args)
                for source, tr in sources:
                    args = strings_batch(rng, w, q, k, tr)
                    matrix = cols[tr] if source == "cols" else words
                    cases += one("%s %s tile_rows=%d" % (source, case, tr), matrix, source, args,
                                 tr)
        del cols
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(m, W), dtype=np.int32)).to(DEVICE)
    args = strings_batch(rng, W, 1, 20_000 - K_LEN + 1, 0)
    cases += one("classic 20 kb", words, "classic", args)
    args = strings_batch(rng, W, 1, 20_000 - K_LEN + 1, 16)
    cases += one("cols 20 kb tile_rows=16", fl.pack_tile_cols(words, 16), "cols", args, 16)
    return cases


PACK_TILES = (1, 3001, 100_003)  # kernel D's tile counts in phase 3


def pack_checks(gen, errors: Errors) -> int:
    """Kernel D against its plain version beyond the slice's shapes:
    tile_rows 8, 16 and 32 (the compile-time builds) and 1, 5, 12 and 31
    (the generic one), W 1, 33 and 64, one tile, 3,001 tiles and 100,003
    (neither a multiple of the persistent grid's step), words and cols
    off the vector alignment (the generic build), and a pack in chunks
    of 7 tiles into slices of one cols equal to the whole pack; -> the
    number of cases."""
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    dev = torch.device(DEVICE)
    cases = 0

    def rand_words(m, w):
        return torch.randint(-2**31, 2**31, (m, w), generator=gen, device=dev, dtype=torch.int32)

    def pack(words, tile_rows, case, out=None):
        nonlocal cases
        got = fl.pack_tile_cols(words, tile_rows, out=out)
        errors.compare("pack_tile_cols", (got,), (plain.pack_tile_cols(words, tile_rows),), case)
        cases += 1
        return got

    for w in (1, 33, 64):
        for tile_rows in (1, 5, 8, 12, 16, 31, 32):
            tiles = PACK_TILES if tile_rows in (8, 16, 32) and w > 1 else PACK_TILES[:2]
            for t in tiles:
                pack(rand_words(t * tile_rows, w), tile_rows,
                     "W=%d tile_rows=%d T=%d" % (w, tile_rows, t))
    for tile_rows in (8, 16, 32):
        words = rand_words(3001 * tile_rows, 64)
        whole = pack(words, tile_rows, "W=64 tile_rows=%d T=3001 whole" % tile_rows)
        cols = torch.zeros_like(whole)
        for t0 in range(0, 3001, 7):
            t1 = min(3001, t0 + 7)
            fl.pack_tile_cols(words[t0 * tile_rows:t1 * tile_rows], tile_rows, out=cols[t0:t1])
        check(torch.equal(cols, whole), "kernel D in chunks of 7 tiles equals the whole pack "
              "at tile_rows %d" % tile_rows)
        cases += 1
        # 4 bytes off 16-byte alignment: words, then cols
        flat = rand_words(3001 * tile_rows * 64 + 1, 1).view(-1)
        pack(flat[1:].view(-1, 64), tile_rows, "tile_rows=%d misaligned words" % tile_rows)
        buf = torch.zeros(whole.numel() + 16, dtype=whole.dtype, device=dev)
        out = buf[16 // whole.element_size() - 1:][:whole.numel()].view(whole.shape)
        check(out.data_ptr() % 16 != 0, "the cols view is off 16-byte alignment")
        got = pack(words, tile_rows, "tile_rows=%d misaligned cols" % tile_rows, out=out)
        check(got.data_ptr() == out.data_ptr() and torch.equal(out, whole),
              "kernel D into misaligned cols at tile_rows %d" % tile_rows)
    return cases


def acgt(rng, shape) -> np.ndarray:
    return np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=shape)]


def revcomp(row: np.ndarray) -> np.ndarray:
    return np.frombuffer(bytes(row[::-1]).translate(bytes.maketrans(b"ACGT", b"TGCA")),
                         dtype=np.uint8)


def seq_cases(rng):
    """Kernel H's cases: (name, seqs uint8[B, L], lens int32[B], prep
    arguments).  The slice's shapes (B queries of QUERY_LEN bytes padded
    to 576, both cols configs, the engine's safe and tight budgets) and
    ragged ones; padding bytes are random bytes."""
    from bigsi_tpu_torch.index.device_engine import DeviceEngine

    def kw(k=K_LEN, window=19, tile_rows=16, r=HEADLINE_R, num_tiles=M // 16, u_cap=None, h=H):
        nk = 576 - k + 1
        return dict(k=k, s=k - window + 1, num_tiles=num_tiles, h=h, tile_rows=tile_rows, r=r,
                    u_cap=DeviceEngine._seq_u_cap(nk, window) if u_cap is None else u_cap)

    def batch(b, l, lens, fill=None):
        seqs = acgt(rng, (b, l)) if fill is None else np.full((b, l), ord(fill), np.uint8)
        lens = np.broadcast_to(np.asarray(lens, dtype=np.int32), (b,)).copy()
        for q in range(b):  # bytes past lens are arbitrary padding
            seqs[q, max(0, lens[q]):] = rng.integers(0, 256, size=l - max(0, lens[q]))
        return seqs, lens

    cases = []
    for tile_rows, window, r in ((16, 19, HEADLINE_R), (32, 11, DEFAULT_R)):
        arg = kw(window=window, tile_rows=tile_rows, r=r, num_tiles=M // tile_rows)
        seqs, lens = batch(B, 576, QUERY_LEN)
        seqs[:, QUERY_LEN:] = ord("A")  # as seq_batch_geometry pads
        tight = DeviceEngine._seq_u_tight(576 - K_LEN + 1, window)
        for u_cap in (arg["u_cap"], tight):
            cases.append(("slice B=%d L=576 tile_rows=%d w=%d U=%d" % (B, tile_rows, window, u_cap),
                          seqs, lens, dict(arg, u_cap=u_cap)))
    cases.append(("B=1", *batch(1, 576, 560), kw()))
    cases.append(("lens 0, 20, 31, 32 and 576", *batch(5, 576, [0, 20, 31, 32, 576]), kw()))
    poly_t = batch(4, 128, [128, 100, 32, 31], fill="T")
    poly_t[0][1, :20] = ord("A")
    cases.append(("k=32 poly-T", *poly_t, kw(k=32, window=11, u_cap=40)))
    cases.append(("k=15", *batch(6, 256, [256, 255, 100, 15, 14, 0]), kw(k=15, window=11,
                                                                           u_cap=64)))
    seqs, lens = batch(2, 3264, [3264, 3200])
    seqs[0, 200:320] = seqs[0, 10:130]  # a repeat 190 bytes after its first occurrence
    seqs[0, 3000:3120] = seqs[0, 10:130]  # and one about 3 kb after
    cases.append(("planted repeats", seqs, lens, kw(u_cap=400)))
    seqs, lens = batch(3, 576, [400, 576, 350])
    seqs[0, 200:400] = revcomp(seqs[0, :200])  # a query next to its reverse complement
    cases.append(("reverse complement", seqs, lens, kw()))
    cases.append(("num_tiles 2^20", *batch(16, 576, 542), kw(num_tiles=1 << 20)))
    cases.append(("num_tiles 1", *batch(3, 100, 100), kw(num_tiles=1, u_cap=8)))
    cases.append(("overflow U=3", *batch(16, 576, 542), kw(u_cap=3)))
    cases.append(("overflow U=0", *batch(4, 576, [542, 0, 20, 300]), kw(u_cap=0)))
    cases.append(("lb=4096 B=8", *batch(8, 4096, [4096, 4095, 4000, 3000, 2048, 31, 0, 4096]),
                  kw(u_cap=DeviceEngine._seq_u_cap(4096 - K_LEN + 1, 19))))
    cases.append(("h=10 tile_rows 32 r=1", *batch(8, 192, 192), kw(h=10, tile_rows=32, r=1,
                                                                     u_cap=162)))
    # the dedup table's hazards: the codes 0 and 2^64 - 1 (no code can mark
    # an empty slot), one code at every position, many copies of few codes
    poly = np.full((2, 576), ord("A"), np.uint8)
    poly[1] = ord("T")
    cases.append(("k=32 poly-A and poly-T whole", poly, np.full(2, 576, np.int32),
                  kw(k=32, window=11, u_cap=64)))
    seqs = np.tile(acgt(rng, 40), 15)[None, :576].repeat(4, axis=0)
    cases.append(("one 40-mer repeated to L=576", seqs, np.full(4, 576, np.int32), kw()))
    seqs, lens = batch(1, 576, QUERY_LEN)
    seqs[:, QUERY_LEN:] = ord("A")
    cases.append(("%d identical queries" % B, seqs.repeat(B, axis=0), lens.repeat(B), kw()))
    for b in (8, 1):
        cases.append(("L=4096 random B=%d" % b, *batch(b, 4096, 4096),
                      kw(u_cap=DeviceEngine._seq_u_cap(4096 - K_LEN + 1, 19))))
    cases.append(("lens 0, k-1 and k", *batch(3, 576, [0, K_LEN - 1, K_LEN]), kw()))
    return cases


def seq_checks(gen, rng, errors: Errors) -> None:
    """Kernel H bit for bit against prep_streams on every case of
    seq_cases: utile, gmask, n_valid and ok; then kernel E against its
    plain version on each case's streams (the overflowed ones included)
    over random cols of the case's tiles."""
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain
    from bigsi_tpu_torch.ops import prep

    dev = torch.device(DEVICE)
    oks, streams = [], {}
    for case, seqs, lens, kw in seq_cases(rng):
        args = (torch.from_numpy(seqs).to(dev), torch.from_numpy(lens).to(dev))
        got, want = fl.seq_streams(*args, **kw), prep.prep_streams(*args, **kw)
        errors.compare("seq_streams", got[:3], want[:3], case)
        check(bool(got[3]) == bool(want[3]), "seq_streams %s: ok %s, plain %s"
              % (case, bool(got[3]), bool(want[3])))
        oks.append(bool(want[3]))
        streams.setdefault((kw["num_tiles"], kw["tile_rows"]), []).append((case, got[:3]))
    check(not all(oks) and any(oks), "the cases include overflow and none")
    for (num_tiles, tile_rows), items in sorted(streams.items()):
        dtype = plain.cols_dtype(tile_rows)
        info = torch.iinfo(dtype)
        cols = torch.randint(info.min, info.max + 1, (num_tiles, N), generator=gen, device=dev,
                             dtype=dtype)
        for case, h_streams in items:
            errors.compare("cols_counts", fl.cols_counts(cols, *h_streams),
                           plain.grouped_counts_cols(cols, *h_streams), "H streams " + case)
        del cols
    torch.cuda.synchronize()
    print("phase 3 kernels: seq_streams (kernel H) bit-exact with prep_streams on utile, "
          "gmask, n_valid and ok in %d cases (%d overflow): slice B=%d L=576 at both cols "
          "configs and budgets; B=1, lens 0 / below k / k, k=32 poly-T, k=15, planted repeats "
          "190 B and 3 kb apart, a query beside its reverse complement, num_tiles 2^20 and 1, "
          "U of 3 and 0, lb=4096 B=8, h=10, k=32 poly-A and poly-T whole, a 40-mer repeated, "
          "%d identical queries, L=4096 random at B 8 and 1, lens 0 / k-1 / k; cols_counts "
          "(kernel E) bit-exact on the streams "
          "of all %d, over random cols of each case's tiles"
          % (len(oks), oks.count(False), B, B, len(oks)), flush=True)


HITS_B, HITS_N = 256, 8192  # the benchmark cells' batch and samples (kernel M's shape)


def hits_cases(gen):
    """Kernel M's cases: (name, counts int32[B, N] view, n_valid, threshold,
    cap), mostly at B = 256, N = 8,192 as the benchmark's cells give it:
    counts well under each query's least count but 4 samples at n_valid
    and 2 at 0.8 of it, 1 query in 16 of no k-mer, rows 32 samples apart
    (the engine's counts[:, :num_cols] view); then every sample a hit
    (min_kmers 0) and uniform counts at 1/3, both past the room, no hit
    at all, one query, and ragged N."""
    import torch

    from bigsi_tpu_torch.index.device_engine import HITS_PER_QUERY

    dev = torch.device(DEVICE)

    def batch(b, n):
        nv = torch.randint(1, 3000, (b,), generator=gen, device=dev, dtype=torch.int32)
        nv[1::16] = 0
        wide = torch.zeros((b, n + 32), dtype=torch.int32, device=dev)
        low = torch.rand((b, n), generator=gen, device=dev) * nv[:, None].float() * 0.3
        wide[:, :n] = low.int()
        rows = torch.arange(b, device=dev)
        for j, share in ((0, 1.0), (1, 1.0), (2, 1.0), (3, 1.0), (4, 0.8), (5, 0.8)):
            col = torch.randint(0, n, (b,), generator=gen, device=dev)
            wide[rows, col] = (nv.double() * share).ceil().int()
        return wide[:, :n], nv

    b, n = HITS_B, HITS_N
    cap = b * HITS_PER_QUERY
    counts, nv = batch(b, n)
    uniform = (torch.rand((b, n), generator=gen, device=dev) * (nv[:, None].float() + 1)).int()
    one, nv1 = batch(1, n)
    ragged, nvr = batch(37, 33)
    return [
        ("B=256 N=8192 t=1.0", counts, nv, 1.0, cap),
        ("B=256 N=8192 t=0.7", counts, nv, 0.7, cap),
        ("B=256 N=8192 t=0.7 contiguous", counts.contiguous(), nv, 0.7, cap),
        ("B=256 N=8192 min_kmers 0 (every sample, past the room)", counts, nv, 0.0, cap),
        ("B=256 N=8192 uniform t=1/3 (past the room)", uniform, nv, 1 / 3, cap),
        ("B=256 N=8192 no hit", torch.zeros_like(uniform), nv, 0.7, cap),
        ("B=1 N=8192 t=0.7", one, nv1, 0.7, min(n, HITS_PER_QUERY)),
        ("B=37 N=33 t=0.7", ragged, nvr, 0.7, 37 * 33),
    ]


def hits_same(got, want_rec, counts, n_valid, threshold, cap, case) -> int:
    """Kernel M's record against the plain version's: the total, n_valid
    and each query's hits; within the room every query's segment (read
    from its own start), past it each segment the kernel wrote against
    the plain version's over all the hits.  -> the total."""
    from bigsi_tpu_torch.index.device_engine import decode_hits
    from bigsi_tpu_torch.ops import lookup as plain

    b = counts.shape[0]
    g, w = got.cpu().numpy(), want_rec.cpu().numpy()
    check(np.array_equal(g[: 1 + b], w[: 1 + b]) and np.array_equal(
        g[1 + 2 * b : 1 + 3 * b], w[1 + 2 * b : 1 + 3 * b]),
        "hits_compact %s: total, n_valid and hits a query equal the plain version's" % case)
    total = int(w[0])
    if total <= cap:
        for a, e in zip(decode_hits(g, b, cap), decode_hits(w, b, cap)):
            check(np.array_equal(a, e), "hits_compact %s: the hits equal the plain version's"
                  % case)
        return total
    full = plain.hits_compact(counts, n_valid, threshold, total).cpu().numpy()
    want = decode_hits(full, b, total)
    head = plain.hits_head(b)
    start, cnt = g[1 + b : 1 + 2 * b], g[1 + 2 * b : 1 + 3 * b]
    written = 0
    for q in range(b):
        if cnt[q] and start[q] + cnt[q] <= cap:
            seg = g[head + 2 * start[q] : head + 2 * (start[q] + cnt[q])].reshape(-1, 2)
            lo, hi = want.off[q], want.off[q + 1]
            check(np.array_equal(seg[:, 0], want.colours[lo:hi])
                  and np.array_equal(seg[:, 1], want.found[lo:hi]),
                  "hits_compact %s: a segment written past the room is its query's" % case)
            written += int(cnt[q])
    check(0 < written <= cap, "hits_compact %s: segments within the room written (%d)"
          % (case, written))
    return total


def phase_hits(gpu: str, gen) -> dict:
    """Kernel M (hits_compact) against its plain version on hits_cases,
    then timed at B = 256, N = 8,192, t = 0.7: warm (the counts in L2, as
    kernels A and E leave them) and cold, beside its bound, its plain
    version and torch.nonzero's threshold; and on the host's clock the
    engine's counts back both ways, the dense copy with the host's
    threshold against the hits record (DeviceEngine._hits).  -> its row
    for the kernels line."""
    import types

    import torch

    from bigsi_tpu_torch.index.device_engine import DeviceEngine, counts_to_host, dense_hits
    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain
    from bigsi_tpu_torch.scripts.timing import cuda_ms

    fl.hits_compact.launches = 0
    totals = []
    cases = hits_cases(gen)
    for case, counts, nv, t, cap in cases:
        got = fl.hits_compact(counts, nv, t, cap)
        want = plain.hits_compact(counts, nv, t, cap)
        torch.cuda.synchronize()
        totals.append(hits_same(got, want, counts, nv, t, cap, case))
    check(fl.hits_compact.launches == len(cases), "one launch a case")
    case, counts, nv, t, cap = cases[2]  # the engine's counts[:, :num_cols] at N = W * 32
    b, n = counts.shape

    def kernel():
        fl.hits_compact(counts, nv, t, cap)

    # warm: back to back behind a spin that outlasts their enqueue, so the
    # events time the device alone, the counts in L2 after the first
    reps = 200
    kernel()
    torch.cuda._sleep(SPIN_CYCLES)
    spun = torch.cuda.Event()
    spun.record()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        kernel()
    end.record()
    check(not spun.query(), "the spin outlasted the launches' enqueue")
    end.synchronize()
    warm = start.elapsed_time(end) / reps
    cold = cuda_ms(kernel, 20, DEVICE)
    plain_ms = cuda_ms(lambda: plain.hits_compact(counts, nv, t, cap), 5, DEVICE)
    mins = plain.min_kmers(nv, t)
    library_ms = cuda_ms(lambda: torch.nonzero(counts >= mins[:, None]), 20, DEVICE)
    moved = b * n * 4 + b * 4 + (plain.hits_head(b) + 2 * totals[1]) * 4
    engine = types.SimpleNamespace(_hits_host=threading.local())

    def host_ms(fn, calls=50):
        times = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[calls // 2]

    nv_host = nv.cpu().numpy()
    dense = host_ms(lambda: dense_hits(counts_to_host(counts), nv_host, t))
    hits = host_ms(lambda: DeviceEngine._hits(engine, counts, nv, t))
    row = {"ms": cold, "warm_ms": warm, "plain_ms": plain_ms, "bound_ms": bound_ms(moved),
           "library_ms": library_ms, "host_dense_ms": dense, "host_hits_ms": hits}
    print("phase 3 hits: hits_compact (kernel M) equal to its plain version in %d cases "
          "(totals %s; room %d at B=256: %d past it); at %s: %.4f ms cold, %.4f ms warm "
          "(counts in L2), bound %.4f ms (%.1f MB at 3.35 TB/s), plain %.4f ms, "
          "torch.nonzero %.4f ms; the engine's counts back, host clock median of 50: dense "
          "copy + host threshold %.3f ms, hits record %.3f ms  [%s]"
          % (len(cases), totals, cap, sum(x > cap for x in totals[:6]), case, cold, warm,
             bound_ms(moved), moved / 1e6, plain_ms, library_ms, dense, hits, gpu), flush=True)
    print(json.dumps({"hits_compact": row}), flush=True)
    return row


MUTATION_M = 1 << 20  # bloom bits of the mutation check's small indexes
MUTATION_INDEXES = ("blocked/32", "minimizer/64")


def phase_mutation(rng) -> None:
    """The engine follows an in-process merge and an interior insert: on
    small indexes of blocked/32 (kernel B) and minimizer/64 (kernel C),
    8 samples merged with 4 more, then colour 2 overwritten by a new
    sample's bloom; after each, the port's engine is a new one, its
    search and search_batch results equal the numpy host engine's opened
    on the store afterwards, and each index launched its own kernel and
    no other."""
    from bigsi_tpu_torch import BIGSI
    from bigsi_tpu_torch.kmers import seq_to_kmers
    from bigsi_tpu_torch.storage import get_storage

    fns = kernel_fns()
    compared = 0
    for name in MUTATION_INDEXES:
        configs = [{"storage-engine": "memory",
                    "storage-config": {"filename": "chip-smoke-mutation-%d-%s"
                                       % (i, name.replace("/", "-"))},
                    "k": K_LEN, "m": MUTATION_M, "h": H, **INDEXES[name][0]} for i in range(2)]
        for config in configs:
            get_storage(config).delete_all()
        genomes = [random_seq(rng, 1000) for _ in range(12)]
        names = ["s%d" % i for i in range(12)]

        def bloom(seq):
            return BIGSI.bloom(configs[0], seq_to_kmers(seq, K_LEN))

        def same(what, queries):
            nonlocal compared
            host = BIGSI(dict(configs[0], engine="numpy"))
            for t in (1.0, 0.7):
                check(port.search_batch(queries, t) == host.search_batch(queries, t)
                      and all(port.search(q, t) == host.search(q, t) for q in queries[:4]),
                      "%s after %s: results equal the host engine's at %.1f" % (name, what, t))
                compared += len(queries) + 4

        for fn in fns.values():
            fn.launches = 0
        port = BIGSI.build(configs[0], [bloom(g) for g in genomes[:8]], names[:8], device=DEVICE)
        other = BIGSI.build(configs[1], [bloom(g) for g in genomes[8:]], names[8:], device=DEVICE)
        before = port.engine
        port.merge(other)
        check(port.engine is not before and port.num_samples == 12,
              "%s: merge rebuilt the engine over 12 samples" % name)
        queries = [g[:400] for g in genomes] + [mutate(rng, g[100:600], 5) for g in genomes]
        same("merge", queries)
        check({r["sample_name"] for r in port.search(genomes[10][:400], 1.0)} >= {"s10"},
              "%s: a merged sample is found" % name)
        new = random_seq(rng, 1000)
        before = port.engine
        port.insert_bloom(bloom(new), 2)
        check(port.side is None and port.engine is not before,
              "%s: the interior insert rebuilt the engine" % name)
        same("an interior insert", [new[:400], mutate(rng, new[:500], 5)] + queries)
        check("s2" in {r["sample_name"] for r in port.search(new[:400], 1.0)},
              "%s: the inserted sample is found under colour 2" % name)
        counted = {k: fn.launches for k, fn in fns.items()}
        own = tuple(k for k in INDEXES[name][1] if k != STRINGS)  # no scored search here
        check(all(counted[k] > 0 for k in own) and
              not any(n for k, n in counted.items() if k not in own),
              "%s mutation launched its kernels %s and no other: %s" % (name, own, counted))
        del port, other, before
        for config in configs:
            get_storage(config).delete_all()
    print("phase 3 mutation: merge and interior insert on %s at m=%d rebuilt the engine; %d "
          "result lists equal the host engine's" % (", ".join(MUTATION_INDEXES), MUTATION_M,
                                                    compared), flush=True)


# -- phases 4-9 ---------------------------------------------------------


def random_seq(rng, n: int) -> str:
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def mutate(rng, seq: str, snps: int) -> str:
    out = list(seq)
    for pos in rng.choice(len(seq), size=snps, replace=False):
        out[pos] = "ACGT"[("ACGT".index(out[pos]) + 1 + rng.integers(0, 3)) % 4]
    return "".join(out)


def sample_names() -> list[str]:
    return ["planted%d" % i for i in range(PLANTED)] + ["synth%d" % i for i in range(PLANTED, N)]


def make_index(name: str, gen, rng) -> tuple[dict, list[str]]:
    """An in-memory index of N samples: random rows drawn on the card at
    the density of a bloom of KMERS_PER_SAMPLE k-mers, with the planted
    samples' blooms in columns 0..PLANTED-1 (a verified index: rows.bin
    and screen.bin, each with its half of the blooms).  Returns its
    config and the planted sequences."""
    from bigsi_tpu_torch.synth import bloom_density, synth_index

    config = {
        "storage-engine": "memory",
        "storage-config": {"filename": "chip-smoke-" + name.replace("/", "-")},
        "k": K_LEN, "m": M, "h": H, **INDEXES[name][0],
    }
    planted = [random_seq(rng, PLANTED_LEN) for _ in range(PLANTED)]
    synth_index(config, sample_names(), planted, bloom_density(H, KMERS_PER_SAMPLE, M), gen)
    return config, planted


def classic_twin(config: dict):
    """Oracle (b) of the verified index: the port's facade on the numpy
    host engine over an in-memory classic index of the same samples that
    holds the verified index's rows.bin (the same matrix, not a copy)."""
    from bigsi_tpu_torch import BIGSI
    from bigsi_tpu_torch.graph.metadata import SampleMetadata
    from bigsi_tpu_torch.index.signature import persist_index_params
    from bigsi_tpu_torch.storage import get_storage

    twin = {k: v for k, v in config.items() if k != "screen"}
    twin["storage-config"] = {"filename": config["storage-config"]["filename"] + "-classic"}
    store = get_storage(twin)
    store.delete_all()
    persist_index_params(store.kv, M, H)
    SampleMetadata(store.kv).add_samples(sample_names())
    store.save_matrix(get_storage(config).load_matrix())
    return BIGSI(dict(twin, engine="numpy"))


def make_queries(rng, planted) -> list[str]:
    """B queries: planted substrings as they are (exact hits), with 3
    SNPs (inexact hits at 0.7) and with 12 SNPs, and random sequences."""
    seqs = []
    for i in range(B):
        kind, p = i % 4, planted[(i // 4) % PLANTED]
        if kind == 3:
            seqs.append(random_seq(rng, QUERY_LEN))
            continue
        start = int(rng.integers(0, PLANTED_LEN - QUERY_LEN))
        seqs.append(mutate(rng, p[start:start + QUERY_LEN], (0, 3, 12)[kind]))
    return seqs


def http_json(url: str, body: dict | None = None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


class EngineCalls:
    """Records the arguments and result of every call of the named
    methods on every DeviceEngine (the CLI and the server make their
    own): ``with EngineCalls(name, ...) as calls`` gives {name: [(args,
    result), ...]}."""

    def __init__(self, *names):
        from bigsi_tpu_torch.index.device_engine import DeviceEngine

        self.cls = DeviceEngine
        self.calls = {name: [] for name in names}
        self.real = {name: getattr(DeviceEngine, name) for name in names}

    def __enter__(self):
        for name, real in self.real.items():
            def wrapper(engine, *args, _seen=self.calls[name], _real=real):
                out = _real(engine, *args)
                _seen.append((args, out))
                return out

            setattr(self.cls, name, wrapper)
        return self.calls

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.cls, name, real)


def seq_outcomes(calls) -> dict:
    """counts_batch_seqs calls -> how many served, overflowed (None from
    a batch the geometry guard admits) and were refused by the guard
    (None from a batch past SEQ_MAX_NK k-mers)."""
    from bigsi_tpu_torch.index.device_engine import SEQ_MAX_NK

    out = {"served": 0, "overflowed": 0, "refused": 0}
    for args, result in calls:
        if result is not None:
            out["served"] += 1
        elif args[0].shape[1] - K_LEN + 1 > SEQ_MAX_NK:
            out["refused"] += 1
        else:
            out["overflowed"] += 1
    return out


def check_seq_batch(name, what, outcome, kmer_calls) -> None:
    """What each of the cols indexes' extra batches must take: the N
    batch the k-mer path alone; the 4 kb batch the seq arm; the mixed
    batch the seq arm for its short part and a refusal of its 20 kb
    part.  On minimizer/32 an overflow may send a batch the seq arm
    admits to the k-mer path: the JAX engine's budgets (kept as they
    are) fall short of the entries 4 kb queries need at w = 11, r = 6."""
    served, fell = outcome["served"], outcome["overflowed"]
    if what.startswith("one N"):
        ok = served + fell + outcome["refused"] == 0 and kmer_calls == 1
    else:
        refused = 1 if what.endswith("20 kb") else 0
        ok = (outcome["refused"] == refused and served + fell == 1
              and kmer_calls == refused + fell and (served == 1 or name != HEADLINE))
    check(ok, "%s: search_batch of %s took the wrong path: %s, %d counts_batch_kmers calls"
          % (name, what, outcome, kmer_calls))


def seq_traffic(rng, planted, seqs):
    """The cols indexes' extra batches: (name, queries)."""
    with_n = list(seqs)
    with_n[7] = with_n[7][:100] + "N" + with_n[7][101:]
    long4k = [mutate(rng, planted[i % PLANTED] + planted[(i + 1) % PLANTED], 8 * (i % 3))
              for i in range(8)]
    mixed = seqs[:B - 8] + [planted[i % PLANTED] + random_seq(rng, 18_000) for i in range(8)]
    return (("one N base", with_n), ("8 x 4,000 bp", long4k),
            ("%d x %d bp + 8 x 20 kb" % (B - 8, QUERY_LEN), mixed))


PEAK = {"bytes": 0}  # the device's peak allocation over the run, across resets


def on_device(fn):
    """Runs ``fn()``: -> (its result, its wall time in s, the most it held
    on the device at once: peak allocation less what was allocated
    before)."""
    import torch

    torch.cuda.synchronize()
    PEAK["bytes"] = max(PEAK["bytes"], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - before


def timed_load(config):
    """Opens the index on the port's CUDA engine: -> (the facade, {"s":
    wall time of ``BIGSI(config, device)``, "peak": what it held on the
    device, "words" and "cols": the bytes of the tile-padded row-major
    matrix and of its cols layout}); a verified index's are its screen's."""
    from bigsi_tpu_torch import BIGSI

    port, seconds, peak = on_device(lambda: BIGSI(config, device=DEVICE))
    engine = port.screen_engine if port.screen is not None else port.engine
    tile_rows = engine.tile_rows if engine.tiled else 1
    words = -(-engine.matrix.num_rows // tile_rows) * tile_rows * engine.matrix.num_words * 4
    cols = 0 if engine.cols is None else engine.cols.numel() * engine.cols.element_size()
    return port, {"s": seconds, "peak": peak, "words": words, "cols": cols}


def timed_stage(port) -> dict:
    """Stages a verified index's rows.bin on the card through its lazy
    ``verifier``: -> {"s": wall time, "peak": what it held on the device,
    "words": the bytes of rows.bin}."""
    verifier, seconds, peak = on_device(lambda: port.verifier)
    check(verifier is not None and verifier.matrix is port.bitmatrix,
          "the verifier staged the index's rows.bin")
    return {"s": seconds, "peak": peak, "words": port.bitmatrix.words.nbytes}


def queries_in(method: str, args) -> int:
    """The queries of one recorded engine call."""
    return len(args[1]) - 1 if method == "counts_batch_kmers" else len(args[0])


# a scored search_batch split by the facade's spans: the engine's counts,
# then the presence strings of every hit query's results (kernel L's
# strings form, one launch, and its copies) and the scorer, inside result
# building
SCORED_PARTS = {"counts": "search.batch_counts", "presence": "search.presence",
                "score": "search.score", "results": "search.batch_results"}


def scored_searches(name: str, port, oracles, q: str, seqs) -> dict:
    """A scored search of ``q`` and a scored search_batch of ``seqs`` at
    0.7 on ``port`` must equal every oracle's, kernel L's strings form
    launching once for the search and once for the batch and its row
    form never (on a DeviceEngine; a verified index scores on its classic
    host engine): -> {"search_ms", "batch_ms" (host clock), "results":
    scored results of the batch, "launches": the strings form's in the
    batch, "split": the batch's SCORED_PARTS in ms}."""
    from bigsi_tpu_torch import metrics
    from bigsi_tpu_torch.ops import fused_lookup

    device = type(port.engine).__name__ == "DeviceEngine"
    strings, rows = fused_lookup.presence_strings, fused_lookup.presence_rows
    before, rows_before = strings.launches, rows.launches
    t0 = time.perf_counter()
    one = port.search(q, 0.7, score=True)
    t1 = time.perf_counter()
    single = strings.launches - before
    timers = metrics.snapshot()["timers"]
    batch = port.search_batch(seqs, 0.7, score=True)
    t2 = time.perf_counter()
    after = metrics.snapshot()["timers"]
    launches = strings.launches - before - single
    hits = sum(1 for r in batch if r)
    check(single == int(device) and launches == int(device and hits > 0)
          and rows.launches == rows_before,
          "%s: kernel L's strings form launched %d times for the scored search (expected %d) "
          "and %d for the scored batch of %d hit queries (expected %d), its row form %d times "
          "(expected 0)" % (name, single, int(device), launches, hits,
                            int(device and hits > 0), rows.launches - rows_before))
    split = {part: (after.get(t, {}).get("total_s", 0.0) - timers.get(t, {}).get("total_s", 0.0))
             * 1e3 for part, t in SCORED_PARTS.items()}
    for oracle in oracles:
        check(one == oracle.search(q, 0.7, score=True),
              "%s scored search equals the host's" % name)
        check(batch == oracle.search_batch(seqs, 0.7, score=True),
              "%s scored search_batch equals the host's" % name)
    results = sum(len(r) for r in batch)
    check(results > 0 and all("kmer-presence" in d for r in batch for d in r),
          "%s: the scored batch has scored results" % name)
    return {"search_ms": (t1 - t0) * 1e3, "batch_ms": (t2 - t1) * 1e3, "results": results,
            "launches": launches, "hits": hits, "split": split}


def phase_slice(number: int, name: str, gen, rng):
    import yaml

    from bigsi_tpu_torch import BIGSI
    from bigsi_tpu_torch.__main__ import make_parser, result_dict, run
    from bigsi_tpu_torch.http.server import make_server

    t0 = time.perf_counter()
    config, planted = make_index(name, gen, rng)
    t_index = time.perf_counter() - t0
    seqs = make_queries(rng, planted)
    host = BIGSI(dict(config, engine="numpy"))  # the numpy HostEngine, the reference
    check(type(host.engine).__name__ == "HostEngine", "the reference runs the host engine")
    verified = name == VERIFIED
    # the verified index's oracle (b): a classic index of the same rows.bin
    oracles = [host, classic_twin(config)] if verified else [host]

    def expect(seq, t):
        """The host's search, which every other oracle must give too."""
        out = host.search(seq, t)
        check(all(o.search(seq, t) == out for o in oracles[1:]),
              "%s: the oracles agree on search at %.1f" % (name, t))
        return out

    def expect_batch(batch, t):
        out = host.search_batch(batch, t)
        check(all(o.search_batch(batch, t) == out for o in oracles[1:]),
              "%s: the oracles agree on search_batch at %.1f" % (name, t))
        return out

    port, load = timed_load(config)
    engine = port.screen_engine if verified else port.engine
    check(type(engine).__name__ == "DeviceEngine", "the port runs its CUDA engine")
    cols = name in COLS_INDEXES
    if cols or verified:  # never the row-major words and the cols at once
        check(load["peak"] < load["words"] + load["cols"],
              "%s: the load's peak %d B is under words + cols %d B"
              % (name, load["peak"], load["words"] + load["cols"]))
        r = COLS_INDEXES.get(name, HEADLINE_R)
        check(engine.run_len == r and engine.slot_scheme == 3
              and engine.cols is not None and engine.words is None,
              "%s: cols engine with slot scheme 3 and r = %d" % (name, r))
    if cols:
        check(engine.supports_seq_batch() and engine.supports_kmer_batch(),
              "%s: counts_batch_seqs and counts_batch_kmers serve" % name)
    elif verified:
        check(engine.supports_kmer_batch() and port._want_verifier and port._verifier is None,
              "%s: the screen serves counts_batch_kmers; the verifier is wanted, not staged "
              "at open" % name)
    else:
        check(not engine.supports_seq_batch(), "%s: the seq arm is off" % name)
    compared = 0

    # single search of a planted query
    q = planted[0][:QUERY_LEN]
    for t in (1.0, 0.7):
        got = port.search(q, t)
        check(got == expect(q, t), "%s search at %.1f equals the host's" % (name, t))
        compared += 1
    check(any(r["sample_name"] == "planted0" and r["percent_kmers_found"] == 100.0
              for r in port.search(q, 1.0)), "the planted sample is found")
    if verified:  # a single search verifies on the host: nothing staged yet
        check(port._verifier is None, "%s: single searches stage no verifier" % name)
        stage = timed_stage(port)
    scored = scored_searches(name, port, oracles, q, seqs)
    compared += 1 + len(seqs)

    # bulk_search of a FASTA through the port's CLI
    WORK.mkdir(parents=True, exist_ok=True)
    fasta = WORK / "queries.fasta"
    fasta.write_text("".join(">q%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))
    cfg_path = WORK / ("%s.yaml" % name.replace("/", "-"))
    cfg_path.write_text(yaml.safe_dump(config))
    n_hits = {}
    methods = ("counts_batch", "counts_batch_kmers", "counts_batch_seqs")
    with EngineCalls(*methods) as calls:
        for t in (1.0, 0.7):
            args = make_parser().parse_args(
                ["bulk_search", str(fasta), "-t", str(t), "-c", str(cfg_path)])
            got = json.loads(run(args, device=DEVICE))
            want = [result_dict(s, t, r) for s, r in zip(seqs, expect_batch(seqs, t))]
            check(got == want, "%s bulk_search at %.1f equals the host's" % (name, t))
            n_hits[t] = sum(len(d["results"]) for d in got)
            compared += len(got)

        # HTTP /search: 3 GET and 1 POST, then a burst of 8 concurrent GETs
        # that the server's batcher coalesces
        server = make_server(dict(config, serve_batch_wait_ms=30), host="127.0.0.1", port=0,
                             device=DEVICE)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://127.0.0.1:%d/search" % server.server_address[1]

            def get(s, t):
                return http_json(base + "?" + urllib.parse.urlencode({"seq": s, "threshold": t}))

            for s, t in ((seqs[0], 1.0), (seqs[1], 0.7), (seqs[3], 0.7)):
                check(get(s, t) == result_dict(s, t, expect(s, t)),
                      "%s GET /search equals the host's" % name)
            got = http_json(base, {"seq": seqs[5], "threshold": 0.7})
            check(got == result_dict(seqs[5], 0.7, expect(seqs[5], 0.7)),
                  "%s POST /search equals the host's" % name)
            burst = seqs[8:16]
            before = {method: len(c) for method, c in calls.items()}
            with ThreadPoolExecutor(max_workers=len(burst)) as pool:
                outs = list(pool.map(lambda s: get(s, 0.7), burst))
            for s, got in zip(burst, outs):
                check(got == result_dict(s, 0.7, expect(s, 0.7)),
                      "%s coalesced GET /search equals the host's" % name)
            compared += 4 + len(burst)
        finally:
            server.shutdown()
            server.invalidate()
            server.server_close()
            thread.join(timeout=60)
        check(not thread.is_alive(), "the HTTP server stopped")
        # queries of the burst that reached the engine in a search_batch
        batch_methods = (("counts_batch_kmers",) if verified
                         else ("counts_batch", "counts_batch_seqs"))
        coalesced = sum(queries_in(method, args) for method in batch_methods
                        for args, _ in calls[method][before[method]:])
        extra = []
        if cols:  # a non-ACGT batch, long queries and a mixed-length batch
            for what, batch in seq_traffic(rng, planted, seqs):
                before = {method: len(c) for method, c in calls.items()}
                got = port.search_batch(batch, 0.7)
                check(got == expect_batch(batch, 0.7),
                      "%s search_batch of %s equals the host's" % (name, what))
                check_seq_batch(name, what, seq_outcomes(
                    calls["counts_batch_seqs"][before["counts_batch_seqs"]:]),
                    len(calls["counts_batch_kmers"]) - before["counts_batch_kmers"])
                compared += len(batch)
                extra.append(what)
    check(n_hits[1.0] > 0 and n_hits[0.7] > n_hits[1.0],
          "bulk_search finds exact and inexact hits: %s" % n_hits)
    check(coalesced > 0, "%s: the HTTP batcher coalesced GETs into search_batch" % name)
    n = {method: len(c) for method, c in calls.items()}
    if cols:
        outcome = seq_outcomes(calls["counts_batch_seqs"])
        falls = outcome["overflowed"] + outcome["refused"]
        # the N batch and every None take the k-mer path, never counts_batch
        check(n["counts_batch"] == 0 and n["counts_batch_kmers"] == falls + 1,
              "%s: the k-mer path answered the N batch and each fall-back: %s %s"
              % (name, n, outcome))
        check(outcome["refused"] == 1, "%s: the guard refused the 20 kb half alone: %s"
              % (name, outcome))
        check(name != HEADLINE or outcome["overflowed"] == 0,
              "%s: the seq arm served every batch it admits: %s" % (name, outcome))
        shapes = [tuple(args[0].shape) for args, out in calls["counts_batch_seqs"]
                  if out is None]
        route = ("counts_batch_seqs (served %(served)d, overflowed %(overflowed)d, "
                 "refused by the guard %(refused)d" % outcome
                 + "; (B, L) of the batches it returned None for: %s)" % shapes)
    elif verified:
        check(n["counts_batch_kmers"] > 0 and n["counts_batch"] == n["counts_batch_seqs"] == 0,
              "%s: counts_batch_kmers screened every batch: %s" % (name, n))
        route = "counts_batch_kmers (the screen) and DeviceVerifier (the verify)"
    else:
        check(n["counts_batch"] > 0 and n["counts_batch_kmers"] == n["counts_batch_seqs"] == 0,
              "%s: counts_batch served every batch: %s" % (name, n))
        route = "counts_batch"
    print("phase %d load %s: BIGSI(config, device) %.3f s, load peak %.4f GB on the device "
          "(row-major words %.4f GB, cols %.4f GB)"
          % (number, name, load["s"], load["peak"] / 1e9, load["words"] / 1e9,
             load["cols"] / 1e9), flush=True)
    split = scored["split"]
    print("phase %d scored %s: search(score=True) of %d bp at 0.7 %.3f ms, search_batch(score="
          "True) of %d queries at 0.7 %.3f ms (host clock), %d scored results; equal to the "
          "host engine's; the batch split by the facade's spans: %s %.3f ms, %s %.3f ms "
          "(kernel L's strings form launched %d times; %d hit queries), %s %.3f ms, %s %.3f ms "
          "(holding the presence and score spans: results alone %.3f ms)"
          % (number, name, QUERY_LEN, scored["search_ms"], B, scored["batch_ms"],
             scored["results"], SCORED_PARTS["counts"], split["counts"],
             SCORED_PARTS["presence"], split["presence"], scored["launches"], scored["hits"],
             SCORED_PARTS["score"], split["score"], SCORED_PARTS["results"], split["results"],
             split["results"] - split["presence"] - split["score"]), flush=True)
    if verified:
        print("phase %d verifier %s: rows.bin staged at the first batched verify in %.3f s, "
              "device peak %.4f GB (rows.bin %.4f GB)"
              % (number, name, stage["s"], stage["peak"] / 1e9, stage["words"] / 1e9),
              flush=True)
    print("phase %d %s: index of %d samples, m=%d, made in %.1f s; %d result "
          "lists equal the host engine's%s (search, bulk_search at 1.0 and 0.7 with "
          "%d and %d hits, HTTP 3 GET + 1 POST + 8 concurrent GETs (%d coalesced)%s) "
          "through %s; engine calls %s"
          % (number, name, N, M, t_index, compared,
             " and a classic index's of the same rows.bin" if verified else "",
             n_hits[1.0], n_hits[0.7], coalesced,
             "".join(", search_batch of " + e for e in extra), route, json.dumps(n)),
          flush=True)
    return port, seqs


# -- phase 10 -----------------------------------------------------------


BATCH_PARTS = {"counts": "search.batch_counts", "results": "search.batch_results"}
# a verified index's search_batch: the screen, candidates and the classic
# rows of each query, the verify, result building
VERIFIED_PARTS = {"screen": "search.screen_counts", "candidates": "search.candidates",
                  "verify": "search.verify", "results": "search.batch_results"}


def search_batch_layers(port, seqs, reps: int, threshold: float = 1.0,
                        parts: dict = BATCH_PARTS) -> list[dict]:
    """Times of `reps` search_batch calls of the whole batch, each split
    by the facade's own timers inside that call: the engine's
    counts_batch, counts_batch_kmers or counts_batch_seqs
    ("search.batch_counts"), result building ("search.batch_results"),
    and the rest: on the seq path the bytes' padding and the ACGT gate,
    else k-mer extraction, hashing and padding on the host.  Inside
    counts_batch_kmers, the engine's own spans split the native prep
    ("engine.kmer_prep") from copies, kernel and counts back
    ("engine.kmer_counts"); inside counts_batch_seqs, the copies in
    ("engine.seq_in"), kernels H and E up to the ok read
    ("engine.seq_kernels") and the counts back ("engine.seq_out").  A
    verified index's call splits by ``parts`` = VERIFIED_PARTS.  All in
    ms."""
    from bigsi_tpu_torch import metrics

    port.search_batch(seqs, threshold)
    calls = []
    for _ in range(reps):
        metrics.reset()
        t0 = time.perf_counter()
        port.search_batch(seqs, threshold)
        total = (time.perf_counter() - t0) * 1e3
        timers = metrics.snapshot()["timers"]
        call = {"search_batch": total}
        for key, timer in parts.items():
            call[key] = timers[timer]["total_s"] * 1e3
        call["prep"] = total - sum(call[key] for key in parts)
        for span in SPANS:
            if span in timers:
                call[span] = timers[span]["total_s"] * 1e3
        calls.append(call)
    return calls


def median_call(calls) -> dict:
    return sorted(calls, key=lambda c: c["search_batch"])[len(calls) // 2]


def engine_inputs(port, seqs, method: str):
    """The arguments the facade hands the engine's ``method`` in one
    search_batch of `seqs`."""
    with EngineCalls(method) as calls:
        port.search_batch(seqs, 1.0)
    seen = calls[method]
    check(len(seen) == 1, "one %s per search_batch, got %d" % (method, len(seen)))
    return seen[0][0]


def seq_inputs(port, seqs):
    """The padded bytes, lengths and prep arguments of kernel H's last
    launch in one search_batch of `seqs`, and whether its ``ok`` held."""
    from bigsi_tpu_torch.index import device_engine

    seen, real = [], device_engine._counts_batch_seqs

    def spy(cols, seqs_d, lens_d, **kw):
        out = real(cols, seqs_d, lens_d, **kw)
        seen.append((seqs_d, lens_d, kw, bool(out[2])))
        return out

    device_engine._counts_batch_seqs = spy
    try:
        port.search_batch(seqs, 1.0)
    finally:
        device_engine._counts_batch_seqs = real
    check(len(seen) > 0, "search_batch launched kernel H")
    return seen[-1]


def timed_kernel(name, kernel, reference, args, errors, case):
    from bigsi_tpu_torch.scripts.timing import cuda_ms

    errors.compare(name, kernel(*args), reference(*args), case)
    return cuda_ms(lambda: kernel(*args), 20, DEVICE), cuda_ms(lambda: reference(*args), 5, DEVICE)


def host_kernel_inputs(port, seqs):
    """The layout's kernel, plain version and arguments on the inputs the
    facade hands counts_batch in one search_batch of `seqs`."""
    import torch

    from bigsi_tpu_torch.index.device_engine import tile_streams
    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    engine = port.engine
    idx, mask = engine_inputs(port, seqs, "counts_batch")[:2]
    idx_t = torch.from_numpy(idx.astype(np.int32)).to(engine.device)
    mask_t = torch.from_numpy(mask).to(engine.device)
    shape = "B=%d K=%d h=%d" % idx.shape
    if engine.layout == "classic":
        return "classic_counts", fl.classic_counts, plain.batched_counts, (
            engine.words, idx_t, mask_t), shape
    tile, smask = tile_streams(idx_t, mask_t, engine.tile_rows)
    if engine.layout == "blocked":
        return "tile_counts", fl.tile_counts, plain.blocked_counts, (
            engine.words, tile, smask, engine.tile_rows), shape
    utile, gmask = plain.build_grouped_streams(tile, smask, engine.run_len)
    return "grouped_tile_counts", fl.grouped_tile_counts, plain.grouped_counts, (
        engine.words, utile, gmask, engine.tile_rows), shape + " U=%d R=%d" % gmask.shape[1:]


def phase_cols_times(number: int, gpu: str, name: str, port, seqs, errors: Errors,
                     kernel_ms: dict) -> None:
    """A cols index: search_batch on the seq path and, with the seq arm
    turned off on the engine instance, on the k-mer path, each split by
    layer; kernel H beside its plain version on the facade's own bytes,
    kernel E on H's streams and on the native prep's, kernel C on H's
    streams over the row-major words (and, on minimizer/16, kernel D
    at full size, pack_times, and C on the native prep's streams)."""
    import torch

    from bigsi_tpu_torch.index.device_engine import kmer_streams_to_device, load_words
    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain
    from bigsi_tpu_torch.ops import prep as plain_prep
    from bigsi_tpu_torch.scripts.timing import cuda_ms

    engine = port.engine
    seq_calls = search_batch_layers(port, seqs, 5)
    seqs_d, lens_d, kw, ok = seq_inputs(port, seqs)
    check(ok or name != HEADLINE, "%s: kernel H's streams fit the budget" % name)
    engine.supports_seq_batch = lambda: False  # the k-mer path, on this instance only
    try:
        kmer_calls = search_batch_layers(port, seqs, 5)
        native = kmer_streams_to_device(engine_inputs(port, seqs, "_dispatch_kmer_chunk")[0],
                                        engine.device)
    finally:
        del engine.supports_seq_batch
    seq, kmer = median_call(seq_calls), median_call(kmer_calls)
    print("phase %d times %s [%s]: search_batch of %d queries, median of %d calls; seq path "
          "%.3f ms (%.1f queries/s): padding and ACGT gate on the host %.3f ms, engine "
          "counts_batch_seqs %.3f ms (copies in %.3f ms, kernels H and E up to the ok read "
          "%.3f ms, counts back %.3f ms), result "
          "building %.3f ms; k-mer path (seq arm off) %.3f ms (%.1f queries/s): k-mer "
          "extraction on the host %.3f ms, engine counts_batch_kmers %.3f ms (native prep "
          "%.3f ms, copies + kernel + counts back %.3f ms), result building %.3f ms; seq "
          "path / k-mer path %.4f"
          % (number, name, gpu, B, len(seq_calls), seq["search_batch"],
             B / seq["search_batch"] * 1e3, seq["prep"], seq["counts"], seq["engine.seq_in"],
             seq["engine.seq_kernels"], seq["engine.seq_out"], seq["results"],
             kmer["search_batch"], B / kmer["search_batch"] * 1e3, kmer["prep"], kmer["counts"],
             kmer["engine.kmer_prep"], kmer["engine.kmer_counts"], kmer["results"],
             seq["search_batch"] / kmer["search_batch"]), flush=True)
    for path, calls in (("seq", seq_calls), ("k-mer", kmer_calls)):
        print("phase %d calls %s %s path [%s]: %s" % (number, name, path, gpu, json.dumps(calls)),
              flush=True)

    # kernel H on the facade's bytes; E on H's streams and on the native prep's
    h_ms = timed_kernel("seq_streams", partial(fl.seq_streams, **kw),
                        partial(plain_prep.prep_streams, **kw), (seqs_d, lens_d), errors,
                        "%s facade bytes" % name)
    h_streams = fl.seq_streams(seqs_d, lens_d, **kw)[:3]
    e_ms = timed_kernel("cols_counts", fl.cols_counts, plain.grouped_counts_cols,
                        (engine.cols, *h_streams), errors, "%s H streams" % name)
    e_native = timed_kernel("cols_counts", fl.cols_counts, plain.grouped_counts_cols,
                            (engine.cols, *native), errors, "%s native streams" % name)
    e_bytes = bound_bytes("cols_counts", engine.cols, *h_streams)
    record(kernel_ms, "seq_streams", *h_ms, bound_bytes("seq_streams", seqs_d, lens_d, h_streams))
    record(kernel_ms, "cols_counts", *e_ms, e_bytes)

    # kernel C on H's streams over the row-major words: the same counts
    tile_rows = engine.tile_rows
    words = load_words(np.asarray(engine.matrix.words), engine.device, tile_rows)
    c_args = (words, h_streams[0], h_streams[1], tile_rows)
    c_ms = timed_kernel("grouped_tile_counts", fl.grouped_tile_counts, plain.grouped_counts,
                        c_args, errors, "%s H streams" % name)
    check(all(torch.equal(c, e) for c, e in zip(fl.grouped_tile_counts(*c_args),
                                                  fl.cols_counts(engine.cols, *h_streams))),
          "%s: kernels C and E agree on H's streams" % name)
    c_bytes = bound_bytes("grouped_tile_counts", *c_args)
    b, u, r = h_streams[1].shape
    print("phase %d kernels %s [%s]: H seq_streams %.4f ms vs plain PyTorch %.4f ms (B=%d "
          "L=%d U=%d R=%d, ok %s); E on H's streams %.4f ms (plain %.4f) vs on the native "
          "prep's streams %.4f ms (plain %.4f, U=%d); C on H's streams over the row-major "
          "words %.4f ms (plain %.4f), equal to E; H + E share of the seq-path search_batch "
          "%.4f; escalation state %s (cold L2)"
          % (number, name, gpu, h_ms[0], h_ms[1], b, seqs_d.shape[1], u, r, ok, e_ms[0],
             e_ms[1], e_native[0], e_native[1], native[1].shape[1], c_ms[0], c_ms[1],
             (h_ms[0] + e_ms[0]) / seq["search_batch"], json.dumps(engine._seq_cap_esc)),
          flush=True)
    print("phase %d E vs C %s [%s]: on H's streams (B=%d U=%d R=%d) kernel E %.4f ms, bound "
          "%.4f ms by bytes (%.1f MB: the cols rows of the %d entries with a live slot, masks, "
          "counts), %.1f GB/s, %.3f of bound; kernel C %.4f ms, bound %.4f ms (%.1f MB), "
          "%.1f GB/s, %.3f of bound; E / C %.3f"
          % (number, name, gpu, b, u, r, e_ms[0], bound_ms(e_bytes), e_bytes / 1e6,
             int(((h_streams[1] & ((1 << engine.cols.element_size() * 8) - 1)) != 0)
                 .any(dim=2).sum()),
             e_bytes / e_ms[0] / 1e6, bound_ms(e_bytes) / e_ms[0], c_ms[0], bound_ms(c_bytes),
             c_bytes / 1e6, c_bytes / c_ms[0] / 1e6, bound_ms(c_bytes) / c_ms[0],
             e_ms[0] / c_ms[0]), flush=True)
    if name != HEADLINE:
        return

    pack_times(number, gpu, words, engine, errors, kernel_ms)
    c_args = (words, native[0], native[1], tile_rows)
    c_native = timed_kernel("grouped_tile_counts", fl.grouped_tile_counts,
                            plain.grouped_counts, c_args, errors, "%s native streams" % name)
    check(all(torch.equal(c, e) for c, e in zip(fl.grouped_tile_counts(*c_args),
                                                  fl.cols_counts(engine.cols, *native))),
          "kernels C and E agree on the native streams")
    print("phase %d times C vs E [%s]: %s native prep streams of the facade (B=%d U=%d R=%d), "
          "kernel C over the row-major words %.4f ms (plain %.4f ms) vs kernel E over the "
          "cols %.4f ms (cold L2); equal counts and exact"
          % ((number, gpu, name) + tuple(native[1].shape) + (c_native[0], c_native[1],
                                                             e_native[0])), flush=True)


def pack_times(number: int, gpu: str, words, engine, errors: Errors, kernel_ms: dict) -> None:
    """Kernel D on the full-size matrix: at the engine's tile_rows held to
    the cols the engine built chunk by chunk at load, then at tile_rows
    16, 8 and 32 held to its plain version and timed beside it, its
    bound, and a torch device-to-device copy_ of the same bytes (the
    copy floor: a yardstick, not D's function)."""
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain
    from bigsi_tpu_torch.scripts.timing import cuda_ms

    check(torch.equal(fl.pack_tile_cols(words, engine.tile_rows), engine.cols),
          "kernel D over the whole matrix repeats the cols the engine packed in chunks")
    dst = torch.empty_like(words)
    floor = cuda_ms(lambda: dst.copy_(words), 5, DEVICE)
    del dst
    for tile_rows in (16, 8, 32):
        args = (words, tile_rows)
        errors.compare("pack_tile_cols", (fl.pack_tile_cols(*args),),
                       (plain.pack_tile_cols(*args),), "full size tile_rows=%d" % tile_rows)
        d_ms = cuda_ms(lambda: fl.pack_tile_cols(*args), 5, DEVICE)
        d_plain = cuda_ms(lambda: plain.pack_tile_cols(*args), 2, DEVICE)
        moved = bound_bytes("pack_tile_cols", *args)
        record(kernel_ms, "pack_tile_cols", d_ms, d_plain, moved)
        print("phase %d times pack_tile_cols [%s]: m=%d W=%d tile_rows=%d, %.4f ms vs plain "
              "PyTorch %.4f ms; bound %.4f ms by bytes (%.1f MB), %.3f of bound, %.1f GB/s read "
              "+ write; copy floor (torch copy_ of the same %.1f MB) %.4f ms, D / copy %.3f"
              % (number, gpu, words.shape[0], words.shape[1], tile_rows, d_ms, d_plain,
                 bound_ms(moved), moved / 1e6, bound_ms(moved) / d_ms, moved / d_ms / 1e6,
                 moved / 1e6, floor, d_ms / floor), flush=True)


def verify_inputs(port, seqs, threshold: float):
    """The live queries' classic rows and candidates that one verified
    search_batch of ``seqs`` hands its DeviceVerifier."""
    from bigsi_tpu_torch.index import verify

    verifier = port.verifier
    seen, real = [], verifier.counts

    def spy(rows, cands):
        seen.append((rows, cands))
        return real(rows, cands)

    verifier.counts = spy
    try:
        port.search_batch(seqs, threshold)
    finally:
        del verifier.counts
    check(len(seen) == 1, "one verify pass per search_batch, got %d" % len(seen))
    rows, cands = seen[0]
    live = verify.live_queries(rows, cands)
    return [rows[i] for i in live], [cands[i] for i in live]


SPIN_CYCLES = 200_000_000  # about 0.1 s of device spin at the H100's clock


def queued_ms(counts_async, reps: int, stream) -> float:
    """Mean device time of the work one ``counts_async()`` enqueues on
    ``stream`` (copies in, A, gather, counts back), each call started
    with a cold L2 and queued behind a spin that must outlast its host
    part (the staging), so the events time the device alone."""
    import torch

    from bigsi_tpu_torch.scripts.timing import FLUSH_WORDS

    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=DEVICE)
    total = 0.0
    with torch.cuda.stream(stream):
        counts_async()()
        for _ in range(reps):
            torch.cuda._sleep(SPIN_CYCLES)
            spun = torch.cuda.Event()
            spun.record()
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pending = counts_async()
            end.record()
            check(not spun.query(), "the spin outlasted counts_async's host part")
            end.synchronize()
            pending()
            total += start.elapsed_time(end)
    return total / reps


def verify_load_times(number: int, gpu: str, port, case: str, rows, cands,
                      errors: Errors) -> None:
    """One verify load on the verified index's staged rows.bin:
    DeviceVerifier.counts held to kernel A's plain version plus the same
    gather and to the native host pass; counts_async returning while the
    device still works (its stream waits behind a spin on the caller's);
    the device verify on CUDA events around counts_async (copies in, A,
    gather, counts back) beside A alone and A's bound; DeviceVerifier.counts,
    its staging and the host pass on the host clock."""
    import torch

    from bigsi_tpu_torch.index import verify
    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain
    from bigsi_tpu_torch.scripts.timing import cuda_ms, host_ms

    verifier = port.verifier
    words = port.bitmatrix.words
    got = verifier.counts(rows, cands)
    _, sizes, *staged = verifier._stage(rows, cands)
    idx, mask, flat = (t.to(verifier.device) for t in staged)
    plain_got = plain.batched_counts(verifier.words, idx, mask)[0].reshape(-1).index_select(0, flat)
    kernel_got = fl.classic_counts(verifier.words, idx, mask)[0].reshape(-1).index_select(0, flat)
    errors.compare("classic_counts", (kernel_got,), (plain_got,), "verify " + case)
    flat_got = torch.from_numpy(np.concatenate(got))
    errors.compare("classic_counts", (flat_got,), (plain_got.cpu().long(),),
                   "DeviceVerifier.counts " + case)
    host = verify.verify_queries(words, rows, cands)
    check(all(np.array_equal(g, x) for g, x in zip(got, host)),
          "DeviceVerifier.counts equals the native host pass (%s)" % case)
    if verifier.cuda:  # the device's work queued behind about half a second of spin
        torch.cuda._sleep(1_000_000_000)
        pending = verifier.counts_async(rows, cands)
        early = not pending.done()
        check(early and all(np.array_equal(g, x) for g, x in zip(pending(), host)),
              "counts_async returned before the device finished (%s)" % case)
    dev_ms = queued_ms(lambda: verifier.counts_async(rows, cands), 10, verifier.stream)
    a_ms = cuda_ms(lambda: fl.classic_counts(verifier.words, idx, mask), 20, DEVICE)
    a_plain = cuda_ms(lambda: plain.batched_counts(verifier.words, idx, mask), 3, DEVICE)
    stage_ms = host_ms(lambda: verifier._stage(rows, cands), 5)
    counts_ms = host_ms(lambda: verifier.counts(rows, cands), 5)
    host_pass = host_ms(lambda: verify.verify_queries(words, rows, cands), 5)
    moved = bound_bytes("classic_counts", verifier.words, idx, mask)
    print("phase %d verify %s [%s]: Q=%d live queries, K_max=%d, h=%d, %d candidates (%d counts "
          "back, %.1f KB); DeviceVerifier.counts %.3f ms on the host clock, of which stage "
          "(packing into pinned buffers) %.3f ms; device verify (copies in, A, gather, counts "
          "back) %.4f ms; kernel A "
          "alone %.4f ms (plain PyTorch %.4f ms), bound %.4f ms by bytes (%.1f MB: %d live "
          "k-mers x %d rows of %d B), %.3f of bound; host pass %.3f ms (host clock), "
          "%.2fx DeviceVerifier.counts"
          % (number, case, gpu, idx.shape[0], idx.shape[1], idx.shape[2],
             int(sizes.sum()), flat.numel(), flat.numel() * 4 / 1e3,
             counts_ms, stage_ms, dev_ms,
             a_ms, a_plain, bound_ms(moved), moved / 1e6, int(mask.sum()),
             idx.shape[2], verifier.words.shape[1] * 4, bound_ms(moved) / a_ms,
             host_pass, host_pass / counts_ms),
          flush=True)


def phase_verified_times(number: int, gpu: str, port, seqs, errors: Errors, rng) -> None:
    """The verified index: search_batch at 1.0 and 0.7 split by the
    facade's timers, then the two verify loads."""
    for t in (1.0, 0.7):
        calls = search_batch_layers(port, seqs, 5, t, VERIFIED_PARTS)
        mid = median_call(calls)
        print("phase %d times %s [%s]: search_batch of %d queries at %.1f, median of %d calls "
              "%.3f ms (%.1f queries/s): host k-mer prep %.3f ms, screen counts_batch_kmers "
              "%.3f ms (native prep %.3f ms, copies + kernel E + counts back %.3f ms), "
              "candidates and classic hashing %.3f ms, verify (DeviceVerifier) %.3f ms, "
              "result building %.3f ms"
              % (number, VERIFIED, gpu, B, t, len(calls), mid["search_batch"],
                 B / mid["search_batch"] * 1e3, mid["prep"], mid["screen"],
                 mid["engine.kmer_prep"], mid["engine.kmer_counts"], mid["candidates"],
                 mid["verify"], mid["results"]), flush=True)
        print("phase %d calls %s at %.1f [%s]: %s" % (number, VERIFIED, t, gpu, json.dumps(calls)),
              flush=True)
    rows, cands = verify_inputs(port, seqs, 0.7)
    check(len(rows) >= B // 2, "most of the batch's queries are live: %d" % len(rows))
    verify_load_times(number, gpu, port, "search_batch's live queries at 0.7", rows, cands,
                      errors)
    # bench.py's verify load: B x K random rows, 8 random candidate colours a query
    rows = [rng.integers(0, M, size=(512, H)).astype(np.int64) for _ in range(B)]
    cands = [np.unique(rng.integers(0, N, size=8)).astype(np.int64) for _ in range(B)]
    verify_load_times(number, gpu, port, "bench.py's load B=%d K=512" % B, rows, cands, errors)


def batch_kmers(seqs):
    """The distinct k-mers of each query, as the facade's search_batch
    finds them (extraction, then unique rows in their order): -> (kmers
    uint8[B, Kmax, K_LEN] zero-padded, mask bool[B, Kmax], the k-mers of
    all queries concatenated uint8[sum K_i, K_LEN])."""
    from bigsi_tpu_torch.kmers import seq_to_kmer_matrix, unique_rows_with_inverse

    mats = [unique_rows_with_inverse(seq_to_kmer_matrix(s, K_LEN))[0] for s in seqs]
    kmax = max(1, max(m.shape[0] for m in mats))
    kmers = np.zeros((len(mats), kmax, K_LEN), dtype=np.uint8)
    mask = np.zeros((len(mats), kmax), dtype=bool)
    for i, m in enumerate(mats):
        kmers[i, :m.shape[0]] = m
        mask[i, :m.shape[0]] = True
    return kmers, mask, np.concatenate(mats)


def batch_hash_times(number: int, gpu: str, seqs, mid: dict, errors: Errors) -> None:
    """Beside the classic search_batch's host k-mer prep and hashing
    (spans search.kmer_prep and search.hash; the native route hashes in
    its one pass, inside search.kmer_prep): kernel I on the same batch's
    distinct k-mers, with the copy-in of their bytes (host clock,
    synchronized) and alone (CUDA events)."""
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import hash as kmer_hash
    from bigsi_tpu_torch.scripts.timing import cuda_ms, host_ms

    flat = batch_kmers(seqs)[2]
    seeds = torch.arange(H, dtype=torch.int32, device=DEVICE)

    def copy_and_hash():
        rows = fl.kmer_rows(torch.from_numpy(flat).to(DEVICE), seeds, "classic",
                            canonical=True, m=M)
        torch.cuda.synchronize()
        return rows

    on_card = torch.from_numpy(flat).to(DEVICE)
    args = (on_card, seeds, "classic")
    errors.compare("kmer_rows", (fl.kmer_rows(*args, canonical=True, m=M),),
                   (kmer_hash.kmer_rows_plain(*args, True, M),), "the classic batch's k-mers")
    with_copy = host_ms(copy_and_hash, 20)
    alone = cuda_ms(lambda: fl.kmer_rows(*args, canonical=True, m=M), 20, DEVICE)
    opened = [span for span in ("search.kmer_prep", "search.hash") if span in mid]
    print("phase %d hash classic [%s]: %s %.3f ms on the host "
          "(the median call) against kernel I on the batch's %d distinct k-mers: %.4f ms with "
          "the copy-in of their %.2f MB of bytes (host clock, synchronized), %.4f ms alone "
          "(CUDA events, cold L2)"
          % (number, gpu, " + ".join(opened), sum(mid[span] for span in opened),
             flat.shape[0], with_copy, flat.nbytes / 1e6, alone), flush=True)


def phase_times(number: int, gpu: str, runs, errors: Errors, rng) -> dict:
    """-> {kernel: {ms, plain_ms, bound_ms, library_ms}}, each kernel on
    the first index of its path (kernels H and E on minimizer/16's seq
    path)."""
    import torch

    kernel_ms = {}
    for name, (port, seqs) in runs.items():
        if name in COLS_INDEXES:
            phase_cols_times(number, gpu, name, port, seqs, errors, kernel_ms)
            continue
        if name == VERIFIED:
            phase_verified_times(number, gpu, port, seqs, errors, rng)
            continue
        calls = search_batch_layers(port, seqs, 5)
        mid = median_call(calls)
        kname, kernel, reference, args, shape = host_kernel_inputs(port, seqs)
        k_ms, p_ms = timed_kernel(kname, kernel, reference, args, errors, "%s batch" % name)
        moved = bound_bytes(kname, *args)
        record(kernel_ms, kname, k_ms, p_ms, moved)
        print("phase %d times %s [%s]: search_batch of %d queries, median of %d calls "
              "%.3f ms (%.1f queries/s); inside that call: the host part %.3f ms (the spans "
              "that opened: %s), engine counts_batch %.3f ms, "
              "result building %.3f ms; %s kernel %.4f ms vs plain PyTorch %.4f ms (%s, cold "
              "L2); kernel share of search_batch %.4f; bound %.4f ms by bytes (%.1f MB), %.3f "
              "of bound"
              % (number, name, gpu, B, len(calls), mid["search_batch"],
                 B / mid["search_batch"] * 1e3, mid["prep"],
                 ", ".join("%s %.3f ms" % (span, mid[span]) for span in HOST_SPANS if span in mid),
                 mid["counts"], mid["results"],
                 kname, k_ms, p_ms, shape, k_ms / mid["search_batch"], bound_ms(moved),
                 moved / 1e6, bound_ms(moved) / k_ms),
              flush=True)
        print("phase %d calls %s [%s]: %s" % (number, name, gpu, json.dumps(calls)), flush=True)
        if name == "classic":
            batch_hash_times(number, gpu, seqs, mid, errors)
    presence_times(number, gpu, runs, errors, kernel_ms)
    strings_times(number, gpu, runs, errors, kernel_ms)
    print("phase %d memory [%s]: peak %.2f GB allocated on the device"
          % (number, gpu, max(PEAK["bytes"], torch.cuda.max_memory_allocated()) / 1e9),
          flush=True)
    return kernel_ms


def presence_args(port, name: str, q: str) -> tuple:
    """Kernel L's arguments for the facade's distinct k-mers of ``q`` on
    index ``name``, as its engine's presence_matrix builds them (the
    verified index: its screen's cols and screen row ids)."""
    import torch

    from bigsi_tpu_torch.index.device_engine import tile_streams
    from bigsi_tpu_torch.kmers import seq_to_kmer_matrix, unique_rows_with_inverse

    uniq = unique_rows_with_inverse(seq_to_kmer_matrix(q, K_LEN))[0]
    if name == VERIFIED:
        engine, row_idx = port.screen_engine, port.screen_row_idx(uniq)
    else:
        engine, row_idx = port.engine, port.kmer_matrix_to_row_idx(uniq)
    idx = torch.from_numpy(np.ascontiguousarray(row_idx, dtype=np.int32)).to(engine.device)
    if not engine.tiled:
        return engine.words, "classic", idx
    tile, smask = tile_streams(idx, torch.ones(idx.shape[0], dtype=torch.bool,
                                               device=engine.device), engine.tile_rows)
    if engine.cols is not None:
        return engine.cols, "cols", tile, smask
    return engine.words, "slot", tile, smask, engine.tile_rows


def presence_times(number: int, gpu: str, runs, errors: Errors, kernel_ms: dict) -> None:
    """Kernel L on each index of phases 4-9 (the verified one's screen)
    at the facade's k-mers of a 542 bp and a 20 kb query (K 512 and about
    20,000), held to its plain version and timed beside it and its bound
    (cold L2); the classic index's 542 bp query goes to the kernels line."""
    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    for name, (port, seqs) in runs.items():
        for q in (seqs[0], "".join(seqs)[:20_000]):
            args = presence_args(port, name, q)
            matrix, source, k = args[0], args[1], args[2].shape[0]
            k_ms, p_ms = timed_kernel(PRESENCE, lambda *a: (fl.presence_rows(*a),),
                                      lambda *a: (plain.presence_rows(*a),), args, errors,
                                      "%s K=%d" % (name, k))
            moved = bound_bytes(PRESENCE, *args)
            if name == "classic":  # the first: the 542 bp query
                record(kernel_ms, PRESENCE, k_ms, p_ms, moved)
            print("phase %d presence %s [%s]: kernel L (%s source, %s %s) on the facade's %d "
                  "k-mers of a %d bp query %.4f ms vs plain PyTorch %.4f ms (cold L2); bound "
                  "%.5f ms by bytes (%.3f MB), %.4f of bound; equal to its plain version"
                  % (number, name, gpu, source, str(matrix.dtype).replace("torch.", ""),
                     list(matrix.shape), k, len(q), k_ms, p_ms, bound_ms(moved), moved / 1e6,
                     bound_ms(moved) / k_ms), flush=True)


def scored_batch_inputs(port, seqs) -> tuple:
    """A scored search_batch of ``seqs`` at 0.7 on ``port``, with the
    arguments of its one call of kernel L's strings form recorded: ->
    (positional arguments, keyword arguments: the engine's offsets and
    output)."""
    from bigsi_tpu_torch.index import device_engine

    calls, real = [], device_engine.presence_strings

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    device_engine.presence_strings = spy
    try:
        port.search_batch(seqs, 0.7, score=True)
    finally:
        device_engine.presence_strings = real
    check(len(calls) == 1, "one call of kernel L's strings form a scored batch: %d" % len(calls))
    return calls[0]


def row_form_args(matrix, source, rows, kmer_off, tile_rows) -> list:
    """Kernel L's row-form arguments for each query of a strings-form
    batch, as a DeviceEngine's presence_matrix builds them."""
    from bigsi_tpu_torch.ops import lookup as plain

    off = kmer_off.tolist()
    out = []
    for a, b in zip(off, off[1:]):
        idx = rows[a:b]
        if source == "classic":
            out.append((matrix, source, idx))
        else:
            tile, smask = plain.slot_streams(idx, tile_rows)
            out.append((matrix, source, tile, smask) + ((tile_rows,) if source == "slot" else ()))
    return out


def strings_times(number: int, gpu: str, runs, errors: Errors, kernel_ms: dict) -> None:
    """Kernel L's strings form on each DeviceEngine index's own scored
    batch (the arguments its engine gave the kernel in a scored
    search_batch of the 256 queries at 0.7), held to its plain version
    and timed beside it, its bound and kernel L's row form over the same
    hit queries: each query's launch alone (cold L2) summed, and all of
    them back to back in one timed window.  The classic index's batch
    goes to the kernels line."""
    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain
    from bigsi_tpu_torch.scripts.timing import cuda_ms

    for name, (port, seqs) in runs.items():
        if name == VERIFIED:  # scores on its classic host engine: no kernel L
            continue
        args, kw = scored_batch_inputs(port, seqs)
        matrix, source, rows, kmer_off = args[:4]
        k_ms, p_ms = timed_kernel(STRINGS, lambda *a: fl.presence_strings(*a, **kw),
                                  lambda *a: plain.presence_strings(*a), args, errors,
                                  "%s scored batch" % name)
        moved = bound_bytes(STRINGS, *args)
        if name == "classic":
            record(kernel_ms, STRINGS, k_ms, p_ms, moved)
        per_query = row_form_args(matrix, source, rows, kmer_off, args[8])
        alone = sum(cuda_ms(lambda a=a: fl.presence_rows(*a), 5, DEVICE) for a in per_query)
        together = cuda_ms(lambda: [fl.presence_rows(*a) for a in per_query], 5, DEVICE)
        print("phase %d strings %s [%s]: kernel L's strings form (%s source, %s %s) on the "
              "scored batch's %d hit queries (%d distinct k-mers, %d positions, %d results, %d "
              "bytes of strings) %.4f ms vs plain PyTorch %.4f ms (cold L2); bound %.5f ms by "
              "bytes (%.3f MB), %.4f of bound; equal to its plain version; the row form over the "
              "same queries: %d launches %.4f ms summed alone, %.4f ms back to back"
              % (number, name, gpu, source, str(matrix.dtype).replace("torch.", ""),
                 list(matrix.shape), kmer_off.shape[0] - 1, rows.shape[0], args[4].shape[0],
                 args[6].shape[0], kw["out"].numel(), k_ms, p_ms, bound_ms(moved), moved / 1e6,
                 bound_ms(moved) / k_ms, len(per_query), alone, together), flush=True)


def phase_probe_ah(number: int, gpu: str, runs, gen, rng) -> None:
    """Kernels A and H where their designs differ, through the probe
    bigsi_tpu_torch.scripts.probe_ah: A on the classic index's resident
    matrix at B = 256 and at single queries of 512 and 20,000 k-mers; the
    classic index's single search of a 542 bp and a 20 kb query (results
    equal to the host engine's); H at the seq arm's shapes (B = 256, L =
    576 at both cols configs; B = 8, L = 4,096), the wrapper beside the
    kernel alone and the kernel cut after each pass, with bounds."""
    from bigsi_tpu_torch import BIGSI
    from bigsi_tpu_torch.scripts import probe_ah

    port, seqs = runs["classic"]
    a = probe_ah.a_times(port.engine.words, gen, gpu)
    for (b, k), row in a.items():
        moved = bound_bytes("classic_counts", *row["args"])
        print("phase %d kernel A B=%d K=%d [%s]: %.4f ms, bound %.4f ms by bytes (%.1f MB), %.3f "
              "of bound" % (number, b, k, gpu, row["ms"], bound_ms(moved), moved / 1e6,
                            bound_ms(moved) / row["ms"]), flush=True)
    long_query = seqs[0] + random_seq(rng, 20_000 - QUERY_LEN)
    host = BIGSI(dict(port.config, engine="numpy"))
    for t in (1.0, 0.7):
        check(port.search(long_query, t) == host.search(long_query, t),
              "classic single search of 20 kb at %.1f equals the host's" % t)
    probe_ah.search_times(port, [seqs[0], long_query], gpu)
    for case, row in probe_ah.h_times(rng, M, gpu, DEVICE).items():
        seqs_d, lens_d, kw, outs = row["args"]
        moved = bound_bytes("seq_streams", seqs_d, lens_d, outs)
        alone = row["kernel_ms"] or row["ms"]  # the library is called on the card only
        passes = [round(ms, 4) for ms in row["passes_ms"] or ()]
        print("phase %d kernel H %s [%s]: wrapper %.4f ms, kernel alone %.4f ms, bound %.4f ms by "
              "bytes (%.2f MB), %.3f of bound (kernel alone); cumulative ms after each pass %s"
              % (number, case, gpu, row["ms"], alone, bound_ms(moved), moved / 1e6,
                 bound_ms(moved) / alone, passes), flush=True)


# -- phase 11 -----------------------------------------------------------


def probe_checks(gen, errors: Errors, words) -> int:
    """Kernels F (gather_rows), G (tile_xor) and B's counts-only build
    against their plain versions at the probes' shapes, over the
    full-size ``words``, and at ragged ones; -> the number of cases."""
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    dev = words.device
    cases = 0

    def rand_words(m, w):
        return torch.randint(-2**31, 2**31, (m, w), generator=gen, device=dev, dtype=torch.int32)

    def gather(mat, idx, rows, case):
        errors.compare("gather_rows", (fl.gather_rows(mat, idx, rows),),
                       (plain.gather_rows(mat, idx),), case)

    def xor(w, tile, valid, tile_rows, case):
        errors.compare("tile_xor", (fl.tile_xor(w, tile, valid, tile_rows),),
                       (plain.tile_xor(w, tile, valid, tile_rows),), case)

    def counts_only(w, tile, smask, tile_rows, case):
        got, none = fl.tile_counts(w, tile, smask, tile_rows, exact=False)
        check(none is None, "the counts-only build returns no exact")
        errors.compare("tile_counts", (got,),
                       (plain.blocked_counts(w, tile, smask, tile_rows, exact=False)[0],),
                       "counts-only " + case)
        check(torch.equal(got, fl.tile_counts(w, tile, smask, tile_rows)[0]),
              "counts-only %s: the same counts as the exact build" % case)

    # gather_rows: S2's view of the full-size words, its last row included
    view = words.view(-1, 128)
    idx = torch.randint(0, view.shape[0], (4099,), generator=gen, device=dev, dtype=torch.int32)
    idx[:2] = torch.tensor([view.shape[0] - 1, 0], dtype=torch.int32)
    gather(view, idx, 16, "full size [%d, 128] n=4099 with the last row" % view.shape[0])
    cases += 1
    for wr in (1, 33, 128, 8192):
        m = max(64, (1 << 22) // wr)
        mat = rand_words(m, wr)
        for n in (0, 1, 37, 1000):
            idx = torch.randint(0, m, (n,), generator=gen, device=dev, dtype=torch.int32)
            if n:
                idx[-1] = m - 1
            for rows in fl.ROWS_IN_FLIGHT:
                gather(mat, idx, rows, "Wr=%d n=%d rows=%d" % (wr, n, rows))
                cases += 1
    flat = rand_words(1000 * 128 + 1, 1).view(-1)
    mat = flat[1:].view(1000, 128)  # 4 bytes off 16-byte alignment: word loads
    idx = torch.randint(0, 1000, (333,), generator=gen, device=dev, dtype=torch.int32)
    gather(mat, idx, 8, "Wr=128 misaligned view")
    cases += 1

    # tile_xor and the counts-only build at the bisection's shape
    tile = torch.randint(0, words.shape[0] // 32, (B, 512), generator=gen, device=dev,
                         dtype=torch.int32)
    valid = torch.rand((B, 512), generator=gen, device=dev) >= 0.05
    xor(words, tile, valid, 32, "full size B=%d K=512 pad=0.05" % B)
    smask = torch.where(valid, 7, 0).long()
    counts_only(words, tile, smask, 32, "full size B=%d K=512 mask 7" % B)
    cases += 2
    for w in (1, 33):
        for tile_rows in (8, 16, 32, 64):
            mat = rand_words(tile_rows * 3001, w)
            for b, k, pad in ((5, 700, 0.3), (3, 0, 0.0), (2, 64, 1.0), (0, 16, 0.0),
                              (2, 3000, 0.1)):
                case = "W=%d tile_rows=%d B=%d K=%d pad=%.1f" % (w, tile_rows, b, k, pad)
                tile, smask = random_tile_inputs(gen, b, k, 3001, tile_rows, pad, dev)
                xor(mat, tile, smask != 0, tile_rows, case)
                counts_only(mat, tile, smask, tile_rows, case)
                cases += 2
    torch.cuda.synchronize()
    return cases


def phase_probes(number: int, gpu: str, runs, gen, errors: Errors, fns) -> tuple[dict, dict]:
    """-> ({kernel: {ms, plain_ms, bound_ms, library_ms}} of F and G,
    {kernel: launches} of the probes' run)."""
    import torch

    from bigsi_tpu_torch.scripts import bisect, microbench, probe_multidma
    from bigsi_tpu_torch.scripts.timing import cuda_ms

    words = runs[PROBE_INDEX][0].engine.words
    cases = probe_checks(gen, errors, words)
    print("phase %d probes: gather_rows, tile_xor and tile_counts' counts-only build "
          "bit-exact with their plain versions in %d cases" % (number, cases), flush=True)

    for fn in fns.values():
        fn.launches = 0
    fns["tile_counts"].counts_only_launches = 0
    t0 = time.perf_counter()
    # S2: random 512 B rows of the words viewed as [6.25e6, 128]
    view = words.view(-1, 128)
    idx = torch.randint(0, view.shape[0], (65536,), generator=gen, device=words.device,
                        dtype=torch.int32)
    s2 = probe_multidma.probe(view, idx, 16, gpu)
    # the yardstick: one PyTorch call that gathers the same rows
    library = cuda_ms(lambda: view.index_select(0, idx), 20, DEVICE)
    print("phase %d probes [%s]: torch index_select of the same %d rows %.4f ms (kernel F "
          "%.4f ms)" % (number, gpu, idx.numel(), library, s2["ms"]), flush=True)
    f_bytes = bound_bytes("gather_rows", view, idx)
    # fetch rate against row size, 128 B to 4 KB rows, each reading the
    # 50 MB of 128 B row segments kernel B reads per batch
    for wr in (32, 128, 1024):
        rows = words.view(-1, wr)
        n = B * 512 * H * 128 // (wr * 4)
        idx = torch.randint(0, rows.shape[0], (n,), generator=gen, device=words.device,
                            dtype=torch.int32)
        probe_multidma.probe(rows, idx, 16, gpu)
    # random 128 B rows drawn from the first 32 MB, 512 MB and all 3.2 GB
    # of the matrix: a rate that rises from 3.2 GB to 512 MB is TLB reach,
    # one that stays is DRAM (32 MB also fits the 50 MB L2, so its repeats
    # hit there)
    rows = words.view(-1, 32)
    n = B * 512 * H
    for span in (min(32 << 20, rows.shape[0] * 128), min(512 << 20, rows.shape[0] * 128),
                 rows.shape[0] * 128):
        idx = torch.randint(0, span // 128, (n,), generator=gen, device=words.device,
                            dtype=torch.int32)
        ms = probe_multidma.probe(rows, idx, 16, gpu, plain_baseline=False)["ms"]
        print("phase %d probes [%s]: %d random 128 B rows from the first %.1f MB of the "
              "matrix, %.4f ms, %.1f GB/s" % (number, gpu, n, span / 1e6, ms,
                                               n * 128 / ms / 1e6), flush=True)
    # S3-S5 over the words' first T tiles
    tiles = min(bisect.T, words.shape[0] // bisect.TILE_ROWS)
    s3 = bisect.run_kernel(words, tiles, gpu)
    tile, smask, valid = bisect.make_streams(bisect.B, bisect.KC * bisect.C, tiles, words.device)
    g_bytes = bound_bytes("tile_xor", words, tile, valid, bisect.TILE_ROWS)
    b_bytes = bound_bytes("tile_counts", words, tile, smask)
    s4 = bisect.run_compile(words, tiles, gpu, bisect.B)
    bisect.run_size(words, tiles, gpu)
    # S1 and every other microbench case
    ctx = microbench.Ctx(B, 512, H, DEFAULT_RUN, words.device, words=words)
    s1 = {}
    for case in microbench.CASES.values():
        s1.update(case(ctx) or {})
    torch.cuda.synchronize()
    counted = {k: fn.launches for k, fn in fns.items()}
    counted_only = fns["tile_counts"].counts_only_launches
    check(all(counted[k] > 0 for k in PROBE_KERNELS) and counted_only > 0 and
          not any(n for k, n in counted.items() if k not in PROBE_KERNELS),
          "the probes launched %s (and B's counts-only build) and no other: %s, counts-only %d"
          % (PROBE_KERNELS, counted, counted_only))
    print("phase %d probes [%s]: entry points ran in %.1f s (nvcc %.2f s); launches %s, "
          "tile_counts counts-only %d"
          % (number, gpu, time.perf_counter() - t0, s4["nvcc_s"], json.dumps(counted),
             counted_only), flush=True)
    g, ar = ctx.pregathered()
    every = torch.ones(ar.shape, dtype=torch.bool, device=words.device)
    bounds = {"k1 tile_xor": g_bytes, "k2 tile_counts counts-only": b_bytes,
              "k3 tile_counts + exact": b_bytes,
              "pallas-work": bound_bytes("grouped_tile_counts", g, ar, ctx.gmask, microbench.TR),
              "pallas-floor": bound_bytes("tile_xor", g, ar, every, microbench.TR)}
    times = {**s3, **{k: s1[k] for k in ("pallas-work", "pallas-floor")}}
    print("phase %d probe bounds [%s]: %s" % (number, gpu, "; ".join(
        "%s %.4f ms, bound %.4f ms by bytes (%.1f MB), %.3f of bound"
        % (k, times[k][0], bound_ms(v), v / 1e6, bound_ms(v) / times[k][0])
        for k, v in bounds.items())), flush=True)
    kernel_ms = {}
    record(kernel_ms, "gather_rows", s2["ms"], s2["plain_ms"], f_bytes, library)
    record(kernel_ms, "tile_xor", *s3["k1 tile_xor"], g_bytes)
    counted["counts_only"] = counted_only
    return kernel_ms, counted


# -- phase 12 -----------------------------------------------------------


BUILD_KERNELS = ("kmer_rows", "classic_counts", "bloom_scatter", "bloom_transpose",
                 "pack_tile_cols")  # phase 12's path: the full step, J, and D's round trip
HASH_LENGTHS = tuple(range(1, 10)) + (16, 31, 32, 33)  # every k % 4


def hash_checks(gen, rng, errors: Errors) -> int:
    """Kernel I against its plain version bit for bit: every k % 4 and
    k // 4 up to 8, seeds [0, 1, 99] and 2^32 - 1, h 1, 3 and 8, K 0 and
    1, N and lowercase bytes, reverse-complement palindromes, blocked rows
    at tile_rows 8, 32 and 64 with m below tile_rows and m not a multiple
    of 32, each with and without canonical forms; the golden value.
    -> the number of cases."""
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import hash as kmer_hash

    cases = 0
    odd = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
    moduli = ((M, 32), (1000, 8), (100_003, 64), (5, 8), (20, 64))
    for k in HASH_LENGTHS:
        mats = {"K=0": np.zeros((0, k), np.uint8), "K=1": acgt(rng, (1, k)),
                "ACGT": acgt(rng, (3000, k)), "N and lowercase": odd[rng.integers(0, 10, (3000, k))]}
        if k % 2 == 0:
            half = acgt(rng, (500, k // 2))
            mats["palindromes"] = np.concatenate(
                [half, np.stack([revcomp(x) for x in half])], axis=1)
        for what, km in mats.items():
            km = torch.from_numpy(np.ascontiguousarray(km)).to(DEVICE)
            for out, seeds in (("hashes", [0, 1, 99, 2**32 - 1]), ("classic", range(1)),
                               ("classic", range(3)), ("classic", range(8)),
                               ("blocked", range(2)), ("blocked", range(4)),
                               ("blocked", range(9)), ("canonical", ())):
                s = kmer_hash.seed_tensor(list(seeds), km.device)
                for m, tile_rows in moduli if out in ("classic", "blocked") else moduli[:1]:
                    for canonical in (False, True):
                        args = (km, s, out)
                        errors.compare(
                            "kmer_rows",
                            (fl.kmer_rows(*args, canonical=canonical, m=m, tile_rows=tile_rows),),
                            (kmer_hash.kmer_rows_plain(*args, canonical, m, tile_rows),),
                            "k=%d %s %s seeds=%d m=%d tile_rows=%d canonical=%s"
                            % (k, what, out, len(s), m, tile_rows, canonical))
                        cases += 1
            if "palindromes" == what:
                check(torch.equal(kmer_hash.canonicalize(km), km),
                      "a palindrome is its own canonical form")
    att = torch.tensor([list(b"ATT")], dtype=torch.uint8, device=DEVICE)
    golden = sorted(kmer_hash.row_indices(att, 3, 25)[0].tolist())
    check(golden == [2, 15, 17], "row_indices('ATT', 3, 25) = {2, 15, 17}, got %s" % golden)
    torch.cuda.synchronize()
    return cases + 1


def sample_kmers(rng, n: int) -> np.ndarray:
    """n distinct k-mers of a random genome drawn from ``rng``, in genome
    order: uint8[n, K_LEN]."""
    genome = acgt(rng, n + n // 100 + K_LEN)
    windows = np.lib.stride_tricks.sliding_window_view(genome, K_LEN)
    codes = np.zeros(windows.shape[0], dtype=np.uint64)
    for j in range(K_LEN):  # 2 bits a base: 62 bits, one code per distinct k-mer
        codes = (codes << np.uint64(2)) | (windows[:, j] >> 1 & 3).astype(np.uint64)
    first = np.sort(np.unique(codes, return_index=True)[1])
    check(first.size >= n, "the genome holds %d distinct k-mers" % n)
    return np.ascontiguousarray(windows[first[:n]])


def host_bloom(kmers: np.ndarray, layout: str) -> np.ndarray:
    """The port's host build of one sample's bloom (BIGSI.bloom's canonical
    k-mers through build_bloom_from_kmer_matrix: the native hasher and
    setter for classic), packed LSB-first as int32 words."""
    from bigsi_tpu_torch.bloom.bloomfilter import build_bloom_from_kmer_matrix
    from bigsi_tpu_torch.kmers import canonicalize_kmer_matrix
    from bigsi_tpu_torch.matrix.packing import pack_bits_lsb

    bits = build_bloom_from_kmer_matrix(canonicalize_kmer_matrix(kmers), M, H, layout=layout,
                                        tile_rows=32)
    return pack_bits_lsb(bits[None, :])[0].view(np.int32)


def build_checks(gen, rng, errors: Errors, sample) -> int:
    """Kernels J and K against their plain versions on the card: J on the
    sample's k-mers (classic and blocked/32 at m = M) and at small m,
    tile_rows 8 and 64 with m below them, 256 copies of one k-mer; K at N
    1, 33, 70, 1,500 and 4,096 (W 1, 2, 3, 47 and 128), m 1,000, 4,096 and
    70,001.  -> the number of cases."""
    import torch

    from bigsi_tpu_torch.ops import build, fused_lookup as fl

    cases = 0
    for layout in ("classic", "blocked"):
        nseeds = H + 1 if layout == "blocked" else H
        seeds = torch.arange(nseeds, dtype=torch.int32, device=DEVICE)
        for km, m, tile_rows in ((sample, M, 32), (sample[:5000], 1000, 8),
                                 (sample[:5000], 100_003, 64), (sample[:500], 5, 8),
                                 (sample[:500], 20, 64)):
            tile_rows = tile_rows if layout == "blocked" else 1
            errors.compare("bloom_scatter", (fl.bloom_scatter(km, seeds, layout, m, tile_rows),),
                           (build.bloom_plain(km, seeds, layout, m, tile_rows),),
                           "%s K=%d m=%d tile_rows=%d" % (layout, km.shape[0], m, tile_rows))
            cases += 1
    one = sample[:1]
    once = build.device_bloom(one, m=M, h=H)
    check(bool(once.any()) and torch.equal(build.device_bloom(one.repeat(256, 1), m=M, h=H), once),
          "256 copies of one k-mer set its bits, as one copy does")
    cases += 1
    for n, m in ((1, 1000), (33, 1000), (70, 4096), (1500, 70_001), (4096, 4096), (70, 1000)):
        mw = -(-m // 32) + 2  # words past m: the rows are cut to m
        blooms = torch.randint(-2**31, 2**31, (n, mw), generator=gen, device=DEVICE,
                               dtype=torch.int32)
        errors.compare("bloom_transpose", (fl.bloom_transpose(blooms, m),),
                       (build.transpose_plain(blooms, m),), "N=%d m=%d MW=%d" % (n, m, mw))
        cases += 1
    torch.cuda.synchronize()
    return cases


READER_LENGTHS = (31, 63, 64, 100)  # k: runs of 128 k-mers, fewer past 64 bytes
READER_COUNTS = (1, 255, 256, 257, 4097)  # K around runs' ends (128 k-mers a run)
READER_OFFSETS = (0, 1, 3)  # views x[o:], whose bytes start o * k past x's
LONG_K = 10_000  # past a run's 8,192 bytes: one k-mer a run


def mixed_kmers(rng, n: int, k: int) -> np.ndarray:
    """n k-mers of k bytes, ordinary ACGT ones mixed with all-N ones,
    ones of N and lowercase bytes, and reverse-complement palindromes (an
    N in the middle at odd k), so that each kind shares a run with the
    others: uint8[n, k]."""
    out = acgt(rng, (n, k))
    kind = rng.integers(0, 8, n)  # 0: all N, 1: N and lowercase, 2-3: palindrome
    out[kind == 0] = ord("N")
    odd = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
    out[kind == 1] = odd[rng.integers(0, 10, (int((kind == 1).sum()), k))]
    pal = np.nonzero(kind >= 2)[0][: n // 4]
    half = acgt(rng, (pal.size, k // 2))
    mid = np.full((pal.size, k % 2), ord("N"), dtype=np.uint8)
    out[pal] = np.concatenate([half, mid, np.stack([revcomp(x) for x in half])
                               if pal.size else half], axis=1)
    return out


def reader_case(errors: Errors, km, what: str, full: bool = True) -> int:
    """Kernels I and J against their plain versions on the k-mers ``km``
    (any view): I's raw hashes, classic rows with and without canonical
    forms, blocked/32 rows and canonical bytes; J classic and blocked at
    tile_rows 32, 64 and 24 (24 and 64 also below m's first tile).
    ``full`` False keeps I's canonical classic rows and bytes and J's four
    full-m blooms.  -> the number of cases."""
    import torch

    from bigsi_tpu_torch.ops import build, fused_lookup as fl
    from bigsi_tpu_torch.ops import hash as kmer_hash

    def seeds(values):
        return kmer_hash.seed_tensor(list(values), km.device)

    i_cases = ((seeds(range(H)), "classic", True, M, 1), (seeds(()), "canonical", False, 1, 1))
    if full:
        i_cases += ((seeds([0, 1, 99, 2**32 - 1]), "hashes", False, 1, 1),
                    (seeds(range(H)), "classic", False, M, 1),
                    (seeds(range(H + 1)), "blocked", True, M, 32))
    for s, out, canonical, m, tile_rows in i_cases:
        errors.compare("kmer_rows", (fl.kmer_rows(km, s, out, canonical=canonical, m=m,
                                                  tile_rows=tile_rows),),
                       (kmer_hash.kmer_rows_plain(km, s, out, canonical, m, tile_rows),),
                       "%s %s canonical=%s" % (what, out, canonical))
    j_cases = (("classic", M, 1), ("blocked", M, 32), ("blocked", M, 64), ("blocked", M, 24))
    if full:
        j_cases += (("blocked", 1000, 24), ("blocked", 20, 64))
    for layout, m, tile_rows in j_cases:
        s = seeds(range(H + 1 if layout == "blocked" else H))
        errors.compare("bloom_scatter", (fl.bloom_scatter(km, s, layout, m, tile_rows),),
                       (build.bloom_plain(km, s, layout, m, tile_rows),),
                       "%s %s m=%d tile_rows=%d" % (what, layout, m, tile_rows))
    return len(i_cases) + len(j_cases)


def reader_checks(rng, errors: Errors, sample, batch) -> int:
    """Kernels I and J at the staged reader's edges, bit for bit: k 31,
    63, 64 and 100 (and one k of LONG_K bytes), K 1, 255, 256, 257 and
    4,097, views starting 0, 1 and 3 k-mers in (bytes not 16-byte
    aligned), all-N, lowercase and palindromic k-mers in one run with
    ordinary ones; then the sample's views sample[1:] and sample[3:] and a
    slice of the classic batch at full size.  -> the number of cases."""
    import torch

    cases = 0
    for k in READER_LENGTHS:
        mat = torch.from_numpy(mixed_kmers(rng, max(READER_COUNTS) + max(READER_OFFSETS), k))
        mat = mat.to(DEVICE)
        for n in READER_COUNTS:
            for off in READER_OFFSETS:
                km = mat[off:off + n]
                cases += reader_case(errors, km, "k=%d K=%d x[%d:] (data_ptr %% 16 = %d)"
                                     % (k, n, off, km.data_ptr() % 16))
    long = torch.from_numpy(mixed_kmers(rng, 6, LONG_K)).to(DEVICE)[1:]
    cases += reader_case(errors, long, "k=%d K=5 x[1:]" % LONG_K, full=False)
    for what, km in (("sample[1:]", sample[1:]), ("sample[3:]", sample[3:]),
                     ("the classic batch's k-mers [5:100005]", batch[5:100_005])):
        check(km.data_ptr() % 16 != 0, "%s starts off a 16-byte boundary" % what)
        cases += reader_case(errors, km, what, full=False)
    torch.cuda.synchronize()
    return cases


def phase_build_ops(number: int, gpu: str, runs, gen, rng, errors: Errors,
                    fns) -> tuple[dict, dict]:
    """Hashing and the device build at full width: kernel I's cases, the
    port's entry() on the card against its plain run, J's and K's cases;
    then with the launch counts at 0 the full query step on the classic
    index's words and its phase-10 batch (I then A), one sample's bloom of
    KMERS_PER_SAMPLE k-mers in the classic and blocked/32 layouts (J), and
    the round trip words -> D's cols at tile_rows 32 -> their transpose
    (the blooms) -> K -> words.  -> ({kernel: times} of I, J and K,
    {kernel: launches} of that run)."""
    import torch

    from bigsi_tpu_torch.entry import entry
    from bigsi_tpu_torch.ops import build, fused_lookup as fl
    from bigsi_tpu_torch.ops import hash as kmer_hash
    from bigsi_tpu_torch.ops import lookup as plain
    from bigsi_tpu_torch.ops.lookup import make_full_query_step
    from bigsi_tpu_torch.scripts.timing import cuda_ms
    from bigsi_tpu_torch.synth import bloom_density

    t0 = time.perf_counter()
    cases = hash_checks(gen, rng, errors)
    port, seqs = runs["classic"]
    words = port.engine.words
    kmers_np, mask_np, _ = batch_kmers(seqs)
    idx, mask_host = engine_inputs(port, seqs, "counts_batch")[:2]
    check(np.array_equal(mask_np, mask_host), "the facade's mask is the batch's distinct k-mers")
    kmers = torch.from_numpy(kmers_np).to(DEVICE)
    mask = torch.from_numpy(mask_np).to(DEVICE)
    idx_t = torch.from_numpy(idx.astype(np.int32)).to(DEVICE)
    b, kmax, _ = kmers.shape
    seeds = torch.arange(H, dtype=torch.int32, device=DEVICE)
    i_args = (kmers.view(b * kmax, K_LEN), seeds, "classic")
    rows = fl.kmer_rows(*i_args, canonical=True, m=M)
    errors.compare("kmer_rows", (rows,), (kmer_hash.kmer_rows_plain(*i_args, True, M),),
                   "the classic batch B=%d K=%d" % (b, kmax))
    check(torch.equal(rows.view(b, kmax, H)[mask], idx_t[mask]),
          "kernel I's rows are the facade's kmer_matrix_to_row_idx rows")
    want_counts = fl.classic_counts(words, idx_t, mask)[0]
    fn, args = entry(device=DEVICE)
    fn_cpu, args_cpu = entry(device="cpu")
    for got, want in zip(fn(*args), fn_cpu(*args_cpu)):
        check(torch.equal(got.cpu(), want), "entry() on the card equals its plain run")
    sample = torch.from_numpy(sample_kmers(rng, KMERS_PER_SAMPLE)).to(DEVICE)
    cases += build_checks(gen, rng, errors, sample) + 2
    edges = reader_checks(rng, errors, sample, i_args[0])
    print("phase %d hashing and build: kmer_rows, bloom_scatter and bloom_transpose bit-exact "
          "with their plain versions in %d cases, %d of them at the staged reader's edges "
          "(unaligned views, K and k around a run, mixed k-mers, tile_rows 24 and 64); I's "
          "rows are the facade's; entry() equals its plain run"
          % (number, cases + edges, edges), flush=True)

    # the main path, its launches counted
    for fn_k in fns.values():
        fn_k.launches = 0
    step = make_full_query_step(M, H)
    counts = step(words, kmers, mask)
    blooms_j = {layout: build.device_bloom(sample, m=M, h=H, layout=layout)
                for layout in ("classic", "blocked")}
    cols = fl.pack_tile_cols(words, 32)
    blooms = cols.t().contiguous()
    del cols
    back = build.device_transpose(blooms, M)
    torch.cuda.synchronize()
    counted = {k: fn_k.launches for k, fn_k in fns.items()}
    check(all(counted[k] > 0 for k in BUILD_KERNELS) and
          not any(n for k, n in counted.items() if k not in BUILD_KERNELS),
          "hashing and build launched %s and no other: %s" % (BUILD_KERNELS, counted))
    check(torch.equal(counts, want_counts),
          "the full step's counts are kernel A's on the facade's host-hashed rows")
    check(torch.equal(back, words), "K(D(words) transposed) gives the classic words back")
    del back
    sample_np = sample.cpu().numpy()
    for layout, bloom in blooms_j.items():
        check(np.array_equal(bloom.cpu().numpy(), host_bloom(sample_np, layout)),
              "J's %s bloom of %d k-mers is the host's" % (layout, KMERS_PER_SAMPLE))
        share = int(popcount64(bloom.long() & 0xFFFFFFFF).sum()) / M
        print("phase %d bloom %s: %d k-mers, m=%d, h=%d: set-bit share %.5f (synth.bloom_density "
              "%.5f); equal to the host's bloom and J's plain version"
              % (number, layout, KMERS_PER_SAMPLE, M, H, share,
                 bloom_density(H, KMERS_PER_SAMPLE, M)), flush=True)

    # times on CUDA events, cold L2
    kernel_ms = {}
    i_out = (rows,)
    i_ms = cuda_ms(lambda: fl.kmer_rows(*i_args, canonical=True, m=M), 20, DEVICE)
    i_plain = cuda_ms(lambda: kmer_hash.kmer_rows_plain(*i_args, True, M), 5, DEVICE)
    i_bytes = bound_bytes("kmer_rows", i_args[0], seeds, *i_out)
    record(kernel_ms, "kmer_rows", i_ms, i_plain, i_bytes)
    step_ms = cuda_ms(lambda: step(words, kmers, mask), 20, DEVICE)
    step_plain = cuda_ms(lambda: plain.batched_counts(
        words, kmer_hash.kmer_rows_plain(*i_args, True, M).view(b, kmax, H), mask), 5, DEVICE)
    step_bytes = i_bytes + bound_bytes("classic_counts", words, rows.view(b, kmax, H), mask)
    j_seeds = torch.arange(H, dtype=torch.int32, device=DEVICE)
    j_ms = cuda_ms(lambda: fl.bloom_scatter(sample, j_seeds, "classic", M), 10, DEVICE)
    j_plain = cuda_ms(lambda: build.bloom_plain(sample, j_seeds, "classic", M), 2, DEVICE)
    j_bytes = bound_bytes("bloom_scatter", sample, blooms_j["classic"])
    record(kernel_ms, "bloom_scatter", j_ms, j_plain, j_bytes)
    jb_ms = cuda_ms(lambda: build.device_bloom(sample, m=M, h=H, layout="blocked"), 10, DEVICE)
    # I on the sample does J's reads and hashing but not its atomics (it writes its rows)
    ij_ms = cuda_ms(lambda: fl.kmer_rows(sample, j_seeds, "classic", canonical=True, m=M), 10,
                    DEVICE)
    sl = blooms[:, :4096].contiguous()
    errors.compare("bloom_transpose", (fl.bloom_transpose(sl, sl.shape[1] * 32),),
                   (build.transpose_plain(sl, sl.shape[1] * 32),),
                   "a slice of the full size: N=%d m=%d" % (sl.shape[0], sl.shape[1] * 32))
    del sl
    k_ms = cuda_ms(lambda: fl.bloom_transpose(blooms, M), 5, DEVICE)
    k_plain = cuda_ms(lambda: build.transpose_plain(blooms, M, rows_chunk=1 << 18), 1, DEVICE)
    dst = torch.empty_like(blooms)
    floor = cuda_ms(lambda: dst.copy_(blooms), 5, DEVICE)
    del dst
    k_bytes = bound_bytes("bloom_transpose", blooms, words)
    record(kernel_ms, "bloom_transpose", k_ms, k_plain, k_bytes)
    del blooms
    for what, ms, p_ms, moved in (
            ("kmer_rows (I), the classic batch's %d k-mers" % (b * kmax), i_ms, i_plain, i_bytes),
            ("the full step (I + A), B=%d K=%d" % (b, kmax), step_ms, step_plain, step_bytes),
            ("bloom_scatter (J), %d k-mers classic" % KMERS_PER_SAMPLE, j_ms, j_plain, j_bytes),
            ("bloom_transpose (K), N=%d m=%d" % (N, M), k_ms, k_plain, k_bytes)):
        print("phase %d times %s [%s]: %.4f ms vs plain PyTorch %.4f ms; bound %.4f ms by "
              "bytes (%.2f MB), %.3f of bound" % (number, what, gpu, ms, p_ms, bound_ms(moved),
                                                   moved / 1e6, bound_ms(moved) / ms), flush=True)
    print("phase %d times [%s]: bloom_scatter classic %.4f ms = hashing (kmer_rows on the same "
          "%d k-mers, classic rows, canonical) %.4f ms + atomics %.4f ms; blocked/32 %.4f ms"
          % (number, gpu, j_ms, KMERS_PER_SAMPLE, ij_ms, j_ms - ij_ms, jb_ms), flush=True)
    print("phase %d times [%s]: bloom_transpose beside a torch copy_ of its %.1f MB of blooms "
          "%.4f ms (K / copy %.3f); the phase took %.1f s"
          % (number, gpu, nbytes(words) / 1e6, floor, k_ms / floor, time.perf_counter() - t0),
          flush=True)
    return kernel_ms, counted


# -- phase 13 -----------------------------------------------------------

# the meshes of phase 13, one handle at a time: each reopens an index of
# phases 4-9 with ``engine: mesh`` and ``mesh`` as given, every position
# on one card (the single-controller engine takes repeated devices)
MESHES = (
    ("classic", [2, 2, 2]),  # kernel A; the k-axis sum and exact AND
    ("classic", [1, 1, 3]),  # phantom samples: W 32 -> 33, W_l = 11
    ("blocked/32", [2, 2, 2]),  # kernel A over the blocked row ids
    (HEADLINE, [2, 1, 4]),  # the seq arm (H + E), then E alone
    ("minimizer/64", [2, 1, 2]),  # kernel C
    ("minimizer/64", [2, 1, 2, 2]),  # kernel C over row slabs
    (VERIFIED, [2, 1, 4]),  # the screen (E); the verify stays on the host
)
MESH_KERNELS = ("classic_counts", "grouped_tile_counts", "pack_tile_cols", "cols_counts",
                "seq_streams", PRESENCE)
MESH_DEVICE = "cuda:0"
MESH_STEP_KERNELS = ("classic_counts", "grouped_tile_counts", "cols_counts", "seq_streams",
                     PRESENCE)
LOAD_SLACK = 256 << 20  # device bytes a mesh load may hold beside its shards (staging)


@contextlib.contextmanager
def uncounted(fns):
    """Launches inside the block do not count: the counts are put back
    after it (comparisons with plain versions, the single-device
    reference handles)."""
    saved = {k: fn.launches for k, fn in fns.items()}
    try:
        yield
    finally:
        for k, fn in fns.items():
            fn.launches = saved[k]


def shard_tensors(engine) -> list:
    shards = next(p for p in (engine.words, engine.cols, engine.tiles) if p is not None)
    return list(shards.values())


def mesh_launches(engine, seq: bool) -> dict:
    """The launches of one search_batch on a mesh engine: its step's
    kernel once per position (the seq arm: H once per batch shard on the
    one card, then E once per position)."""
    positions = engine.step_mesh.devices.size
    if engine.words is not None:
        return {"classic_counts": positions}
    if engine.tiles is not None:
        return {"grouped_tile_counts": positions}
    if seq:
        return {"seq_streams": engine.step_mesh.shape["d"], "cols_counts": positions}
    return {"cols_counts": positions}


def step_kernel_args(fns, run):
    """Runs ``run()`` with the mesh steps' kernels recorded (as the mesh
    engine and the fleet's service call them): -> (its result, {kernel:
    (args, keyword args) of its first launch}, {kernel: launches})."""
    from bigsi_tpu_torch.parallel import distributed, sharding

    first = {}

    def spy(name, real):
        def call(*args, **kw):
            first.setdefault(name, (args, kw))
            return real(*args, **kw)
        return call

    before = {k: fn.launches for k, fn in fns.items()}
    patched = [(module, name) for module in (sharding, distributed) for name in MESH_STEP_KERNELS
               if hasattr(module, name)]
    for module, name in patched:
        setattr(module, name, spy(name, fns[name]))
    try:
        out = run()
    finally:
        for module, name in patched:
            setattr(module, name, fns[name])
    return out, first, {k: fn.launches - before[k] for k, fn in fns.items()
                        if fn.launches != before[k]}


def presence_shard_checks(fns, run, errors: Errors, case: str) -> int:
    """Kernel L's every launch in ``run()`` (through the mesh engine or
    the fleet's service: a scored search, a rank's presence part), on
    every sample shard and row slab, held to its plain version on the
    same inputs.  -> the launches checked."""
    from bigsi_tpu_torch.ops import lookup as plain
    from bigsi_tpu_torch.parallel import distributed, sharding

    calls = []

    def spy(*args, **kw):
        out = fns[PRESENCE](*args, **kw)
        calls.append((args, kw, out))
        return out

    for module in (sharding, distributed):
        module.presence_rows = spy
    try:
        run()
    finally:
        for module in (sharding, distributed):
            module.presence_rows = fns[PRESENCE]
    for i, (args, kw, out) in enumerate(calls):
        errors.compare(PRESENCE, (out,), (plain.presence_rows(*args, **kw),),
                       "%s launch %d" % (case, i))
    return len(calls)


def a_exact_checks(words, gen, errors: Errors) -> list:
    """Kernel A on a mesh shard with queries of no valid k-mer (an empty
    k-slice) at B = 256 (one block a query) and B = 2 (queries split over
    blocks): its exact words must be all ones there, as the plain
    version's, for ``and_all`` to keep them.  -> the splits checked."""
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    sms = torch.cuda.get_device_properties(words.device).multi_processor_count
    splits = []
    for b, k in ((B, 256), (2, 4096)):
        idx = torch.randint(0, words.shape[0], (b, k, H), generator=gen, device=words.device,
                            dtype=torch.int32)
        mask = torch.rand((b, k), generator=gen, device=words.device) < 0.9
        mask[::2] = False
        got, want = fl.classic_counts(words, idx, mask), plain.batched_counts(words, idx, mask)
        errors.compare("classic_counts", got, want, "empty k-slices at B=%d W=%d" % (b, words.shape[1]))
        check(bool((got[1][::2] == plain.ALL_ONES).all()), "A's exact of an empty slice is all ones")
        splits.append(fl.classic_splits(b, k, words.shape[1], sms))
    check(splits[0] == 1 and splits[1] > 1, "both of A's builds checked: splits %s" % splits)
    return splits


def shard_row(narrow: dict, kname: str, kernel, reference, args, kw, name, axes,
              errors: Errors) -> None:
    """Kernel ``kname`` on a mesh's inputs held to its plain version and
    timed beside it, unless it was timed on inputs of this shape
    already; the row goes to ``narrow``."""
    key = (kname, tuple(args[0].shape))
    if any(r["key"] == key for r in narrow.get(kname, [])):
        return
    ms, plain_ms = timed_kernel(kname, partial(kernel, **kw), partial(reference, **kw), args,
                                errors, "%s %s shard" % (name, axes))
    if kname == "seq_streams":  # a batch shard's bytes
        moved = bound_bytes(kname, *args, kernel(*args, **kw)[:3])
        shard = "B = %d, L = %d" % tuple(args[0].shape)
    else:  # a sample shard's words or cols
        moved = bound_bytes(kname, *args, *kw.values())
        cols = kname == "cols_counts" or (kname == PRESENCE and args[1] == "cols")
        shard = "W_l = %d" % (args[0].shape[1] // (32 if cols else 1))
    narrow.setdefault(kname, []).append({
        "key": key, "index": name, "mesh": axes, "shard": shard, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms(moved), "mb": moved / 1e6,
        "shape": [list(a.shape) for a in args if hasattr(a, "shape")]})


def time_shards(first: dict, name: str, axes, errors: Errors, narrow: dict) -> None:
    """A, C, E, H and L on the inputs of their first launches in a run
    (one search_batch, or a scored search and search_batch), beside their
    plain versions."""
    from bigsi_tpu_torch.ops import lookup as plain
    from bigsi_tpu_torch.ops import prep as plain_prep

    plains = {"classic_counts": plain.batched_counts, "grouped_tile_counts": plain.grouped_counts,
              "cols_counts": plain.grouped_counts_cols, "seq_streams": plain_prep.prep_streams,
              PRESENCE: lambda *a, **kw: (plain.presence_rows(*a, **kw),)}
    kernels = dict(kernel_fns(), **{PRESENCE: lambda *a, **kw: (kernel_fns()[PRESENCE](*a, **kw),)})
    for kname, (args, kw) in first.items():
        shard_row(narrow, kname, kernels[kname], plains[kname], args, kw, name, axes, errors)


def pack_shard_checks(words, tile_rows: int, cols: dict, name: str, axes, errors: Errors,
                      narrow: dict) -> int:
    """Each cols shard ``{(device, j): cols}`` held to kernel D's plain
    version over its column slice of ``words`` (the columns its sample
    shards cover), one load chunk of whole tiles at a time (the chunks D
    packed at load); D timed on the first.  -> the chunks compared."""
    import torch

    from bigsi_tpu_torch.index.device_engine import LOAD_CHUNK_ROWS
    from bigsi_tpu_torch.ops import lookup as plain

    rows = max(1, LOAD_CHUNK_ROWS // tile_rows) * tile_rows
    compared = 0
    for (dev, j), shard in cols.items():
        w_l = shard.shape[1] // 32
        view = words[:, j * w_l: (j + 1) * w_l]
        for t0 in range(0, shard.shape[0], rows // tile_rows):
            t1 = min(shard.shape[0], t0 + rows // tile_rows)
            block = np.zeros(((t1 - t0) * tile_rows, w_l), dtype=np.uint32)
            part = view[t0 * tile_rows: t1 * tile_rows]
            block[: part.shape[0], : part.shape[1]] = part
            chunk = torch.from_numpy(block.view(np.int32)).to(dev)
            errors.compare("pack_tile_cols", (shard[t0:t1],),
                           (plain.pack_tile_cols(chunk, tile_rows),),
                           "%s %s shard %d tiles [%d, %d)" % (name, axes, j, t0, t1))
            if not compared:
                shard_row(narrow, "pack_tile_cols", kernel_fns()["pack_tile_cols"],
                          plain.pack_tile_cols, (chunk, tile_rows), {}, name, axes, errors)
            compared += 1
    return compared


def mesh_arm(arm: str, name: str, axes, port, single, seqs, want: dict, fns) -> tuple:
    """One arm of a mesh handle: search_batch at 1.0 (its kernels' launches
    and first arguments recorded) and 0.7 against the single-device
    handle's, then 5 timed calls of each handle.  The k-mer arm turns the
    seq arm off on both engine instances.  -> (a line, first args, the
    number of result lists compared)."""
    engine = port.screen_engine if name == VERIFIED else port.engine
    if arm == "k-mer":
        engine.supports_seq_batch = single.engine.supports_seq_batch = lambda: False
    served = []
    if arm == "seq":
        real = engine.counts_batch_seqs
        engine.counts_batch_seqs = lambda *a: served.append(real(*a)) or served[-1]
    parts = VERIFIED_PARTS if name == VERIFIED else BATCH_PARTS
    try:
        got, first, launched = step_kernel_args(fns, lambda: port.search_batch(seqs, 1.0))
        check(got == want[1.0] and port.search_batch(seqs, 0.7) == want[0.7],
              "%s %s %s arm: search_batch at 1.0 and 0.7 equals the single-device engine's"
              % (name, axes, arm))
        expect = mesh_launches(engine, arm == "seq")
        check(launched == expect and all(x is not None for x in served),
              "%s %s %s arm: one search_batch launched %s (expected %s), seq arm served %s"
              % (name, axes, arm, launched, expect, [x is not None for x in served]))
        calls = search_batch_layers(port, seqs, 5, parts=parts)
        with uncounted(fns):
            ref_calls = search_batch_layers(single, seqs, 5, parts=parts)
        mid, ref = median_call(calls), median_call(ref_calls)
    finally:
        for obj in (engine, single.engine):
            obj.__dict__.pop("supports_seq_batch", None)
        engine.__dict__.pop("counts_batch_seqs", None)
    inner = "screen" if name == VERIFIED else "counts"
    line = ("%s arm: search_batch median of 5 %.3f ms (%.1f queries/s), %s %.3f ms; "
            "single-device %.3f ms, %s %.3f ms; launches a search_batch %s; the calls: mesh "
            "%s, single-device %s"
            % (arm, mid["search_batch"], B / mid["search_batch"] * 1e3, parts[inner], mid[inner],
               ref["search_batch"], parts[inner], ref[inner], json.dumps(launched),
               json.dumps([[c["search_batch"], c[inner]] for c in calls]),
               json.dumps([[c["search_batch"], c[inner]] for c in ref_calls])))
    return line, first, 2 * len(seqs)


def mesh_handle(number: int, gpu: str, name: str, axes, runs, gen, errors: Errors, fns,
                narrow: dict) -> None:
    """Reopens index ``name`` of phases 4-9 on ``engine: mesh`` over
    ``axes`` on one card, holds its answers to the single-device
    handle's, times it, and drops it (its shards must be freed)."""
    import gc

    import torch

    from bigsi_tpu_torch import BIGSI

    single, seqs = runs[name]
    q20 = "".join(seqs)[:20_000]
    verified = name == VERIFIED
    held_before = torch.cuda.memory_allocated()
    packed = fns["pack_tile_cols"].launches
    port, load_s, peak = on_device(
        lambda: BIGSI(dict(single.config, engine="mesh", mesh=axes), device=MESH_DEVICE))
    packed = fns["pack_tile_cols"].launches - packed
    engine = port.screen_engine if verified else port.engine
    shards = shard_tensors(engine)
    held, count, shape = nbytes(*shards), len(shards), list(shards[0].shape)
    check(type(engine).__name__ == "MeshEngine"
          and count == engine.step_mesh.shape["s"] * engine.step_mesh.shape.get("r", 1),
          "%s %s: a mesh engine holding one tensor per sample shard (and slab)" % (name, axes))
    check(peak < held + LOAD_SLACK, "%s %s: the load's peak %d B stays under the shards' %d B "
          "plus staging" % (name, axes, peak, held))
    del shards
    with uncounted(fns):
        chunks = (pack_shard_checks(np.asarray(engine.matrix.words), engine.tile_rows, engine.cols,
                                    name, axes, errors, narrow) if engine.cols else 0)
        want = {t: single.search_batch(seqs, t) for t in (1.0, 0.7)}
        want_one = {(q, t): single.search(q, t) for q in (seqs[0], q20) for t in (1.0, 0.7)}
        want_scored = (single.search(seqs[0], 0.7, score=True),
                       single.search_batch(seqs, 0.7, score=True))
    for (q, t), w in want_one.items():
        check(port.search(q, t) == w, "%s %s: search of %d bp at %.1f equals the single-device "
              "engine's" % (name, axes, len(q), t))
    scored, first, launched = step_kernel_args(fns, lambda: (
        port.search(seqs[0], 0.7, score=True), port.search_batch(seqs, 0.7, score=True)))
    check(scored == want_scored,
          "%s %s: scored search and search_batch equal the single-device engine's" % (name, axes))
    # kernel L once per sample shard (or slab) for the search and for each
    # hit query of the batch; a verified index scores on its host engine
    hits = sum(1 for r in scored[1] if r)
    want_l = 0 if verified else count * (1 + hits)
    check(launched.get(PRESENCE, 0) == want_l,
          "%s %s: the scored search and search_batch (%d hit queries) launched kernel L %d "
          "times (expected %d)" % (name, axes, hits, launched.get(PRESENCE, 0), want_l))
    with uncounted(fns):  # L on every shard of this mesh, timed on the first
        time_shards({k: v for k, v in first.items() if k == PRESENCE}, name, axes, errors,
                    narrow)
        l_held = presence_shard_checks(fns, lambda: port.search(seqs[0], 0.7, score=True),
                                       errors, "%s %s scored search" % (name, axes))
    check(l_held == (0 if verified else count),
          "%s %s: kernel L held to its plain version on each of the %d shards and slabs (%d)"
          % (name, axes, count, l_held))
    del first
    check(packed == chunks, "%s %s: the load launched kernel D %d times, once a chunk of each "
          "cols shard (%d)" % (name, axes, packed, chunks))
    compared = len(want_one) + 1 + len(seqs)
    arms = ("seq", "k-mer") if engine.supports_seq_batch() and not verified else ("counts_batch",)
    lines = []
    for arm in arms:
        line, first, n = mesh_arm(arm, name, axes, port, single, seqs, want, fns)
        lines.append(line)
        compared += n
        with uncounted(fns):  # A, C and E on this mesh's shards, beside their plain versions
            time_shards(first, name, axes, errors, narrow)
            if name == "classic" and axes == [2, 2, 2]:
                lines.append("kernel A on a W_l = 16 shard: the exact words of empty k-slices "
                             "all ones at splits %s"
                             % a_exact_checks(first["classic_counts"][0][0], gen, errors))
        del first
    if packed:
        shape = ("%s; kernel D launched %d times, each chunk equal to D's plain version over "
                 "its column slice" % (shape, packed))
    print("phase %d mesh %s %s [%s]: load %.3f s, device peak %.4f GB (shards %.4f GB: %d x %s); "
          "%d results equal the single-device engine's (search_batch at 1.0 and 0.7, search of "
          "%d bp and %d bp at 1.0 and 0.7, scored search and search_batch at 0.7, kernel L "
          "launched %d times for them, each of a scored search's %d launches equal to L's "
          "plain version); %s"
          % (number, name, axes, gpu, load_s, peak / 1e9, held / 1e9, count, shape, compared,
             QUERY_LEN, len(q20), want_l, l_held, "; ".join(lines)), flush=True)
    del port, engine
    gc.collect()
    check(torch.cuda.memory_allocated() <= held_before,
          "%s %s: dropping the handle frees its shards" % (name, axes))


def mesh_mutation(rng) -> tuple[int, int]:
    """An interior insert on a small classic index on a [2, 2, 2] mesh:
    the old engine's shards are freed before the new ones are placed,
    and the results follow the new matrix.  -> (bytes allocated before,
    after)."""
    import gc

    import torch

    from bigsi_tpu_torch import BIGSI
    from bigsi_tpu_torch.kmers import seq_to_kmers
    from bigsi_tpu_torch.storage import get_storage

    config = {"storage-engine": "memory", "storage-config": {"filename": "chip-smoke-mesh-mut"},
              "k": K_LEN, "m": MUTATION_M, "h": H, "engine": "mesh", "mesh": [2, 2, 2]}
    get_storage(config).delete_all()
    genomes = [random_seq(rng, 1000) for _ in range(8)]
    port = BIGSI.build(config, [BIGSI.bloom(config, seq_to_kmers(g, K_LEN)) for g in genomes],
                       ["s%d" % i for i in range(8)], device=MESH_DEVICE)
    held = nbytes(*shard_tensors(port.engine))
    before = torch.cuda.memory_allocated()
    new = random_seq(rng, 1000)
    port.insert_bloom(BIGSI.bloom(config, seq_to_kmers(new, K_LEN)), 2)
    gc.collect()
    after = torch.cuda.memory_allocated()
    host = BIGSI(dict(config, engine="numpy"))
    queries = [new[:400]] + [g[:400] for g in genomes]
    check(after - before < held // 2 and type(port.engine).__name__ == "MeshEngine"
          and port.search_batch(queries, 0.7) == host.search_batch(queries, 0.7)
          and "s2" in {r["sample_name"] for r in port.search(new[:400], 1.0)},
          "the mesh engine after an insert: %d B allocated before, %d after (shards %d B); "
          "results equal the host engine's" % (before, after, held))
    get_storage(config).delete_all()
    return before, after


def phase_mesh(number: int, gpu: str, runs, gen, rng, errors: Errors, fns):
    """The mesh path: the handles of MESHES, their launches counted from
    0; then, uncounted, an insert on a small mesh index and the dry run.
    -> ({kernel: [its timings on mesh inputs]}, {kernel: launches of the
    mesh path})."""
    import torch

    from bigsi_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    narrow = {}
    for fn in fns.values():
        fn.launches = 0
    for name, axes in MESHES:
        mesh_handle(number, gpu, name, axes, runs, gen, errors, fns, narrow)
    torch.cuda.synchronize()
    counted = {k: fn.launches for k, fn in fns.items()}
    with uncounted(fns):
        before, after = mesh_mutation(rng)
        dryrun_multichip(8, device=MESH_DEVICE)
    check(all(counted[k] > 0 for k in MESH_KERNELS) and
          not any(n for k, n in counted.items() if k not in MESH_KERNELS),
          "the meshes launched %s and no other: %s" % (MESH_KERNELS, counted))
    for kname, rows in narrow.items():
        for r in rows:
            print("phase %d mesh kernel %s [%s]: %s %s shard %s (%s) %.4f ms vs plain "
                  "PyTorch %.4f ms, bound %.4f ms by bytes (%.1f MB), %.3f of bound (cold L2)"
                  % (number, kname, gpu, r["index"], r["mesh"], r["shard"], r["shape"], r["ms"],
                     r["plain_ms"], r["bound_ms"], r["mb"], r["bound_ms"] / r["ms"]), flush=True)
    print("phase %d mesh [%s]: after an interior insert the small mesh index held %d B (before "
          "%d B); dryrun_multichip(8, device=%r) passed; launches of the meshes' handles %s; "
          "the phase took %.1f s"
          % (number, gpu, after, before, MESH_DEVICE, json.dumps(counted),
             time.perf_counter() - t0), flush=True)
    return {k: [{x: r[x] for x in ("index", "mesh", "shard", "ms", "plain_ms", "bound_ms")}
                for r in rows] for k, rows in narrow.items()}, counted


# -- phase 14: multi-process serving --------------------------------------


DIST_WORLD = 2
DIST_MESH = [2, 1, 2]
DIST_DEVICE = "cuda:0"  # both ranks share the one card, each in its own process and context
DIST_INDEXES = ("classic", HEADLINE)
DIST_KERNELS = ("classic_counts", "grouped_tile_counts", "pack_tile_cols", "cols_counts",
                "seq_streams", PRESENCE)
RANK_TIMEOUT = 300  # s, each rank process
STOP_TIMEOUT = 60  # s, for both ranks to exit after SIGINT to rank 0
DIST_REPS = 5


def dist_config(name: str, root: Path) -> dict:
    return {"storage-engine": "bigsi-tpu",
            "storage-config": {"filename": str(root / name.replace("/", "-"))},
            "k": K_LEN, "m": M, "h": H, **INDEXES[name][0]}


def facade_rows(port, seqs):
    """The row ids and mask the facade's k-mer path builds for ``seqs``:
    -> (int32[B, K, h], bool[B, K])."""
    from bigsi_tpu_torch.kmers import seq_to_kmer_matrix, unique_rows_with_inverse

    rows = [port.kmer_matrix_to_row_idx(unique_rows_with_inverse(seq_to_kmer_matrix(s, K_LEN))[0])
            for s in seqs]
    idx = np.zeros((len(rows), max(r.shape[0] for r in rows), H), dtype=np.int32)
    mask = np.zeros(idx.shape[:2], dtype=bool)
    for i, r in enumerate(rows):
        idx[i, : r.shape[0]] = r
        mask[i, : r.shape[0]] = True
    return idx, mask


def facade_bytes(seqs):
    """The facade's padded query bytes and lengths."""
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    padded = np.full((len(seqs), int(lens.max())), ord("A"), dtype=np.uint8)
    for i, s in enumerate(seqs):
        padded[i, : len(s)] = np.frombuffer(s.encode(), dtype=np.uint8)
    return padded, lens


def median_ms(fn, reps: int = DIST_REPS) -> tuple[float, list]:
    """Median and every time of ``reps`` calls of ``fn`` (host clock, ms),
    after one call at the same shape."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], times


# the legs of one dispatch on rank 0's host clock, in call order
LEGS = ("pad", "pack", "header", "buffer", "part", "gather", "join", "other")


class Legs:
    """Rank 0's host clock on the legs of its dispatches (ms, summed over
    one call): ``pad`` before ``_dispatch``, the buffer's ``pack``, the
    ``header`` and ``buffer`` broadcasts, rank 0's own ``part``, the
    ``gather`` (which waits for the slowest rank's part), the ``join``
    after ``_dispatch``, and ``other``, the rest of the call."""

    def __init__(self):
        self.ms, self.marks = {}, {}

    @contextlib.contextmanager
    def leg(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def call(self, fn) -> dict:
        """One call of ``fn`` split into its legs."""
        self.ms.clear()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        row = dict(self.ms, pad=(self.marks["enter"] - t0) * 1e3,
                   join=(t1 - self.marks["exit"]) * 1e3)
        row["other"] = (t1 - t0) * 1e3 - sum(row.values())
        row["total"] = (t1 - t0) * 1e3
        return row


@contextlib.contextmanager
def timed_legs(svc, distributed, legs: Legs):
    """Rank 0's dispatches on ``svc`` with their legs timed into ``legs``:
    torch.distributed as the service's module sees it (its broadcasts and
    its gather), the module's ``_pack``, and the entry to and exit from
    the service's ``_dispatch``."""
    import torch
    import torch.distributed as tdist

    class Group:
        def __getattr__(self, name):
            return getattr(tdist, name)

        @staticmethod
        def broadcast(tensor, src):
            with legs.leg("header" if tensor.dtype == torch.int64 else "buffer"):
                return tdist.broadcast(tensor, src=src)

        @staticmethod
        def gather(tensor, gather_list=None, dst=0):
            with legs.leg("gather"):
                return tdist.gather(tensor, gather_list, dst=dst)

    real_pack, real_dispatch = distributed._pack, svc._dispatch

    def pack(arrays):
        with legs.leg("pack"):
            return real_pack(arrays)

    def dispatch(*args, **kw):
        legs.marks["enter"] = time.perf_counter()
        try:
            return real_dispatch(*args, **kw)
        finally:
            legs.marks["exit"] = time.perf_counter()

    distributed.dist, distributed._pack, svc._dispatch = Group(), pack, dispatch
    try:
        yield
    finally:
        distributed.dist, distributed._pack = tdist, real_pack
        del svc._dispatch


def dist_dispatch(svc, row_shards: int, root: Path, legs: Legs) -> dict:
    """Rank 0's dispatches on one service: the four ops (or with row
    shards the grouped op and presence), each result saved for the
    parent, each op timed at its cached shape, leg by leg."""
    inp = dict(np.load(root / "inputs.npz"))
    ops = {"grouped": lambda: svc.query_grouped(inp["utile"], inp["gmask"]),
           "presence": lambda: svc.presence(inp["pidx"])}
    if row_shards == 1:
        ops["query"] = lambda: svc.query(inp["idx"], inp["mask"])
        ops["seqs"] = lambda: svc.query_seqs(inp["seqs"], inp["lens"], K_LEN, H)
    out, times = {}, {}
    for op, call in ops.items():
        got = call()
        check(got is not None, "the fleet's %s op served (no entry-budget overflow)" % op)
        for i, part in enumerate(got if isinstance(got, tuple) else (got,)):
            out["%s%d" % (op, i)] = part
        call()  # one more at the same shape, as median_ms does
        rows = [legs.call(call) for _ in range(DIST_REPS)]
        times[op] = {name: sorted(r.get(name, 0.0) for r in rows)[DIST_REPS // 2]
                     for name in LEGS + ("total",)}
        times[op]["times"] = [r["total"] for r in rows]
    np.savez(root / ("rank0-r%d.npz" % row_shards), **out)
    return {"r%d" % row_shards: times}


def dist_rank(rank: int, port: int, root: Path) -> None:
    """One rank of the service fleet (``--dist-rank``): the minimizer/16
    index's rows.bin mmap on a [2, 1, 2] mesh over 2 ranks, then with 2
    row shards; its launches counted from 0 and printed.  After each
    service, uncounted and one rank at a time (the other waits on the
    host), the kernels of this rank's steps are held to their plain
    versions on the inputs of their first launch, and each cols chunk
    D packed to D's plain version."""
    import gc
    import mmap

    import torch

    from bigsi_tpu_torch.parallel import distributed
    from bigsi_tpu_torch.storage import get_storage

    check(torch.cuda.is_available(), "rank %d sees a CUDA device" % rank)
    fns = kernel_fns()
    distributed.initialize("127.0.0.1:%d" % port, DIST_WORLD, rank)
    words = get_storage(dist_config(HEADLINE, root)).load_matrix().words
    base = words
    while base is not None and not isinstance(base, mmap.mmap):
        base = getattr(base, "base", None)
    check(base is not None, "rank %d reads the rows.bin mmap" % rank)
    mesh = distributed.make_global_mesh(DIST_MESH, device=DIST_DEVICE)
    for fn in fns.values():
        fn.launches = 0
    out, errors, narrow, legs, chunks = {}, Errors(), {}, Legs(), 0
    names = {distributed.OP_QUERY: "query", distributed.OP_GROUPED: "grouped",
             distributed.OP_SEQS: "seqs", distributed.OP_PRESENCE: "presence"}
    for row_shards in (1, 2):
        svc = distributed.DistributedQueryService(
            words, mesh, m=M, layout="minimizer", tile_rows=16, run_len=HEADLINE_R,
            row_shards=row_shards, minimizer_window=19, slot_scheme=3, device=DIST_DEVICE)
        parts, real = {}, svc._part

        def timed(op, arrays, k, h, _parts=parts, _real=real):
            """This rank's part of each dispatch on the host clock (its
            copies in, kernels and copies out; the first also places)."""
            with legs.leg("part"):
                t0 = time.perf_counter()
                got = _real(op, arrays, k, h)
                _parts.setdefault(names[op], []).append((time.perf_counter() - t0) * 1e3)
            return got

        svc._part = timed
        presence = fns[PRESENCE].launches
        if rank:
            _, first, _ = step_kernel_args(fns, svc.run_worker_loop)
        else:
            with timed_legs(svc, distributed, legs):
                got, first, _ = step_kernel_args(fns, lambda: dist_dispatch(svc, row_shards, root,
                                                                            legs))
            out.update(got)
            svc.stop()
        # kernel L once per local sample shard (and row slab) a presence op
        sub = (svc.mesh if row_shards == 1 else svc.rows_mesh).local(rank)
        per = sub.shape["s"] * sub.shape.get("r", 1)
        presence = fns[PRESENCE].launches - presence
        check(presence == per * len(parts["presence"]),
              "rank %d: %d presence ops launched kernel L %d times, %d each"
              % (rank, len(parts["presence"]), presence, per))
        out["presence_r%d" % row_shards] = {"per_op": per, "launches": presence}
        held = sum(nbytes(*p.values()) for p in svc._placed.values())
        out["held_r%d" % row_shards] = held
        out["parts_r%d" % row_shards] = {op: {"first": t[0], "median": sorted(t[-DIST_REPS:])[
            DIST_REPS // 2]} for op, t in parts.items()}
        axes = DIST_MESH + ([row_shards] if row_shards > 1 else [])
        for turn in range(DIST_WORLD):
            if turn == rank:
                with uncounted(fns):
                    time_shards(first, "%s rank %d" % (HEADLINE, rank), axes, errors, narrow)
                    pidx = np.load(root / "inputs.npz")["pidx"]
                    checked = presence_shard_checks(
                        fns, lambda: svc._presence_part(torch.from_numpy(pidx)), errors,
                        "%s rank %d %s presence part" % (HEADLINE, rank, axes))
                    check(checked == per, "rank %d: kernel L held to its plain version on each "
                          "of its %d shards and slabs (%d)" % (rank, per, checked))
                    if "cols" in svc._placed:
                        view, _ = distributed._local_word_slice(words, svc.flat, rank)
                        chunks += pack_shard_checks(view, svc.tile_rows, svc._placed["cols"],
                                                    "%s rank %d" % (HEADLINE, rank), axes,
                                                    errors, narrow)
                torch.cuda.synchronize()
            torch.distributed.barrier()
        del svc, first
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launched = {k: fn.launches for k, fn in fns.items() if fn.launches}
    check(launched.get("pack_tile_cols", 0) == chunks,
          "rank %d: kernel D launched %d times, once a chunk of its cols shards (%d)"
          % (rank, launched.get("pack_tile_cols", 0), chunks))
    out["kernels"] = {k: [{x: r[x] for x in ("index", "mesh", "shard", "shape", "ms", "plain_ms",
                                             "bound_ms", "mb")} for r in rows]
                      for k, rows in narrow.items()}
    out["max_err"] = errors.max
    out["chunks"] = chunks
    print("LAUNCHES " + json.dumps(launched))
    print("RESULT " + json.dumps(out), flush=True)
    distributed.shutdown()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Fleet:
    """Rank processes started together, their output in files under
    ``root``; ``finish`` waits for each, fails on a non-zero exit or a
    timeout with the rank's stderr tail, and no rank outlives the
    block."""

    def __init__(self, name: str, root: Path, cmds, envs):
        import subprocess

        self.logs = [(root / ("%s-%d.out" % (name, r)), root / ("%s-%d.err" % (name, r)))
                     for r in range(len(cmds))]
        self.procs = []
        for (out, err), cmd, env in zip(self.logs, cmds, envs):
            with open(out, "w") as fo, open(err, "w") as fe:
                self.procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=fo,
                                                   stderr=fe, stdin=subprocess.DEVNULL))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def tail(self, r: int) -> str:
        return self.logs[r][1].read_text()[-3000:]

    def alive(self) -> bool:
        return all(p.poll() is None for p in self.procs)

    def finish(self, timeout: float) -> list[str]:
        """-> each rank's stdout, once all exited 0 within ``timeout`` s."""
        import subprocess

        deadline = time.monotonic() + timeout
        for r, p in enumerate(self.procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                print(self.tail(r), file=sys.stderr)
                check(False, "rank %d of %s exited within %.0f s" % (r, self.logs[r][0].stem,
                                                                        timeout))
            if p.returncode != 0:
                print(self.tail(r), file=sys.stderr)
                check(False, "rank %d of %s exited 0 (got %d)" % (r, self.logs[r][0].stem,
                                                                   p.returncode))
        return [out.read_text() for out, _ in self.logs]


def tagged(text: str, tag: str) -> dict:
    return json.loads(next(x for x in text.splitlines() if x.startswith(tag + " "))[len(tag) + 1:])


def service_fleet(number: int, gpu: str, single, seqs, root: Path, fns,
                  errors: Errors) -> tuple[dict, dict]:
    """The service fleet on the minimizer/16 index: every op's result
    bit-equal to the single-device engine's on the same inputs (query to
    kernel A's plain version), each rank launching A, C, D, E and H and
    no other kernel, and holding each to its plain version on the inputs
    its steps gave it.  -> (the ranks' launches summed, {kernel: the
    ranks' timings on those inputs})."""
    import torch

    from bigsi_tpu_torch.hashing.scheme import window_to_s
    from bigsi_tpu_torch.index.device_engine import (
        DeviceEngine,
        seq_batch_geometry,
        tile_streams,
    )
    from bigsi_tpu_torch.ops import lookup as plain

    idx, mask = facade_rows(single, seqs)
    tile, smask = tile_streams(torch.from_numpy(idx), torch.from_numpy(mask), 16)
    utile, gmask = plain.build_grouped_streams(tile, smask, HEADLINE_R)
    padded, lens = facade_bytes(seqs)
    geom = seq_batch_geometry(padded, lens, K_LEN, K_LEN - window_to_s(K_LEN, 19) + 1,
                              db=DIST_MESH[0] * DIST_MESH[1])
    check(geom is not None, "the geometry guard admits the batch")
    pidx = idx[0][mask[0]]
    np.savez(root / "inputs.npz", idx=idx, mask=mask, utile=utile.numpy(), gmask=gmask.numpy(),
             seqs=geom[0], lens=geom[1], pidx=pidx)
    port = free_port()
    cmds = [[sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank", str(r), "--dist-port",
             str(port), "--dist-dir", str(root)] for r in range(DIST_WORLD)]
    import os

    t0 = time.perf_counter()
    with Fleet("service", root, cmds, [dict(os.environ)] * DIST_WORLD) as fleet:
        outs = fleet.finish(RANK_TIMEOUT)
    fleet_s = time.perf_counter() - t0
    launches = [tagged(o, "LAUNCHES") for o in outs]
    ranks = [tagged(o, "RESULT") for o in outs]
    res = ranks[0]
    got = {r: dict(np.load(root / ("rank0-r%d.npz" % r))) for r in (1, 2)}
    with uncounted(fns):
        ref_a = DeviceEngine(single.bitmatrix, device=DEVICE)  # classic layout: kernel A on words
        counts, exact = (t.cpu().numpy() for t in plain.batched_counts(
            ref_a.words, torch.from_numpy(idx).to(DEVICE), torch.from_numpy(mask).to(DEVICE)))
        want_c = single.engine.counts_batch(idx, mask, N)
        want_s = single.engine.counts_batch_seqs(padded, lens, K_LEN, H, N)
        want_p = single.engine.presence_matrix(single.engine.and_rows(pidx), N)
        ref_ms = {
            "query": median_ms(lambda: [t.cpu() for t in ref_a._reduce(idx, mask)]),
            "grouped": median_ms(lambda: single.engine.counts_batch(idx, mask, N)),
            "seqs": median_ms(lambda: single.engine.counts_batch_seqs(padded, lens, K_LEN, H, N)),
            "presence": median_ms(lambda: single.engine.presence_matrix(
                single.engine.and_rows(pidx), N)),
        }
        del ref_a
    b = len(seqs)
    r1, r2 = got[1], got[2]
    check(np.array_equal(r1["query0"], counts) and np.array_equal(r1["query1"],
                                                                  exact.view(np.uint32)),
          "the fleet's query (A) equals kernel A's plain version on the whole matrix")
    for r in (1, 2):
        check(np.array_equal(got[r]["grouped0"][:, :N], want_c),
              "the fleet's query_grouped (C%s) equals the single-device engine's"
              % (" over row slabs" if r == 2 else ""))
        bits = np.unpackbits(got[r]["presence0"].view(np.uint8), axis=-1, bitorder="little")
        check(np.array_equal(bits[:, :N], want_p),
              "the fleet's presence rows (row shards %d) equal the single-device engine's" % r)
    check(want_s is not None and np.array_equal(r1["seqs0"][:b, :N], want_s[0])
          and np.array_equal(r1["seqs1"][:b], want_s[1]),
          "the fleet's query_seqs (H, E) equals the single-device counts_batch_seqs")
    for r, counted in enumerate(launches):
        check(set(counted) == set(DIST_KERNELS),
              "rank %d launched %s and no other: %s" % (r, DIST_KERNELS, counted))
        check(set(ranks[r]["kernels"]) == set(DIST_KERNELS),
              "rank %d held %s to their plain versions on its steps' inputs: %s"
              % (r, DIST_KERNELS, sorted(ranks[r]["kernels"])))
    total = {k: sum(c.get(k, 0) for c in launches) for k in DIST_KERNELS}
    shards = {}
    for r, x in enumerate(ranks):
        for kname, err in x["max_err"].items():
            errors.max[kname] = max(errors.max[kname], err)
        for kname, rows in x["kernels"].items():
            for row in rows:
                shards.setdefault(kname, []).append(row)
                print("phase %d distributed kernel %s [%s]: %s %s shard %s (%s) %.4f ms vs plain "
                      "PyTorch %.4f ms, bound %.4f ms by bytes (%.1f MB), %.3f of bound (cold L2), "
                      "equal to its plain version"
                      % (number, kname, gpu, row["index"], row["mesh"], row["shard"], row["shape"],
                         row["ms"], row["plain_ms"], row["bound_ms"], row["mb"],
                         row["bound_ms"] / row["ms"]), flush=True)
        print("phase %d distributed [%s]: rank %d's %d cols chunks equal kernel D's plain version"
              % (number, gpu, r, x["chunks"]), flush=True)
    for rs in ("r1", "r2"):
        for op, t in res[rs].items():
            own = ["rank %d %.3f ms (its first call, which may place: %.3f ms)"
                   % (r, x["parts_" + rs][op]["median"], x["parts_" + rs][op]["first"])
                   for r, x in enumerate(ranks)]
            print("phase %d distributed service [%s] %s%s: fleet dispatch median of %d %.3f ms "
                  "(%s); rank 0's legs, median ms: %s; each rank's own part, median: %s; "
                  "single-device %.3f ms (%s)"
                  % (number, gpu, op, " (2 row shards)" if rs == "r2" else "", DIST_REPS,
                     t["total"], json.dumps([round(x, 3) for x in t["times"]]),
                     ", ".join("%s %.3f" % (leg, t[leg]) for leg in LEGS), ", ".join(own),
                     ref_ms[op][0], json.dumps([round(x, 3) for x in ref_ms[op][1]])), flush=True)
    print("phase %d distributed service [%s]: 2 ranks on %s, mesh %s then %s + 2 row shards, "
          "the minimizer/16 rows.bin mmap; B = %d, K = %d, U = %d, L = %d; every output equal to "
          "the single-device engine's; each rank's placements %s B (row shards: %s B); "
          "launches rank 0 %s, rank 1 %s (kernel L a presence op on each rank: %s); the fleet "
          "took %.1f s"
          % (number, gpu, DIST_DEVICE, DIST_MESH, DIST_MESH, b, idx.shape[1], utile.shape[1],
             geom[0].shape[1], res["held_r1"], res["held_r2"], json.dumps(launches[0]),
             json.dumps(launches[1]),
             json.dumps([{rs: x["presence_" + rs]["per_op"] for rs in ("r1", "r2")}
                         for x in ranks]), fleet_s), flush=True)
    return total, shards


def serve_fleet(number: int, gpu: str, name: str, single, seqs, root: Path, fns) -> None:
    """``python -m bigsi_tpu_torch serve --distributed`` on both ranks of
    index ``name``; rank 0's answers must equal the single-device
    handle's; SIGINT to rank 0 stops both."""
    import os
    import signal
    import urllib.error

    import yaml

    from bigsi_tpu_torch.__main__ import result_dict

    cfg_path = root / ("%s.yaml" % name.replace("/", "-"))
    cfg_path.write_text(yaml.safe_dump(dict(dist_config(name, root), mesh=DIST_MESH)))
    fasta = root / "queries.fasta"
    fasta.write_text("".join(">q%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))
    coord, http_port = free_port(), free_port()
    cmds, envs = [], []
    for r in range(DIST_WORLD):
        cmds.append([sys.executable, "-m", "bigsi_tpu_torch", "serve", "--distributed", "-c",
                     str(cfg_path), "--host", "127.0.0.1", "--port", str(http_port)])
        envs.append(dict(os.environ, PYTHONPATH=str(ROOT),
                         BIGSI_TPU_COORDINATOR="127.0.0.1:%d" % coord,
                         BIGSI_TPU_NUM_PROCESSES=str(DIST_WORLD), BIGSI_TPU_PROCESS_ID=str(r)))
    base = "http://127.0.0.1:%d" % http_port
    q20 = "".join(seqs)[:20_000]
    t0 = time.perf_counter()
    with Fleet("serve-" + name.replace("/", "-"), root, cmds, envs) as fleet:
        while True:
            check(fleet.alive(), "both ranks of %s are up" % name)
            try:
                http_json(base + "/")
                break
            except (urllib.error.URLError, ConnectionError):
                check(time.perf_counter() - t0 < RANK_TIMEOUT, "rank 0 of %s answers" % name)
                time.sleep(0.5)
        up_s = time.perf_counter() - t0

        def get(s, t, score=False):
            q = {"seq": s, "threshold": t, **({"score": 1} if score else {})}
            return http_json(base + "/search?" + urllib.parse.urlencode(q))

        def bulk(t):
            return http_json(base + "/bulk_search?" + urllib.parse.urlencode(
                {"fasta": str(fasta), "threshold": t}))

        with uncounted(fns):
            compared = 0
            for s, t, score in ((seqs[0], 1.0, False), (q20, 0.7, False), (seqs[1], 0.7, True)):
                check(get(s, t, score) == result_dict(s, t, single.search(s, t, score)),
                      "%s distributed GET /search of %d bp at %.1f%s equals the single-device "
                      "handle's" % (name, len(s), t, " scored" if score else ""))
                compared += 1
            for t in (1.0, 0.7):
                want = [result_dict(s, t, r) for s, r in zip(seqs, single.search_batch(seqs, t))]
                check(bulk(t) == want, "%s distributed /bulk_search at %.1f equals the "
                      "single-device search_batch" % (name, t))
                compared += len(seqs)
            burst = seqs[8:16]
            with ThreadPoolExecutor(max_workers=len(burst)) as pool:
                outs = list(pool.map(lambda s: get(s, 0.7), burst))
            check(outs == [result_dict(s, 0.7, single.search(s, 0.7)) for s in burst],
                  "%s: 8 concurrent GETs equal the single-device handle's" % name)
            compared += len(burst)
            try:
                http_json(base + "/insert?bloomfilter=x&sample=y", {})
                status = 200
            except urllib.error.HTTPError as e:
                status = e.code
            check(status == 403, "%s: POST /insert answers 403 (got %d)" % (name, status))
            before = http_json(base + "/metrics")["timers"]
            fleet_ms = median_ms(lambda: bulk(1.0))
            after = http_json(base + "/metrics")["timers"]
            single_ms = median_ms(lambda: single.search_batch(seqs, 1.0))
        # rank 0's own timers over those 6 calls: the fleet's dispatch
        # (search.batch_counts) and result building, per call
        split = {part: (after[timer]["total_s"] - before.get(timer, {}).get("total_s", 0.0))
                 * 1e3 / (DIST_REPS + 1) for part, timer in BATCH_PARTS.items()}
        t1 = time.perf_counter()
        fleet.procs[0].send_signal(signal.SIGINT)
        fleet.finish(STOP_TIMEOUT)
        stop_s = time.perf_counter() - t1
    print("phase %d serve --distributed %s [%s]: 2 ranks on %s, mesh %s; rank 0 answered after "
          "%.1f s; %d result dicts equal the single-device handle's (GET /search of %d bp and %d "
          "bp, one scored; /bulk_search of %d records at 1.0 and 0.7; 8 concurrent GETs), POST "
          "/insert 403; /bulk_search at 1.0 median of %d %.3f ms (%s; rank 0's mean a call: "
          "search.batch_counts %.3f ms, search.batch_results %.3f ms) beside the single-device "
          "search_batch %.3f ms (%s); SIGINT stopped both ranks in %.1f s"
          % (number, name, gpu, DIST_DEVICE, DIST_MESH, up_s, compared, QUERY_LEN, len(q20),
             len(seqs), DIST_REPS, fleet_ms[0], json.dumps([round(t, 3) for t in fleet_ms[1]]),
             split["counts"], split["results"], single_ms[0],
             json.dumps([round(t, 3) for t in single_ms[1]]), stop_s), flush=True)


def phase_distributed(number: int, gpu: str, gen, rng, errors: Errors, fns) -> tuple[dict, dict]:
    """Multi-process serving on one card: two indexes on disk, the
    service fleet, then ``serve --distributed`` of each.  -> (the service
    ranks' launches summed, their kernels' timings on the fleet's
    inputs)."""
    import gc
    import shutil

    import torch

    from bigsi_tpu_torch import BIGSI
    from bigsi_tpu_torch.synth import bloom_density, synth_index

    t0 = time.perf_counter()
    root = WORK / "distributed"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    usage = shutil.disk_usage(root)
    print("phase %d distributed: %s has %.1f GB free of %.1f GB; writing 2 indexes of %.1f GB"
          % (number, root, usage.free / 1e9, usage.total / 1e9, M * W * 4 / 1e9), flush=True)
    try:
        planted = [random_seq(rng, PLANTED_LEN) for _ in range(PLANTED)]
        seqs = make_queries(rng, planted)
        singles = {}
        with uncounted(fns):
            for name in DIST_INDEXES:
                config = dist_config(name, root)
                synth_index(config, sample_names(), planted,
                            bloom_density(H, KMERS_PER_SAMPLE, M), gen)
                singles[name] = BIGSI(config, device=DEVICE)
        made_s = time.perf_counter() - t0
        launches, shards = service_fleet(number, gpu, singles[HEADLINE], seqs, root, fns, errors)
        for name in DIST_INDEXES:
            serve_fleet(number, gpu, name, singles[name], seqs, root, fns)
        del singles
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("phase %d distributed [%s]: indexes written in %.1f s; the phase took %.1f s"
          % (number, gpu, made_s, time.perf_counter() - t0), flush=True)
    return launches, shards


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 14's service fleet (the script starts them itself)
    ap.add_argument("--dist-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", type=Path, default=None, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    seed = opts.seed
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    if opts.dist_rank is not None:
        dist_rank(opts.dist_rank, opts.dist_port, opts.dist_dir)
        return
    fns = kernel_fns()  # the port, from this checkout

    gpu = phase_device()
    phase_build()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rng = np.random.default_rng(seed)
    errors = Errors()
    phase_kernels(gen, errors)
    seq_checks(gen, rng, errors)
    hits_row = phase_hits(gpu, gen)
    phase_mutation(rng)

    # the main path, one index at a time: only its launches are counted
    runs, launches = {}, dict.fromkeys(fns, 0)
    for number, (name, (_, own)) in enumerate(INDEXES.items(), start=4):
        for fn in fns.values():
            fn.launches = 0
        runs[name] = phase_slice(number, name, gen, rng)
        counted = {k: fn.launches for k, fn in fns.items()}
        check(all(counted[k] > 0 for k in own) and
              not any(n for k, n in counted.items() if k not in own),
              "%s launched its kernels %s and no other: %s" % (name, own, counted))
        for k in own:
            launches[k] += counted[k]

    kernel_ms = phase_times(number + 1, gpu, runs, errors, rng)
    kernel_ms[HITS] = hits_row
    phase_probe_ah(number + 1, gpu, runs, gen, rng)
    probe_ms, counted = phase_probes(number + 2, gpu, runs, gen, errors, fns)
    kernel_ms.update(probe_ms)
    for k in PROBE_KERNELS:
        launches[k] += counted[k]
    build_ms, built = phase_build_ops(number + 3, gpu, runs, gen, rng, errors, fns)
    kernel_ms.update(build_ms)
    for k in BUILD_KERNELS:
        launches[k] += built[k]
    mesh_ms, meshed = phase_mesh(number + 4, gpu, runs, gen, rng, errors, fns)
    # kernel L's row form serves the meshes' (and the fleets') scored
    # presence: its path is phase 13's, counted from 0 there
    launches[PRESENCE] += meshed[PRESENCE]
    runs.clear()  # the card's memory to the ranks of phase 14
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    dist_launched, dist_ms = phase_distributed(number + 5, gpu, gen, rng, errors, fns)
    loaded = sorted(m for m in sys.modules
                    if m in ("bigsi_tpu", "jax") or m.startswith(("bigsi_tpu.", "jax.")))
    check(not loaded, "neither bigsi_tpu nor jax was imported: %s" % loaded)
    print("isolation: no module of bigsi_tpu or jax was loaded", flush=True)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errors.max[name],
         **kernel_ms[name], "bound_by": "bytes"}
        for name, replaces in KERNELS
    ]
    for k in kernels:
        if k["name"] == "tile_counts":
            k["counts_only_launches"] = counted["counts_only"]
        if k["name"] in MESH_KERNELS:
            k["mesh_launches"] = meshed[k["name"]]
            k["mesh_shards"] = mesh_ms.get(k["name"], [])
        k["dist_launches"] = dist_launched.get(k["name"], 0)
        if k["name"] in DIST_KERNELS:
            k["dist_shards"] = [{x: r[x] for x in ("index", "mesh", "shard", "ms", "plain_ms",
                                                   "bound_ms")} for r in dist_ms.get(k["name"], [])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
