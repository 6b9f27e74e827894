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
   with half- and all-padding queries and K = 0; and a mutation check:
   small blocked/32 and
   minimizer/64 indexes on the card, merged and then overwritten in one
   colour, give the host engine's results on a rebuilt engine;
4.-8. five indexes, each an in-memory index of random rows at the bit
   density of scripts/synth_index.py, drawn on the card, with 4 planted
   samples: classic (kernel A), blocked at tile_rows 32 (kernel B),
   minimizer at tile_rows 16 with w = 19, slot scheme 3, r = 20 (the
   JAX package's headline serving config), minimizer at the default
   tile_rows 32, window and slot scheme (w = 11, scheme 3, r = 6) --
   both cols indexes run kernel D at engine load, once per chunk of
   about 2^20 rows as the engine streams the matrix in, and the seq arm
   (counts_batch_seqs: kernels H and E) serves their all-ACGT batches
   -- and minimizer at tile_rows 64 (kernel C through counts_batch).
   Each runs a single search, a bulk_search of a 256-record FASTA
   through the port's CLI at thresholds 1.0 and 0.7, and 3 GET, 1 POST
   and a burst of 8 concurrent GETs (coalesced by the server's batcher)
   against the port's HTTP server.  The cols indexes also search a batch
   with one N base (the k-mer path), 8 queries of 4,000 bp (the seq arm)
   and 248 queries of 542 bp with 8 of 20 kb (split by the facade; the
   guard refuses the 20 kb half).  Each counts_batch_seqs call is
   counted as served, overflowed or refused; minimizer/16 must serve
   every batch the guard admits, and each fall-back goes to
   counts_batch_kmers.  Every result dict must equal what the facade
   returns on the numpy host engine (``engine: numpy``) on the same
   index.  Each index's load, ``BIGSI(config, device)``, prints its wall
   time and its peak on the device (peak allocation less what was held
   before); a cols index's peak must stay under its row-major words plus
   its cols.  The launch counts are set to 0 before each index and read
   after it: its kernels must have run, and no other;
9. times, each beside the GPU's name and power limit: search_batch
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
   and B = 8, L = 4,096: wrapper, kernel alone and each pass;
10. probes: the three probe entry points of bigsi_tpu_torch.scripts
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
   index_select of S2's rows is timed as kernel F's yardstick.

Then a check that no module of bigsi_tpu or jax was loaded, one JSON
line of the kernels (each with its time, its plain version's, the
least time its bytes allow on an H100 (3.35 TB/s) for this run's
inputs, and the one-call PyTorch yardstick where there is one), and
last the JSON line {"ok": true, "device": {...}}.  Any failure exits
non-zero; with no CUDA device it exits 1 before printing any result.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
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
# the eight kernels: (name, TPU kernels or XLA program it replaces)
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
)
COLS_KERNELS = ("pack_tile_cols", "cols_counts", "seq_streams")
# the indexes of phases 4-8: name -> (config entries, kernels of its path)
INDEXES = {
    "classic": ({"layout": "classic"}, ("classic_counts",)),
    "blocked/32": ({"layout": "blocked", "tile-rows": 32}, ("tile_counts",)),
    "minimizer/16": ({"layout": "minimizer", "tile-rows": 16, "minimizer-window": 19},
                     COLS_KERNELS),
    "minimizer/32": ({"layout": "minimizer", "tile-rows": 32}, COLS_KERNELS),
    "minimizer/64": ({"layout": "minimizer", "tile-rows": 64}, ("grouped_tile_counts",)),
}
HEADLINE = "minimizer/16"
# the engine's spans inside counts_batch_kmers and counts_batch_seqs
SPANS = ("engine.kmer_prep", "engine.kmer_counts", "engine.seq_in", "engine.seq_kernels",
         "engine.seq_out")
PROBE_INDEX = "blocked/32"  # whose resident words the probes of phase 10 read
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
    raise ValueError(name)


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
    torch.cuda.synchronize()
    print("phase 3 kernels: all five kernels bit-exact with their plain versions in %d "
          "cases (slice shapes W=%d m=%d B=%d K=512 h=%d; A at B 1 and 2, K 512 and 20,000 "
          "split over blocks, at all-ones B=1 K=70,000 (counts past 2^16), h 1/3/5/8, "
          "half- and all-padding, K=0; grouped streams of runs of ~%d "
          "k-mers at R=%d and ~%d at R=%d, D and E at tile_rows 16 and 32; all-ones words "
          "at W 33/64 with B's counts of 4,096 (both builds) and C's of 80,000 (U=4,000 "
          "R=20), masks of rows 32-63 only; ragged W 1/33/64, tile_rows 8/16/32/64 (E on "
          "uint8, int16 and int32 cols), R 1/6/20, U 7/13/21/37 and 4,000 at R=20 (80,000 "
          "live slots), all-padding queries, B or K of 0; D at tile_rows 1/5/8/12/16/31/32, "
          "W 1/33/64, T 1, 3,001 and 100,003, misaligned words and cols, and packed in odd "
          "chunks into slices of one cols)"
          % (cases, W, M, B, H, HEADLINE_RUN, HEADLINE_R, DEFAULT_RUN, DEFAULT_R), flush=True)


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
        own = INDEXES[name][1]
        check(all(counted[k] > 0 for k in own) and
              not any(n for k, n in counted.items() if k not in own),
              "%s mutation launched its kernels %s and no other: %s" % (name, own, counted))
        del port, other, before
        for config in configs:
            get_storage(config).delete_all()
    print("phase 3 mutation: merge and interior insert on %s at m=%d rebuilt the engine; %d "
          "result lists equal the host engine's" % (", ".join(MUTATION_INDEXES), MUTATION_M,
                                                    compared), flush=True)


# -- phases 4-8 ---------------------------------------------------------


def random_seq(rng, n: int) -> str:
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def mutate(rng, seq: str, snps: int) -> str:
    out = list(seq)
    for pos in rng.choice(len(seq), size=snps, replace=False):
        out[pos] = "ACGT"[("ACGT".index(out[pos]) + 1 + rng.integers(0, 3)) % 4]
    return "".join(out)


def make_index(name: str, gen, rng) -> tuple[dict, list[str]]:
    """An in-memory index of N samples: random rows drawn on the card at
    the density of a bloom of KMERS_PER_SAMPLE k-mers, with the planted
    samples' blooms in columns 0..PLANTED-1.  Returns its config and the
    planted sequences."""
    from bigsi_tpu_torch.synth import bloom_density, synth_index

    config = {
        "storage-engine": "memory",
        "storage-config": {"filename": "chip-smoke-" + name.replace("/", "-")},
        "k": K_LEN, "m": M, "h": H, **INDEXES[name][0],
    }
    planted = [random_seq(rng, PLANTED_LEN) for _ in range(PLANTED)]
    names = ["planted%d" % i for i in range(PLANTED)]
    names += ["synth%d" % i for i in range(PLANTED, N)]
    synth_index(config, names, planted, bloom_density(H, KMERS_PER_SAMPLE, M), gen)
    return config, planted


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


def timed_load(config):
    """Opens the index on the port's CUDA engine: -> (the facade, {"s":
    wall time of ``BIGSI(config, device)``, "peak": the most it held on
    the device at once (peak allocation less what was allocated
    before), "words" and "cols": the bytes of the tile-padded row-major
    matrix and of its cols layout})."""
    import torch

    from bigsi_tpu_torch import BIGSI

    torch.cuda.synchronize()
    PEAK["bytes"] = max(PEAK["bytes"], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    port = BIGSI(config, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    engine = port.engine
    tile_rows = engine.tile_rows if engine.tiled else 1
    words = -(-engine.matrix.num_rows // tile_rows) * tile_rows * engine.matrix.num_words * 4
    cols = 0 if engine.cols is None else engine.cols.numel() * engine.cols.element_size()
    return port, {"s": seconds, "peak": peak, "words": words, "cols": cols}


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
    port, load = timed_load(config)
    check(type(port.engine).__name__ == "DeviceEngine", "the port runs its CUDA engine")
    cols = name in COLS_INDEXES
    engine = port.engine
    if cols:  # never the row-major words and the cols at once
        check(load["peak"] < load["words"] + load["cols"],
              "%s: the load's peak %d B is under words + cols %d B"
              % (name, load["peak"], load["words"] + load["cols"]))
    if cols:
        check(engine.run_len == COLS_INDEXES[name] and engine.slot_scheme == 3
              and engine.cols is not None and engine.words is None,
              "%s: cols engine with slot scheme 3 and r = %d" % (name, COLS_INDEXES[name]))
        check(engine.supports_seq_batch() and engine.supports_kmer_batch(),
              "%s: counts_batch_seqs and counts_batch_kmers serve" % name)
    else:
        check(not engine.supports_seq_batch(), "%s: the seq arm is off" % name)
    compared = 0

    # single search of a planted query
    q = planted[0][:QUERY_LEN]
    for t in (1.0, 0.7):
        got = port.search(q, t)
        check(got == host.search(q, t), "%s search at %.1f equals the host's" % (name, t))
        compared += 1
    check(any(r["sample_name"] == "planted0" and r["percent_kmers_found"] == 100.0
              for r in port.search(q, 1.0)), "the planted sample is found")

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
            want = [result_dict(s, t, r) for s, r in zip(seqs, host.search_batch(seqs, t))]
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
                check(get(s, t) == result_dict(s, t, host.search(s, t)),
                      "%s GET /search equals the host's" % name)
            got = http_json(base, {"seq": seqs[5], "threshold": 0.7})
            check(got == result_dict(seqs[5], 0.7, host.search(seqs[5], 0.7)),
                  "%s POST /search equals the host's" % name)
            burst = seqs[8:16]
            before = {method: len(c) for method, c in calls.items()}
            with ThreadPoolExecutor(max_workers=len(burst)) as pool:
                outs = list(pool.map(lambda s: get(s, 0.7), burst))
            for s, got in zip(burst, outs):
                check(got == result_dict(s, 0.7, host.search(s, 0.7)),
                      "%s coalesced GET /search equals the host's" % name)
            compared += 4 + len(burst)
        finally:
            server.shutdown()
            server.invalidate()
            server.server_close()
            thread.join(timeout=60)
        check(not thread.is_alive(), "the HTTP server stopped")
        # queries of the burst that reached the engine in a search_batch
        coalesced = sum(len(args[0]) for method in ("counts_batch", "counts_batch_seqs")
                        for args, _ in calls[method][before[method]:])
        extra = []
        if cols:  # a non-ACGT batch, long queries and a mixed-length batch
            for what, batch in seq_traffic(rng, planted, seqs):
                before = {method: len(c) for method, c in calls.items()}
                got = port.search_batch(batch, 0.7)
                check(got == host.search_batch(batch, 0.7),
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
    else:
        check(n["counts_batch"] > 0 and n["counts_batch_kmers"] == n["counts_batch_seqs"] == 0,
              "%s: counts_batch served every batch: %s" % (name, n))
        route = "counts_batch"
    print("phase %d load %s: BIGSI(config, device) %.3f s, load peak %.4f GB on the device "
          "(row-major words %.4f GB, cols %.4f GB)"
          % (number, name, load["s"], load["peak"] / 1e9, load["words"] / 1e9,
             load["cols"] / 1e9), flush=True)
    print("phase %d %s: index of %d samples, m=%d, made in %.1f s; %d result "
          "lists equal the host engine's (search, bulk_search at 1.0 and 0.7 with "
          "%d and %d hits, HTTP 3 GET + 1 POST + 8 concurrent GETs (%d coalesced)%s) "
          "through %s; engine calls %s"
          % (number, name, N, M, t_index, compared, n_hits[1.0], n_hits[0.7], coalesced,
             "".join(", search_batch of " + e for e in extra), route, json.dumps(n)),
          flush=True)
    return port, seqs


# -- phase 9 ------------------------------------------------------------


def search_batch_layers(port, seqs, reps: int) -> list[dict]:
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
    ("engine.seq_kernels") and the counts back ("engine.seq_out").  All
    in ms."""
    from bigsi_tpu_torch import metrics

    port.search_batch(seqs, 1.0)
    calls = []
    for _ in range(reps):
        metrics.reset()
        t0 = time.perf_counter()
        port.search_batch(seqs, 1.0)
        total = (time.perf_counter() - t0) * 1e3
        timers = metrics.snapshot()["timers"]
        counts = timers["search.batch_counts"]["total_s"] * 1e3
        results = timers["search.batch_results"]["total_s"] * 1e3
        call = {"search_batch": total, "prep": total - counts - results,
                "counts": counts, "results": results}
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


def phase_times(number: int, gpu: str, runs, errors: Errors) -> dict:
    """-> {kernel: {ms, plain_ms, bound_ms, library_ms}}, each kernel on
    the first index of its path (kernels H and E on minimizer/16's seq
    path)."""
    import torch

    kernel_ms = {}
    for name, (port, seqs) in runs.items():
        if name in COLS_INDEXES:
            phase_cols_times(number, gpu, name, port, seqs, errors, kernel_ms)
            continue
        calls = search_batch_layers(port, seqs, 5)
        mid = median_call(calls)
        kname, kernel, reference, args, shape = host_kernel_inputs(port, seqs)
        k_ms, p_ms = timed_kernel(kname, kernel, reference, args, errors, "%s batch" % name)
        moved = bound_bytes(kname, *args)
        record(kernel_ms, kname, k_ms, p_ms, moved)
        print("phase %d times %s [%s]: search_batch of %d queries, median of %d calls "
              "%.3f ms (%.1f queries/s); inside that call: k-mer extraction and padding "
              "on the host %.3f ms, engine counts_batch %.3f ms, result building %.3f ms; %s "
              "kernel %.4f ms vs plain PyTorch %.4f ms (%s, cold L2); kernel share of "
              "search_batch %.4f; bound %.4f ms by bytes (%.1f MB), %.3f of bound"
              % (number, name, gpu, B, len(calls), mid["search_batch"],
                 B / mid["search_batch"] * 1e3, mid["prep"], mid["counts"], mid["results"],
                 kname, k_ms, p_ms, shape, k_ms / mid["search_batch"], bound_ms(moved),
                 moved / 1e6, bound_ms(moved) / k_ms),
              flush=True)
        print("phase %d calls %s [%s]: %s" % (number, name, gpu, json.dumps(calls)), flush=True)
    print("phase %d memory [%s]: peak %.2f GB allocated on the device"
          % (number, gpu, max(PEAK["bytes"], torch.cuda.max_memory_allocated()) / 1e9),
          flush=True)
    return kernel_ms


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


# -- phase 10 -----------------------------------------------------------


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    fns = kernel_fns()  # the port, from this checkout

    gpu = phase_device()
    phase_build()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rng = np.random.default_rng(seed)
    errors = Errors()
    phase_kernels(gen, errors)
    seq_checks(gen, rng, errors)
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

    kernel_ms = phase_times(number + 1, gpu, runs, errors)
    phase_probe_ah(number + 1, gpu, runs, gen, rng)
    probe_ms, counted = phase_probes(number + 2, gpu, runs, gen, errors, fns)
    kernel_ms.update(probe_ms)
    for k in PROBE_KERNELS:
        launches[k] += counted[k]
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
