"""Kernel D (``pack_tile_cols``) and the cols engine's load on the card.

* Kernel D on a full-size matrix drawn on the device (m = 2.5e7 rows of
  W = 32 words: 1,024 samples, 3.2 GB) at tile_rows 8, 16 and 32, each
  checked bit for bit against its plain version on the first 2^20 rows
  and timed on the whole, beside its bound (the matrix read once and
  the cols written once, at 3.35 TB/s) and beside a torch
  device-to-device ``copy_`` of the same bytes (the copy floor).
* The load of a minimizer index over the same matrix in host RAM, at
  tile_rows 16 and 32: the wall time of ``DeviceEngine(...)`` (host
  clock, ended by a synchronise) and the load's peak on the device (the
  peak allocation less what was allocated before), beside the bytes of
  the tile-padded row-major words and of the cols.

Only ``pack_tile_cols(words, tile_rows)`` and the engine's constructor
are used, so the script also measures another checkout's kernel and
load: ``cd <checkout> && PYTHONPATH=. python <this file>`` imports that
checkout's package.  Device times are CUDA events with a cold L2, each
line beside the card's name and power limit; ``--device cpu`` runs the
plain versions on the host clock at a size set by ``--m``, and the
device peak is then not measured.

Usage:
  python -m bigsi_tpu_torch.scripts.probe_pack [--seed N] [--json PATH]
  python -m bigsi_tpu_torch.scripts.probe_pack --device cpu --m 20000 --reps 1
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from bigsi_tpu_torch.index.device_engine import DeviceEngine, resolve_device
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.ops import fused_lookup as fl
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.scripts.timing import device_label, print_time, same, time_ms

M, SAMPLES = 25_000_000, 1024
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA's data sheet)
PACK_TILE_ROWS = (8, 16, 32)
LOAD_TILE_ROWS = (16, 32)
CHECK_ROWS = 1 << 20


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + what)


def pack_times(words, label: str, reps: int) -> dict:
    """Kernel D at each of PACK_TILE_ROWS over ``words`` int32[m, W] (m a
    multiple of 32), and the copy floor; -> {case: row}."""
    dev = words.device
    moved = 2 * words.numel() * 4  # cols hold as many bytes as the words
    bound = moved / HBM_BYTES_PER_S * 1e3
    dst = torch.empty_like(words)
    floor = time_ms(lambda: dst.copy_(words), reps, dev)
    del dst
    print_time("copy_ of the matrix", floor, label, "%.1f GB/s read + write" % (moved / floor / 1e6))
    out = {"copy_floor": {"ms": floor, "bytes": moved}}
    head = words[: min(CHECK_ROWS, words.shape[0])]
    for tile_rows in PACK_TILE_ROWS:
        check(same(fl.pack_tile_cols(head, tile_rows), plain.pack_tile_cols(head, tile_rows)),
              "kernel D equals its plain version at tile_rows %d" % tile_rows)
        ms = time_ms(lambda: fl.pack_tile_cols(words, tile_rows), reps, dev)
        print_time("pack_tile_cols tile_rows=%d" % tile_rows, ms, label,
                   "bound %.4f ms, %.3f of bound, D / copy %.3f" % (bound, bound / ms, ms / floor))
        out["tile_rows=%d" % tile_rows] = {"ms": ms, "bound_ms": bound, "share": bound / ms,
                                           "per_copy": ms / floor}
    return out


def load_times(host_words: np.ndarray, samples: int, dev, label: str) -> dict:
    """A minimizer DeviceEngine over ``host_words`` at each of
    LOAD_TILE_ROWS: wall seconds and the device peak; -> {case: row}."""
    out = {}
    cuda = dev.type == "cuda"
    m, w = host_words.shape
    for tile_rows in LOAD_TILE_ROWS:
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        engine = DeviceEngine(BitSliceMatrix(host_words, samples), device=dev,
                              layout="minimizer", tile_rows=tile_rows)
        if cuda:
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - before if cuda else None
        words_b = -(-m // tile_rows) * tile_rows * w * 4
        cols_b = engine.cols.numel() * engine.cols.element_size()
        check(engine.words is None and engine.cols is not None, "a cols engine")
        del engine
        print("load minimizer/%d: %.3f s (host clock), device peak %s (words %.4f GB, cols "
              "%.4f GB)  [%s]" % (tile_rows, seconds,
                                  "not measured" if peak is None else "%.4f GB" % (peak / 1e9),
                                  words_b / 1e9, cols_b / 1e9, label), flush=True)
        out["minimizer/%d" % tile_rows] = {"s": seconds, "peak": peak, "words": words_b,
                                           "cols": cols_b}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter,
                                 epilog="\n".join(__doc__.splitlines()[1:]))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m", type=int, default=M, help="rows of the matrix (a multiple of 32)")
    ap.add_argument("--samples", type=int, default=SAMPLES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args(argv)
    if args.m % 32:
        ap.error("--m must be a multiple of 32")
    dev = resolve_device(args.device)
    label = device_label(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    words = torch.randint(-2**31, 2**31, (args.m, -(-args.samples // 32)), generator=gen,
                          device=dev, dtype=torch.int32)
    out = {"label": label, "pack_tile_cols": pack_times(words, label, args.reps)}
    host_words = words.cpu().numpy().view(np.uint32)
    del words
    out["load"] = load_times(host_words, args.samples, dev, label)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
