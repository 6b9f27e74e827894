"""The lookup microbenchmark on the card: the port of ``scripts/microbench.py``.

Every case of the TPU script (S1 and the rest), on the port's kernels at
the bench shape (m = 2.5e7 rows of W = 32 words, tiles of 32 rows: 4 KB;
B = 256 queries of K = 512 k-mers, h = 3, runs of 6 k-mers on a tile):

  gather-size    random fetches of 32 to 256 rows (4 to 32 KB) at constant
                 bytes: kernel G ``tile_xor`` over the words viewed as
                 fetch units, 16 fetches per query
  gather-sorted  4 KB fetches, random ids against the same ids sorted
  grouped-split  the grouped step split: ``full`` is kernel C, ``gather-only``
                 kernel G over the grouped tiles; ``gather+presence`` and
                 ``csa only`` time the plain PyTorch presence expansion
                 and count (the port has no carry-save count)
  pallas-floor   kernel G over the tiles pre-gathered by kernel F
                 (``gather_rows``), one entry each
  pallas-work    kernel C over those pre-gathered tiles with utile = arange
                 (S1's kernel: the same contract); checked equal to kernel C
                 over the words with the real utile
  fused          kernel B over the per-k-mer streams (P1's kernel)
  fused-v2       kernel C over the grouped streams (P3's kernel)

Each kernel is checked bit for bit against its plain PyTorch version,
then both are timed with CUDA events, a cold L2 before each call, beside
the card's name and power limit.  Tile runs and slot masks come from
numpy's ``default_rng(seed)`` as in the TPU script, grouped by the
port's own ``build_grouped_streams``; the matrix is drawn on the device.
The TPU script's marginal timing inside one scanned program served its
relay and is not ported.  ``--device cpu`` runs the plain versions on the
host clock at a size set by ``--m``.

Usage:
  python -m bigsi_tpu_torch.scripts.microbench fused fused-v2
  python -m bigsi_tpu_torch.scripts.microbench --device cpu --m 65536 --b 4 --k 48 fused
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from bigsi_tpu_torch.index.device_engine import resolve_device
from bigsi_tpu_torch.ops import fused_lookup as fl
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.scripts.timing import device_label, print_time, same, time_ms

M = 25_000_000
W, TR = 32, 32  # words per row of the drawn matrix (1,024 samples), rows per tile
PER_QUERY = 16  # fetches per query of the gather cases: one per warp of kernel G
REPS, PLAIN_REPS = 20, 3


class Ctx:
    """The matrix, the per-k-mer and grouped streams of the chosen shape,
    and where times are taken."""

    def __init__(self, b, k, h, run, device, m=M, seed=0, words=None):
        self.b, self.k, self.h, self.run = b, k, h, run
        self.dev = torch.device(device)
        if words is None:
            gen = torch.Generator(device=self.dev).manual_seed(seed)
            words = torch.randint(-2**31, 2**31, (m // TR * TR, W), generator=gen,
                                  device=self.dev, dtype=torch.int32)
        self.words = words
        self.t, self.w = words.shape[0] // TR, words.shape[1]
        self.label = device_label(self.dev)
        rng = np.random.default_rng(seed)
        nt = (b * k + run - 1) // run
        base = rng.integers(0, self.t, size=nt).astype(np.int32)
        tile_ids = np.repeat(base, run)[: b * k].reshape(b, k)
        slots = rng.integers(0, TR, size=(b, k, h))
        smask = np.bitwise_or.reduce(np.left_shift(np.int64(1), slots), axis=2)
        self.tile = torch.from_numpy(tile_ids).to(self.dev)
        self.smask = torch.from_numpy(smask).to(self.dev)
        t0 = time.perf_counter()
        self.utile, self.gmask = plain.build_grouped_streams(self.tile, self.smask, r=run)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.prep_ms = (time.perf_counter() - t0) * 1e3
        self.u = self.utile.shape[1]
        self.rng = rng
        print("B=%d K=%d h=%d run=%d U=%d fetches=%d grouped-stream prep=%.1fms (%s)"
              % (b, k, h, run, self.u, b * self.u, self.prep_ms, self.dev.type), flush=True)

    def time(self, fn, reps=REPS) -> float:
        return time_ms(fn, reps, self.dev)

    def report(self, name, ms, extra=""):
        rows = self.b * self.k * self.h
        print_time(name, ms, self.label, "%9.1f Mrows/s  %s" % (rows / ms / 1e3, extra))

    def pair(self, name, kernel, reference, fetches=None, fetch_bytes=0) -> tuple:
        """Check ``kernel`` against its plain version bit for bit, time
        both, print; -> (ms, plain ms)."""
        if not same(kernel(), reference()):
            raise RuntimeError("%s differs from its plain version" % name)
        ms, plain_ms = self.time(kernel), self.time(reference, PLAIN_REPS)
        if fetches is None:
            self.report(name, ms, "plain PyTorch %.4f ms" % plain_ms)
        else:
            print_time(name, ms, self.label, "%7.1f Mfetch/s %8.1f GB/s  plain PyTorch %.4f ms"
                       % (fetches / ms / 1e3, fetches * fetch_bytes / ms / 1e6, plain_ms))
        return ms, plain_ms

    def pregathered(self):
        """S1's input: every grouped entry's tile gathered once by kernel F
        -> (words of the B * U gathered tiles, utile = arange(B * U) as
        int32[B, U])."""
        tiles = self.words.view(self.t, TR * self.w)
        g = fl.gather_rows(tiles, self.utile.reshape(-1))
        ar = torch.arange(self.b * self.u, dtype=torch.int32, device=self.dev).view(self.b, self.u)
        return g.view(-1, self.w), ar


def fetch_queries(ids: np.ndarray, device):
    """Fetch ids -> (tile int32[Q, PER_QUERY], valid bool[Q, PER_QUERY]),
    the last query padded with invalid fetches."""
    q = -(-ids.size // PER_QUERY)
    tile = np.zeros(q * PER_QUERY, dtype=np.int32)
    tile[: ids.size] = ids
    valid = np.arange(q * PER_QUERY) < ids.size
    return (torch.from_numpy(tile.reshape(q, PER_QUERY)).to(device),
            torch.from_numpy(valid.reshape(q, PER_QUERY)).to(device))


def xor_pair(ctx, name, words, ids, tile_rows):
    tile, valid = fetch_queries(ids, ctx.dev)
    return ctx.pair(name, lambda: fl.tile_xor(words, tile, valid, tile_rows),
                    lambda: plain.tile_xor(words, tile, valid, tile_rows),
                    ids.size, tile_rows * words.shape[1] * 4)


def case_gather_size(ctx):
    """A fetch unit of rows_per rows is a tile of TR rows of rows_per * W
    / TR words over the same bytes."""
    total_words = ctx.b * ctx.u * TR * ctx.w
    out = {}
    flat = ctx.words.view(-1)
    for rows_per in (32, 64, 128, 256):
        rw = rows_per * ctx.w
        tmax = flat.numel() // rw
        units = flat[: tmax * rw].view(tmax * TR, rw // TR)
        f = total_words // rw
        ids = ctx.rng.integers(0, tmax, size=f).astype(np.int32)
        out["gather %dB" % (rw * 4)] = xor_pair(ctx, "gather %5dB x %d" % (rw * 4, f), units, ids, TR)
    return out


def case_gather_sorted(ctx):
    f = ctx.b * ctx.k
    ridx = ctx.rng.integers(0, ctx.t, size=f).astype(np.int32)
    return {"gather 4KB %s" % name: xor_pair(ctx, "gather 4KB %s x %d" % (name, f), ctx.words, ids, TR)
            for name, ids in (("random", ridx), ("sorted", np.sort(ridx)))}


def case_grouped_split(ctx):
    words, ut, gm = ctx.words, ctx.utile, ctx.gmask
    every = torch.ones(ut.shape, dtype=torch.bool, device=ctx.dev)
    out = {
        "grouped full": ctx.pair("grouped full (kernel C)",
                                 lambda: fl.grouped_tile_counts(words, ut, gm, TR),
                                 lambda: plain.grouped_counts(words, ut, gm, TR)),
        "grouped gather-only": ctx.pair("grouped gather-only (kernel G)",
                                        lambda: fl.tile_xor(words, ut, every, TR),
                                        lambda: plain.tile_xor(words, ut, every, TR)),
    }

    def gather_presence():
        g = words.view(-1, TR, ctx.w)[ut.long()]  # [B, U, TR, W]
        p = plain.select_and(g[:, :, None], gm, TR)  # [B, U, R, W]
        return plain.xor_reduce(p.reshape(-1, ctx.w), 0)

    ms = ctx.time(gather_presence, PLAIN_REPS)
    ctx.report("gather+presence (plain)", ms)
    out["gather+presence (plain)"] = (None, ms)
    gen = torch.Generator(device=ctx.dev).manual_seed(2)
    rows = torch.randint(-2**31, 2**31, (ctx.b, ctx.u * ctx.run, ctx.w), generator=gen,
                         device=ctx.dev, dtype=torch.int32)
    valid = torch.ones(rows.shape[:2], dtype=torch.bool, device=ctx.dev)
    ms = ctx.time(lambda: plain.counts_from_packed(rows, valid), PLAIN_REPS)
    ctx.report("count only (plain)", ms)
    out["csa only (plain)"] = (None, ms)
    return out


def case_pallas_floor(ctx):
    g, ar = ctx.pregathered()
    every = torch.ones(ar.shape, dtype=torch.bool, device=ctx.dev)
    return {"pallas-floor": ctx.pair("pallas-floor (kernel G, pre-gathered)",
                                     lambda: fl.tile_xor(g, ar, every, TR),
                                     lambda: plain.tile_xor(g, ar, every, TR))}


def case_pallas_work(ctx):
    g, ar = ctx.pregathered()
    work = fl.grouped_tile_counts(g, ar, ctx.gmask, TR)
    if not same(work, fl.grouped_tile_counts(ctx.words, ctx.utile, ctx.gmask, TR)):
        raise RuntimeError("kernel C over the pre-gathered tiles differs from kernel C "
                           "over the words")
    return {"pallas-work": ctx.pair("pallas-work (kernel C, pre-gathered)",
                                    lambda: fl.grouped_tile_counts(g, ar, ctx.gmask, TR),
                                    lambda: plain.grouped_counts(g, ar, ctx.gmask, TR))}


def case_fused(ctx):
    return {"fused": ctx.pair("fused (kernel B)",
                              lambda: fl.tile_counts(ctx.words, ctx.tile, ctx.smask, TR),
                              lambda: plain.blocked_counts(ctx.words, ctx.tile, ctx.smask, TR))}


def case_fused_v2(ctx):
    return {"fused-v2": ctx.pair("fused-v2 (kernel C)",
                                 lambda: fl.grouped_tile_counts(ctx.words, ctx.utile, ctx.gmask, TR),
                                 lambda: plain.grouped_counts(ctx.words, ctx.utile, ctx.gmask, TR))}


CASES = {
    "gather-size": case_gather_size,
    "gather-sorted": case_gather_sorted,
    "grouped-split": case_grouped_split,
    "pallas-floor": case_pallas_floor,
    "pallas-work": case_pallas_work,
    "fused": case_fused,
    "fused-v2": case_fused_v2,
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="+", choices=sorted(CASES))
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--h", type=int, default=3)
    ap.add_argument("--run", type=int, default=6)
    ap.add_argument("--m", type=int, default=M, help="rows of the matrix")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    ctx = Ctx(args.b, args.k, args.h, args.run, resolve_device(args.device), args.m, args.seed)
    out = {}
    for case in args.cases:
        out.update(CASES[case](ctx))
    return out


if __name__ == "__main__":
    main()
