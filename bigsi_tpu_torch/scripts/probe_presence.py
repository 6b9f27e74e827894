"""Kernel L (``presence_rows``) on the card, at the shapes of scoring's
presence rows.

A scored search asks for one presence row per distinct k-mer of the
query: K = 512 for the bench's 542 bp queries, K = 20,000 for a 20 kb
one.  The matrix is the bench's: m = 2.5e7 rows of 1,024 samples (W =
32), uniform random words drawn on the device from ``--seed``.  Cases,
each at both K:

* classic: row ids int32[K, 3] in [0, m);
* slot at tile_rows 32 and 64 (blocked/32, minimizer/64): a random tile
  and 3 random slots a k-mer, and at tile_rows 64 a row slab (the upper
  half of the tiles, with its tile window);
* cols at tile_rows 8, 16 and 32 (uint8, int16 and int32 cols packed by
  kernel D from the same words, one at a time).

Each case is checked bit for bit against its plain version
(``ops/lookup.py:presence_rows``) and timed beside it, with its bound:
the bytes it must move at 3.35 TB/s (:func:`presence_bytes`: each
distinct selected row read once).  Device
times are CUDA events with a cold L2 (``scripts/timing.py:cuda_ms``),
each line beside the card's name and power limit; ``--device cpu`` runs
the plain versions on the host clock at the size set by ``--m``.

Usage:
  python -m bigsi_tpu_torch.scripts.probe_presence [--seed N] [--json PATH]
  python -m bigsi_tpu_torch.scripts.probe_presence --device cpu --m 100000 --reps 1
"""

from __future__ import annotations

import argparse
import json

import torch

from bigsi_tpu_torch.index.device_engine import resolve_device
from bigsi_tpu_torch.ops import fused_lookup as fl
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.scripts.timing import device_label, print_time, same, time_ms

M, N, H = 25_000_000, 1024, 3
KS = (512, 20_000)
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA's data sheet)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + what)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def presence_bytes(matrix, source, idx, smask=None, tile_rows=1, window=None) -> int:
    """The bytes kernel L must move for these inputs: each distinct row
    (or cols row) its k-mers select read once, its inputs, and its output
    int32[K, W].  A slot selects the rows its mask sets; a k-mer outside
    the tile window, or a cols k-mer of mask 0, selects none.  Distinct,
    because a minimizer query's consecutive k-mers share tiles."""
    k = idx.shape[0]
    w = matrix.shape[1] // 32 if source == "cols" else matrix.shape[1]
    fixed = nbytes(idx, smask) + k * w * 4
    if source == "classic":
        return int(torch.unique(idx).numel()) * w * 4 + fixed
    t0, t1 = window or (0, matrix.shape[0] // (1 if source == "cols" else tile_rows))
    here = (idx >= t0) & (idx < t1)
    if source == "cols":
        bits = matrix.element_size() * 8
        live = here & ((smask & ((1 << bits) - 1)) != 0)
        tiles = int(torch.unique(idx[live]).numel())
        return tiles * matrix.shape[1] * matrix.element_size() + fixed
    slots = torch.arange(tile_rows, device=idx.device)
    on = ((smask[here, None] >> slots) & 1).bool()  # [K in the window, tile_rows]
    rows = (idx[here].long()[:, None] * tile_rows + slots)[on]
    return int(torch.unique(rows).numel()) * w * 4 + fixed


def slot_inputs(k: int, num_tiles: int, tile_rows: int, gen, dev):
    """K random k-mers of a tiled layout: a random tile and 3 random
    slots each -> (tile int32[K], smask int64[K])."""
    tile = torch.randint(0, num_tiles, (k,), generator=gen, device=dev, dtype=torch.int32)
    slots = torch.randint(0, tile_rows, (k, H), generator=gen, device=dev, dtype=torch.int64)
    smask = torch.ones_like(slots) << slots
    return tile, smask[:, 0] | smask[:, 1] | smask[:, 2]


def time_case(what: str, label: str, reps: int, dev, matrix, source, idx, smask=None,
              tile_rows=1, window=None) -> dict:
    """Check kernel L on these inputs against its plain version bit for
    bit, time both and print the kernel's time beside its bound; -> the
    case's row."""
    def kernel():
        return fl.presence_rows(matrix, source, idx, smask, tile_rows, window)

    def reference():
        return plain.presence_rows(matrix, source, idx, smask, tile_rows, window)

    got = kernel()
    check(same(got, reference()), "%s equals its plain version" % what)
    moved = presence_bytes(matrix, source, idx, smask, tile_rows, window)
    ms = time_ms(kernel, reps, dev)
    plain_ms = time_ms(reference, max(1, reps // 10), dev)
    row = {"ms": ms, "plain_ms": plain_ms, "bytes": moved, "k": idx.shape[0]}
    extra = "plain %.4f ms; %.3f MB moved" % (plain_ms, moved / 1e6)
    if dev.type == "cuda":  # a bound is the card's: no share of it for a host-clock time
        row["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
        row["share"] = row["bound_ms"] / ms
        extra += ", bound %.5f ms, %.4f of bound" % (row["bound_ms"], row["share"])
    print_time(what, ms, label, extra)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter,
                                 epilog="\n".join(__doc__.splitlines()[1:]))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = device_label(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    m = args.m - args.m % 64  # whole tiles at every tile_rows
    words = torch.randint(-2**31, 2**31, (m, N // 32), generator=gen, device=dev,
                          dtype=torch.int32)
    out = {"label": label, "m": m, "n": N}
    for k in KS:
        rows = torch.randint(0, m, (k, H), generator=gen, device=dev, dtype=torch.int32)
        out["classic K=%d" % k] = time_case("L classic K=%d" % k, label, args.reps, dev,
                                            words, "classic", rows)
        for tr in (32, 64):
            tile, smask = slot_inputs(k, m // tr, tr, gen, dev)
            out["slot/%d K=%d" % (tr, k)] = time_case(
                "L slot/%d K=%d" % (tr, k), label, args.reps, dev, words, "slot", tile, smask, tr)
        half = m // 64 // 2
        tile, smask = slot_inputs(k, m // 64, 64, gen, dev)
        out["slot/64 slab K=%d" % k] = time_case(
            "L slot/64 slab K=%d" % k, label, args.reps, dev, words[half * 64:], "slot", tile,
            smask, 64, (half, m // 64))
    for tr in (8, 16, 32):
        cols = fl.pack_tile_cols(words, tr)
        for k in KS:
            tile, smask = slot_inputs(k, m // tr, tr, gen, dev)
            out["cols/%d K=%d" % (tr, k)] = time_case(
                "L cols/%d K=%d" % (tr, k), label, args.reps, dev, cols, "cols", tile, smask)
        del cols
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
