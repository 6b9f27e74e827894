"""Kernels I (``kmer_rows``) and J (``bloom_scatter``) on the card, at the
shapes of the port's hashing and device build.

* Kernel I, canonical classic rows (h = 3, m = 2.5e7), as the full query
  step (``ops/lookup.py:make_full_query_step``) calls it: on the classic
  batch's shape (131,072 31-mers, B = 256 queries of 512 k-mers) and on
  one sample's 4,000,000 31-mers.  On the sample it does J's work but the
  atomics, so J - I splits J's time into hashing and atomics.
* Kernel J, one sample's bloom of the same 4,000,000 31-mers at m =
  2.5e7: classic (h = 3) and blocked/32 (seed 0 the tile, 3 slots), and
  classic over the view ``sample[1:]``, whose bytes start 15 bytes past
  a 16-byte boundary.

The k-mers are uniform random ACGT drawn on the device from ``--seed``
(4^31 of them: distinct with near certainty).  Each case is checked bit
for bit against its plain version (``ops/hash.py:kmer_rows_plain``,
``ops/build.py:bloom_plain``) and timed beside it, with its bound: the
bytes it must move (k-mers and seeds in, rows or bloom out) at 3.35 TB/s.

Only the wrappers' public functions are used, so the script also times
another checkout's kernels: ``cd <checkout> && PYTHONPATH=. python -m
bigsi_tpu_torch.scripts.probe_ij`` imports that checkout's package.
Device times are CUDA events with a cold L2 (``scripts/timing.py:cuda_ms``),
each line beside the card's name and power limit; ``--device cpu`` runs
the plain versions on the host clock at the sizes set by ``--batch`` and
``--kmers``.

Usage:
  python -m bigsi_tpu_torch.scripts.probe_ij [--seed N] [--json PATH]
  python -m bigsi_tpu_torch.scripts.probe_ij --device cpu --batch 2000 --kmers 5000 --reps 1
"""

from __future__ import annotations

import argparse
import json

import torch

from bigsi_tpu_torch.index.device_engine import resolve_device
from bigsi_tpu_torch.ops import build
from bigsi_tpu_torch.ops import fused_lookup as fl
from bigsi_tpu_torch.ops import hash as kmer_hash
from bigsi_tpu_torch.scripts.timing import device_label, print_time, same, time_ms

M, H, K_LEN = 25_000_000, 3, 31
BATCH, KMERS = 256 * 512, 4_000_000
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA's data sheet)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + what)


def random_kmers(n: int, gen, dev) -> torch.Tensor:
    """n uniform random ACGT k-mers of K_LEN bytes: uint8[n, K_LEN]."""
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    return acgt[torch.randint(0, 4, (n, K_LEN), generator=gen, device=dev)]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_case(what: str, kernel, plain, label: str, reps: int, dev, *inputs) -> dict:
    """Check ``kernel()`` against ``plain()`` bit for bit, time both and
    print the kernel's time beside its bound; -> the case's row."""
    got = kernel()
    check(same(got, plain()), "%s equals its plain version" % what)
    moved = nbytes(*inputs, got)
    ms = time_ms(kernel, reps, dev)
    plain_ms = time_ms(plain, max(1, reps // 10), dev)
    row = {"ms": ms, "plain_ms": plain_ms, "bytes": moved}
    extra = "plain %.4f ms; %.2f MB moved" % (plain_ms, moved / 1e6)
    if dev.type == "cuda":  # a bound is the card's: no share of it for a host-clock time
        row["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
        row["share"] = row["bound_ms"] / ms
        extra += ", bound %.4f ms, %.3f of bound" % (row["bound_ms"], row["share"])
    print_time(what, ms, label, extra)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter,
                                 epilog="\n".join(__doc__.splitlines()[1:]))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=BATCH, help="k-mers of the classic batch")
    ap.add_argument("--kmers", type=int, default=KMERS, help="k-mers of the sample")
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = device_label(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    batch = random_kmers(args.batch, gen, dev)
    sample = random_kmers(args.kmers, gen, dev)
    seeds = torch.arange(H, dtype=torch.int32, device=dev)
    blocked_seeds = torch.arange(H + 1, dtype=torch.int32, device=dev)
    m, reps = args.m, args.reps
    out = {"label": label}

    def rows_case(name, km):
        out[name] = time_case(
            name, lambda: fl.kmer_rows(km, seeds, "classic", canonical=True, m=m),
            lambda: kmer_hash.kmer_rows_plain(km, seeds, "classic", True, m), label, reps, dev,
            km, seeds)

    def bloom_case(name, km, layout, s, tile_rows):
        out[name] = time_case(
            name, lambda: fl.bloom_scatter(km, s, layout, m, tile_rows),
            lambda: build.bloom_plain(km, s, layout, m, tile_rows), label, reps, dev, km, s)

    rows_case("I batch", batch)
    rows_case("I sample", sample)
    bloom_case("J classic", sample, "classic", seeds, 1)
    bloom_case("J blocked/32", sample, "blocked", blocked_seeds, 32)
    bloom_case("J classic sample[1:]", sample[1:], "classic", seeds, 1)
    atomics = out["J classic"]["ms"] - out["I sample"]["ms"]
    print("J classic %.4f ms = hashing (I on the sample) %.4f ms + atomics %.4f ms; "
          "J blocked/32 %.4f ms  [%s]" % (out["J classic"]["ms"], out["I sample"]["ms"], atomics,
                                          out["J blocked/32"]["ms"], label), flush=True)
    out["J classic - I sample"] = atomics
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
