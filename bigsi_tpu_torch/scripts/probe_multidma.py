"""Random-row gather probe: kernel F (``gather_rows``) on the card.

The port of ``scripts/probe_multidma.py`` (S2), which asked whether a
Pallas kernel with many row copies in flight beats XLA's gather.  Here
the question is the H100's rate for random row reads: n rows of
``--row-words`` words drawn uniformly from an m-row matrix, each a
separate fetch.  ``--chunk`` is the rows a group of lanes keeps in
flight (at rows of 128 words and more, the rows a warp keeps in flight,
as the TPU kernel's chunk of copies).  The output is checked bit for bit
against the plain version (``mat[idx]``), then timed with CUDA events, a
cold L2 before each call (the default 32 MB output would fit the 50 MB
L2), and printed with M fetches/s and GB/s beside the card's name and
power limit.  The matrix and ids are drawn on the device from an
explicit ``torch.Generator``.

The TPU script's interpret mode, wedge rules and XOR-to-one-scalar sync
served its relay and are not ported; ``--device cpu`` runs the plain
version at a small size instead.

Usage:
  python -m bigsi_tpu_torch.scripts.probe_multidma [--chunk 16] [--rows 65536]
      [--row-words 128] [--m 6250000] [--plain-baseline]
  python -m bigsi_tpu_torch.scripts.probe_multidma --device cpu --m 1000 --rows 256
"""

from __future__ import annotations

import argparse

import torch

from bigsi_tpu_torch.index.device_engine import resolve_device
from bigsi_tpu_torch.ops import fused_lookup as fl
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.scripts.timing import device_label, print_time, time_ms


def probe(mat, idx, chunk: int, label: str, reps: int = 20, plain_baseline: bool = True) -> dict:
    """Gather ``idx``'s rows of ``mat`` with kernel F, hold the result to
    the plain version, time it (and with ``plain_baseline`` the plain
    version); -> {"ms": ..., "plain_ms": ... or None}."""
    got = fl.gather_rows(mat, idx, chunk)
    if not torch.equal(got, plain.gather_rows(mat, idx)):
        raise RuntimeError("gather_rows differs from its plain version")
    del got
    n, wr = idx.shape[0], mat.shape[1]

    def rates(ms):
        return "%9.1f M fetches/s %8.1f GB/s" % (n / ms / 1e3, n * wr * 4 / ms / 1e6)

    ms = time_ms(lambda: fl.gather_rows(mat, idx, chunk), reps, mat.device)
    print_time("gather_rows %d x %d B chunk=%d" % (n, wr * 4, chunk), ms, label, rates(ms))
    plain_ms = None
    if plain_baseline:
        plain_ms = time_ms(lambda: plain.gather_rows(mat, idx), reps, mat.device)
        print_time("plain PyTorch mat[idx]", plain_ms, label, rates(plain_ms))
    return {"ms": ms, "plain_ms": plain_ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=16, choices=fl.ROWS_IN_FLIGHT,
                    help="rows a lane group keeps in flight")
    ap.add_argument("--rows", type=int, default=65536, help="rows gathered (n)")
    ap.add_argument("--row-words", type=int, default=128, help="words per row (128: 512 B)")
    ap.add_argument("--m", type=int, default=6_250_000, help="rows of the matrix")
    ap.add_argument("--plain-baseline", action="store_true",
                    help="also time the plain PyTorch gather")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mat = torch.randint(-2**31, 2**31, (args.m, args.row_words), generator=gen, device=dev,
                        dtype=torch.int32)
    idx = torch.randint(0, args.m, (args.rows,), generator=gen, device=dev, dtype=torch.int32)
    print("probe_multidma: m=%d rows of %d B, %d random rows" % (args.m, args.row_words * 4, args.rows))
    return probe(mat, idx, args.chunk, device_label(dev), args.reps, args.plain_baseline)


if __name__ == "__main__":
    main()
