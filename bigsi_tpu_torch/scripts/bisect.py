"""Bisection of the tile-stream kernel on the card, in three subcommands.

The port of ``scripts/bisect_kernel.py`` (S3), ``scripts/bisect_compile.py``
(S4) and ``scripts/bisect_size.py`` (S5).  On the TPU these cut P1's
loop (fetch each k-mer's whole tile, consume it) down to find what the
compiler refused.  Here each stage is a CUDA kernel, and the stages split
kernel B's time:

  k1  kernel G ``tile_xor``: read every row of each k-mer's tile, XOR;
  k2  kernel B's counts-only build (``tile_counts(..., exact=False)``):
      the masked AND of the selected rows and the per-sample counts;
  k3  kernel B (``tile_counts``): k2 plus the exact AND.

The shape is ``bisect_kernel.py``'s: T = 390,625 tiles of 32 rows x 32
words (4 KB), B = 256 queries of K = 8 x 64 k-mers on random tiles, every
slot mask 7 (rows 0-2), no padding.

Subcommands:

  kernel          the three stages, each checked bit for bit against its
                  plain PyTorch version, its time beside the plain time.
  compile B [C]   nvcc's build time of csrc/lookup.cu, then each stage at
                  B queries of 8 x C k-mers (C defaults to 64): the first
                  call (module load, host clock) beside the steady time.
                  The TPU script's NPREF (Mosaic's scalar-prefetch count)
                  and GRID1D (its grid shape) have no counterpart in a
                  CUDA kernel, which loads its own indices and computes
                  its own offsets, and are dropped.  With --ptxas, a
                  second nvcc build with -Xptxas -v first prints each
                  kernel's registers, shared memory and spills.
  size [B ...]    k1 and k3 over a sweep of B (default 64 128 256 512
                  1024), with the time per query.

Device times are CUDA events with a cold L2, each beside the card's name
and power limit; ``--device cpu`` runs the plain versions on the host
clock at a size set by ``--tiles``.

Usage:
  python -m bigsi_tpu_torch.scripts.bisect kernel
  python -m bigsi_tpu_torch.scripts.bisect compile 256 64
  python -m bigsi_tpu_torch.scripts.bisect compile --ptxas 256
  python -m bigsi_tpu_torch.scripts.bisect size 64 128 256
  python -m bigsi_tpu_torch.scripts.bisect --device cpu --tiles 512 kernel
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from bigsi_tpu_torch.index.device_engine import resolve_device
from bigsi_tpu_torch.ops import _build
from bigsi_tpu_torch.ops import fused_lookup as fl
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.scripts.timing import device_label, print_time, same, time_ms

T, B, KC, C = 390_625, 256, 8, 64
TILE_ROWS, W = 32, 32
MASK = 7
SIZES = (64, 128, 256, 512, 1024)
SOURCE = "lookup.cu"


def make_words(tiles: int, device, seed: int = 0) -> torch.Tensor:
    """Random int32[tiles * TILE_ROWS, W], drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2**31, 2**31, (tiles * TILE_ROWS, W), generator=gen,
                         device=device, dtype=torch.int32)


def make_streams(b: int, k: int, tiles: int, device, seed: int = 1):
    """``bisect_kernel.py``'s k-mers: tile ids uniform below ``tiles``
    (numpy's ``default_rng(seed)``), every mask MASK, all valid ->
    (tile int32[b, k], smask int64[b, k], valid bool[b, k])."""
    tile = np.random.default_rng(seed).integers(0, tiles, b * k).astype(np.int32)
    tile = torch.from_numpy(tile.reshape(b, k)).to(device)
    return (tile, torch.full((b, k), MASK, dtype=torch.int64, device=device),
            torch.ones((b, k), dtype=torch.bool, device=device))


def stages(words, tile, smask, valid):
    """[(name, kernel call, plain call)] of the three stages."""
    return [
        ("k1 tile_xor", lambda: fl.tile_xor(words, tile, valid, TILE_ROWS),
         lambda: plain.tile_xor(words, tile, valid, TILE_ROWS)),
        ("k2 tile_counts counts-only", lambda: fl.tile_counts(words, tile, smask, TILE_ROWS, False),
         lambda: plain.blocked_counts(words, tile, smask, TILE_ROWS, False)),
        ("k3 tile_counts + exact", lambda: fl.tile_counts(words, tile, smask, TILE_ROWS),
         lambda: plain.blocked_counts(words, tile, smask, TILE_ROWS)),
    ]


def run_kernel(words, tiles: int, label: str, b: int = B, k: int = KC * C, reps: int = 20,
               plain_reps: int = 3) -> dict:
    """The three stages at b x k; -> {stage: (ms, plain ms)}."""
    tile, smask, valid = make_streams(b, k, tiles, words.device)
    out = {}
    for name, kernel, reference in stages(words, tile, smask, valid):
        if not same(kernel(), reference()):
            raise RuntimeError("%s differs from its plain version" % name)
        ms = time_ms(kernel, reps, words.device)
        plain_ms = time_ms(reference, plain_reps, words.device)
        print_time("%s B=%d K=%d" % (name, b, k), ms, label,
                   "plain PyTorch %10.4f ms, bit-exact" % plain_ms)
        out[name] = (ms, plain_ms)
    return out


def nvcc_seconds() -> float:
    """Wall time of one nvcc build of csrc/lookup.cu: the cached library
    when it is not built yet, else a scratch copy beside it."""
    out = _build.library_path(SOURCE)
    t0 = time.perf_counter()
    if out.exists():
        scratch = _build.BUILD_DIR / "timing" / out.name
        _build.compile_source(SOURCE, scratch)
        scratch.unlink()
    else:
        _build.build(SOURCE)
    return time.perf_counter() - t0


def parse_ptxas(report: str) -> dict[str, str]:
    """-> {entry function: "Used ... registers, ...; N bytes stack frame,
    N bytes spill stores, N bytes spill loads"} from ptxas -v's report."""
    out, entry, frame = {}, None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, frame = m.group(1), ""
        elif "spill stores" in line:
            frame = line.strip()
        elif entry and "Used" in line:
            out[entry] = "%s; %s" % (line.split(":", 1)[1].strip(), frame)
            entry = None
    return out


def ptxas_report() -> dict[str, str]:
    """nvcc -Xptxas -v of csrc/lookup.cu with the library's own flags,
    into a scratch library that is then deleted; -> parse_ptxas of the
    report, with names demangled where c++filt is on PATH."""
    out = _build.BUILD_DIR / "ptxas" / _build.library_path(SOURCE).name
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
           str(_build.CSRC / SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc -Xptxas -v failed (exit %d):\n%s" % (proc.returncode, proc.stderr))
    out.unlink()
    report = parse_ptxas(proc.stderr)
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(report), capture_output=True,
                               text=True).stdout.splitlines()
        if len(names) == len(report):
            report = dict(zip(names, report.values()))
    return report


def host_call_ms(fn, device) -> float:
    """Host-clock ms of one call, synchronised."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def run_compile(words, tiles: int, label: str, b: int, c: int = C, reps: int = 20,
                ptxas: bool = False) -> dict:
    """nvcc's build time, then each stage's first call beside its steady
    time; -> {"nvcc_s": s, stage: (first ms, steady host ms, device ms)},
    with ``ptxas`` also {"ptxas": ptxas_report()}, taken first."""
    dev = words.device
    if dev.type != "cuda":
        raise SystemExit("bisect compile needs a CUDA device (it times nvcc and module loads)")
    out = {}
    if ptxas:
        out["ptxas"] = ptxas_report()
        for name, used in out["ptxas"].items():
            print("ptxas %s: %s" % (name, used), flush=True)
    out["nvcc_s"] = nvcc_seconds()
    print("nvcc build of csrc/%s: %.2f s [%s]" % (SOURCE, out["nvcc_s"], label), flush=True)
    tile, smask, valid = make_streams(b, KC * c, tiles, dev)
    for name, kernel, _ in stages(words, tile, smask, valid):
        first = host_call_ms(kernel, dev)
        steady = sorted(host_call_ms(kernel, dev) for _ in range(reps))[reps // 2]
        device_ms = time_ms(kernel, reps, dev)
        print_time("%s B=%d C=%d" % (name, b, c), device_ms, label,
                   "first call %.3f ms (host clock, with module load), steady %.3f ms "
                   "(host clock, median)" % (first, steady))
        out[name] = (first, steady, device_ms)
    return out


def run_size(words, tiles: int, label: str, sizes=SIZES, k: int = KC * C, reps: int = 20) -> dict:
    """k1 and k3 over a sweep of B; -> {(stage, B): ms}."""
    out = {}
    for b in sizes:
        tile, smask, valid = make_streams(b, k, tiles, words.device)
        for name, kernel, _ in stages(words, tile, smask, valid)[::2]:
            ms = time_ms(kernel, reps, words.device)
            print_time("%s B=%d K=%d" % (name, b, k), ms, label,
                       "%8.3f us per query" % (ms * 1e3 / b))
            out[name, b] = ms
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter,
                                 epilog="\n".join(__doc__.splitlines()[1:]))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiles", type=int, default=T, help="tiles of the random matrix")
    ap.add_argument("--reps", type=int, default=20)
    sub = ap.add_subparsers(dest="command", required=True)
    sub.add_parser("kernel", help="the three stages against their plain versions")
    p = sub.add_parser("compile", help="nvcc time, first call vs steady")
    p.add_argument("b", type=int)
    p.add_argument("c", type=int, nargs="?", default=C)
    p.add_argument("--ptxas", action="store_true",
                   help="first print each kernel's registers, shared memory and spills")
    p = sub.add_parser("size", help="k1 and k3 over a sweep of B")
    p.add_argument("b", type=int, nargs="*", default=list(SIZES))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    words = make_words(args.tiles, dev)
    label = device_label(dev)
    if args.command == "kernel":
        return run_kernel(words, args.tiles, label, reps=args.reps)
    if args.command == "compile":
        return run_compile(words, args.tiles, label, args.b, args.c, args.reps, args.ptxas)
    return run_size(words, args.tiles, label, args.b, reps=args.reps)


if __name__ == "__main__":
    main()
