"""Where kernels I (``kmer_rows``) and J (``bloom_scatter``) spend their
time on the card: builds of ``csrc/lookup.cu`` with one part cut out or
one design choice reversed, timed beside the full build in one process.

Each cut is a text substitution on this checkout's ``lookup.cu`` (each
must match exactly once, so a stale cut fails loudly):

* ``full``: the source as it is;
* ``no_atomics``: J's atomics are never sent (its reads and hashing alone);
* ``forward_only``: every k-mer hashed on its forward strand (no strand
  decision, no reverse complement);
* ``one_word``: murmur3 over one word and the tail (the reader, the
  stores and the floor-mods with little hashing);
* ``threads_256``: 256-thread blocks, runs of 256 k-mers;
* ``cp_async_cg``: the stage copies bypass L1 (``cp.async.cg``);
* ``persistent``: as many blocks as fit the card at once, each taking
  runs two stages deep, in place of a block a run.

The cut builds compute other results than the contract's, so only
``full``, ``threads_256``, ``cp_async_cg`` and ``persistent`` are checked
against the plain versions.  The timed cases are probe_ij's: kernel I
(canonical classic rows, h = 3, m = 2.5e7) on 131,072 and 4,000,000
random 31-mers, kernel J classic and blocked/32 on the 4,000,000.  Times
are CUDA events with a cold L2 (``scripts/timing.py:cuda_ms``), beside
the card's name and power limit; the builds (one nvcc each, run
together) go under ``build/bigsi_tpu_torch/probe_ij_split/``.  It needs
a CUDA device.

Usage:
  python -m bigsi_tpu_torch.scripts.probe_ij_split [--seed N] [--reps N] [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from bigsi_tpu_torch.index.device_engine import resolve_device
from bigsi_tpu_torch.ops import _build, build
from bigsi_tpu_torch.ops import hash as kmer_hash
from bigsi_tpu_torch.scripts.probe_ij import BATCH, H, K_LEN, KMERS, M, random_kmers
from bigsi_tpu_torch.scripts.timing import device_label, print_time, time_ms

SOURCE = _build.CSRC / "lookup.cu"
OUT_DIR = _build.BUILD_DIR / "probe_ij_split"
# name -> the substitutions that make it, each matching exactly once
CUTS = {
    "full": (),
    "no_atomics": (
        ("if ((row >> 5) < bloom_words) atomicOr(",
         "if ((row >> 5) < bloom_words && row == -7) atomicOr("),
        ("if (!placed) atomicOr(", "if (!placed && bit == 0u) atomicOr("),
        ("if (word[u] >= 0) atomicOr(", "if (word[u] >= 0 && bits[u] == 0u) atomicOr("),
    ),
    "forward_only": (
        ("&& reverse_is_smaller(st, s0 + j * k, k);",
         "&& reverse_is_smaller(st, s0 + j * k, k) && k < 0;"),
        ("k, reverse_is_smaller(st, s0 + j * k, k));",
         "k, reverse_is_smaller(st, s0 + j * k, k) && k < 0);"),
    ),
    "one_word": (("const int nblocks = km.k >> 2;", "const int nblocks = km.k > 3 ? 1 : 0;"),),
    "threads_256": (("constexpr int kHashThreads = 128;", "constexpr int kHashThreads = 256;"),),
    "cp_async_cg": (("cp.async.ca.shared.global", "cp.async.cg.shared.global"),),
    "persistent": (
        ("  p.grid = static_cast<unsigned>(std::min<int64_t>((K + run - 1) / run, kMaxHashBlocks));",
         "  int sms = 0, per_sm = 0;\n"
         "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);\n"
         "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kHashThreads,\n"
         "                                                static_cast<size_t>(smem));\n"
         "  p.grid = static_cast<unsigned>(std::min<int64_t>(\n"
         "      (K + run - 1) / run, static_cast<int64_t>(sms) * std::max(1, per_sm)));"),
    ),
}
EXACT = ("full", "threads_256", "cp_async_cg", "persistent")


def cut_source(name: str, text: str) -> str:
    """``text`` with cut ``name``'s substitutions applied."""
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise RuntimeError("cut %s: %r matches %d times in lookup.cu"
                               % (name, old, text.count(old)))
        text = text.replace(old, new)
    return text


def build_cut(name: str, text: str) -> str:
    """nvcc of cut ``name`` with the library's own flags -> its path."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src, out = OUT_DIR / ("%s.cu" % name), OUT_DIR / ("%s.so" % name)
    src.write_text(cut_source(name, text))
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc of cut %s failed:\n%s" % (name, proc.stderr))
    return str(out)


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.kmer_rows.argtypes = [ptr, i64, i32, i32, ptr, i32, i32, i32, i32, ptr, ptr]
    lib.bloom_scatter.argtypes = [ptr, i64, i32, ptr, i32, i32, i32, i32, i64, ptr, ptr]
    return lib


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter,
                                 epilog="\n".join(__doc__.splitlines()[1:]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    label = device_label(dev)
    text = SOURCE.read_text()
    with ThreadPoolExecutor(len(CUTS)) as pool:
        paths = dict(zip(CUTS, pool.map(lambda name: build_cut(name, text), CUTS)))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    batch = random_kmers(BATCH, gen, dev)
    sample = random_kmers(KMERS, gen, dev)
    seeds = torch.arange(H, dtype=torch.int32, device=dev)
    blocked_seeds = torch.arange(H + 1, dtype=torch.int32, device=dev)
    want = {"I sample": kmer_hash.kmer_rows_plain(sample, seeds, "classic", True, M),
            "J classic": build.bloom_plain(sample, seeds, "classic", M),
            "J blocked/32": build.bloom_plain(sample, blocked_seeds, "blocked", M, 32)}
    out = {"label": label}
    for name, path in paths.items():
        lib = load(path)

        def rows(km, lib=lib):
            res = torch.empty((km.shape[0], H), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.kmer_rows(km.data_ptr(), km.shape[0], K_LEN, 1, seeds.data_ptr(), H,
                                kmer_hash.KMER_OUTS.index("classic"), M, 1, res.data_ptr(),
                                stream)
            if err:
                raise RuntimeError("kmer_rows of cut %s failed: %d" % (name, err))
            return res

        def bloom(s, layout, tile_rows, lib=lib):
            res = torch.zeros(-(-M // 32), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.bloom_scatter(sample.data_ptr(), sample.shape[0], K_LEN, s.data_ptr(),
                                    s.numel(), kmer_hash.KMER_OUTS.index(layout), M, tile_rows,
                                    res.numel(), res.data_ptr(), stream)
            if err:
                raise RuntimeError("bloom_scatter of cut %s failed: %d" % (name, err))
            return res

        cases = {"I batch": lambda: rows(batch), "I sample": lambda: rows(sample),
                 "J classic": lambda: bloom(seeds, "classic", 1),
                 "J blocked/32": lambda: bloom(blocked_seeds, "blocked", 32)}
        if name in EXACT:
            for case, w in want.items():
                if not torch.equal(cases[case](), w):
                    raise RuntimeError("cut %s: %s differs from its plain version" % (name, case))
        row = {case: time_ms(fn, args.reps, dev) for case, fn in cases.items()}
        out[name] = row
        print_time("cut %s" % name, row["J classic"], label, "J classic; J blocked/32 %.4f, "
                   "I sample %.4f, I batch %.4f ms%s"
                   % (row["J blocked/32"], row["I sample"], row["I batch"],
                      "; checked" if name in EXACT else ""))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
