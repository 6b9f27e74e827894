#!/usr/bin/env python3
"""Smoke run of bigsi_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Drives the port's search path at BASELINE.json's second config: 1,024
samples, m = 2.5e7 bloom bits, h = 3, k = 31, so a uint32[25,000,000, 32]
matrix, 3.2 GB on the card; batches of 256 queries of 542 bp (512
k-mers each), the shape of bench.py.  Phases:

1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles bigsi_tpu_torch/csrc/lookup.cu with nvcc;
3. kernels: kernels A (classic_counts), B (tile_counts), C
   (grouped_tile_counts), D (pack_tile_cols) and E (cols_counts) agree
   bit for bit with their plain PyTorch versions, at the slice's shapes
   (the full-size matrix, B = 256, K = 512, grouped streams from runs of
   tiles as the minimizer layout makes them, D and E at tile_rows 16
   and 32) and at ragged ones (W 1 and 33, tile_rows 8 to 64, R 1, 6
   and 20, U not a multiple of 16, empty and all-padding queries, B or
   K of 0);
4.-8. five indexes, each an in-memory index of random rows at the bit
   density of scripts/synth_index.py, drawn on the card, with 4 planted
   samples: classic (kernel A), blocked at tile_rows 32 (kernel B),
   minimizer at tile_rows 16 with w = 19, slot scheme 3, r = 20 (the
   JAX package's headline serving config), minimizer at the default
   tile_rows 32, window and slot scheme (w = 11, scheme 3, r = 6) --
   both cols indexes run kernel D at engine load and kernel E through
   counts_batch_kmers, which must serve every batch -- and minimizer at
   tile_rows 64 (kernel C through counts_batch).  Each runs a single
   search, a bulk_search of a 256-record FASTA through the port's CLI
   at thresholds 1.0 and 0.7, and 3 GET and 1 POST /search against the
   port's HTTP server.  Every result dict must equal what the facade
   returns on the numpy host engine (``engine: numpy``) on the same
   index.  The launch counts are set to 0 before each index and read
   after it: its kernels must have run, and no other;
9. times, each beside the GPU's name and power limit: search_batch
   latency and queries/s for 256 queries, split inside each call by the
   facade's timers into host k-mer prep, the engine's counts_batch (or
   counts_batch_kmers) and result building; each kernel beside its
   plain version on the inputs the facade gave the engine (kernel E on
   the streams of the facade's own counts_batch_kmers calls); kernel D
   once on the full-size matrix, and kernel C on the minimizer/16
   streams of kernel E, over the row-major words D packs.

Then one JSON line of the kernels, and last the JSON line
{"ok": true, "device": {...}}.  Any failure exits non-zero; with no
CUDA device it exits 1 before printing any result.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
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
# the five kernels: (name, TPU kernel or XLA program it replaces)
KERNELS = (
    ("classic_counts", "bigsi_tpu/index/device_engine.py:89"),
    ("tile_counts", "bigsi_tpu/ops/pallas_lookup.py:203"),
    ("grouped_tile_counts",
     "bigsi_tpu/ops/pallas_lookup.py:322, bigsi_tpu/ops/pallas_grouped.py:149"),
    ("pack_tile_cols", "bigsi_tpu/ops/lookup.py:338"),
    ("cols_counts", "bigsi_tpu/ops/lookup.py:419"),
)
COLS_KERNELS = ("pack_tile_cols", "cols_counts")
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
# the indexes whose batches counts_batch_kmers must serve, with their r
KMER_PATHS = {HEADLINE: HEADLINE_R, "minimizer/32": DEFAULT_R}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + what)


def kernel_fns():
    from bigsi_tpu_torch.ops import fused_lookup

    return {name: getattr(fused_lookup, name) for name, _ in KERNELS}


# -- phase 1 ------------------------------------------------------------


def phase_device() -> str:
    import torch

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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
    from bigsi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    source = Path(SOURCE).name
    _build.load(source)
    print("phase 2 build: %s ready in %.1f s"
          % (_build.library_path(source).relative_to(ROOT), time.perf_counter() - t0),
          flush=True)


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
            if not torch.equal(g, w):  # in row chunks: a full-size int64 copy is 12.8 GB
                step = max(1, (1 << 26) // max(1, g[0].numel()))
                err = max(int((g[i:i + step].long() - w[i:i + step].long()).abs().max())
                          for i in range(0, g.shape[0], step))
            self.max[name] = max(self.max[name], err)
            check(err == 0, "%s %s differs from its plain version by %d"
                  % (name, case, err))


def random_tile_inputs(gen, b, k, num_tiles, tile_rows, pad_frac, dev, mean_run=2):
    """Tile ids in runs of about ``mean_run`` k-mers (as the minimizer
    layout makes them) and 64-bit slot masks of H random rows; a
    fraction of k-mers are padding (mask 0)."""
    import torch

    run_id = (torch.rand((b, k), generator=gen, device=dev) < 1.0 / mean_run).long().cumsum(1)
    per_run = torch.randint(0, num_tiles, (b, k + 1), generator=gen, device=dev, dtype=torch.int32)
    tile = per_run.gather(1, run_id).contiguous()
    slots = torch.randint(0, tile_rows, (b, k, H), generator=gen, device=dev)
    smask = (torch.ones_like(slots) << slots)
    smask = smask[..., 0] | smask[..., 1] | smask[..., 2]
    pad = torch.rand((b, k), generator=gen, device=dev) < pad_frac
    return tile, torch.where(pad, 0, smask).contiguous()


def random_grouped_inputs(gen, b, u, r, num_tiles, tile_rows, pad_frac, dev):
    """Grouped streams drawn directly: any U, padding slots (mask 0)."""
    import torch

    utile = torch.randint(0, num_tiles, (b, u), generator=gen, device=dev, dtype=torch.int32)
    _, gmask = random_tile_inputs(gen, b, u * r, num_tiles, tile_rows, pad_frac, dev)
    return utile, gmask.view(b, u, r).contiguous()


def phase_kernels(gen, errors: Errors) -> None:
    import torch

    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    dev = torch.device(DEVICE)
    cases = 0

    def classic(words, b, k, h, pad_frac, case):
        m = words.shape[0]
        idx = torch.randint(0, m, (b, k, h), generator=gen, device=dev, dtype=torch.int32)
        mask = torch.rand((b, k), generator=gen, device=dev) >= pad_frac
        errors.compare("classic_counts", fl.classic_counts(words, idx, mask),
                       plain.batched_counts(words, idx, mask), case)

    def tiled(words, b, k, tile_rows, pad_frac, case):
        tile, smask = random_tile_inputs(
            gen, b, k, words.shape[0] // tile_rows, tile_rows, pad_frac, dev)
        errors.compare("tile_counts", fl.tile_counts(words, tile, smask, tile_rows),
                       plain.blocked_counts(words, tile, smask, tile_rows), case)

    def grouped(words, cols, utile, gmask, tile_rows, case):
        """Kernel C on the row-major words and, with cols, kernel E."""
        errors.compare("grouped_tile_counts",
                       fl.grouped_tile_counts(words, utile, gmask, tile_rows),
                       plain.grouped_counts(words, utile, gmask, tile_rows), case)
        if cols is not None:
            n_valid = (gmask != 0).sum(dim=(1, 2), dtype=torch.int32)
            errors.compare("cols_counts", fl.cols_counts(cols, utile, gmask, n_valid),
                           plain.grouped_counts_cols(cols, utile, gmask, n_valid), case)

    def streams(words, b, k, tile_rows, r, pad_frac, mean_run=HEADLINE_RUN):
        tile, smask = random_tile_inputs(
            gen, b, k, words.shape[0] // tile_rows, tile_rows, pad_frac, dev, mean_run)
        return plain.build_grouped_streams(tile, smask, r)

    # the slice's shapes: the full-size matrix, B = 256, K = 512, h = 3
    words = torch.randint(-2**31, 2**31, (M, W), generator=gen, device=dev,
                          dtype=torch.int32)
    classic(words, B, 512, H, 0.05, "slice")
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
    # ragged shapes
    for w in (1, 33):
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
            for b, u, r, pad in ((5, 13, 6, 0.3), (3, 37, 20, 0.1), (4, 7, 1, 0.0),
                                 (2, 21, 6, 1.0), (0, 16, 6, 0.0)):
                utile, gmask = random_grouped_inputs(gen, b, u, r, num_tiles, tile_rows, pad, dev)
                grouped(words, cols, utile, gmask, tile_rows,
                        "W=%d tile_rows=%d B=%d U=%d R=%d pad=%.1f" % (w, tile_rows, b, u, r, pad))
                cases += 1
            if tile_rows == 32:
                for b, k, h, pad in ((5, 700, 3, 0.3), (1, 1, 1, 0.0), (3, 0, 3, 0.0),
                                     (2, 64, 3, 1.0), (2, 3000, 3, 0.1), (4, 200, 1, 0.5)):
                    case = "W=%d B=%d K=%d h=%d pad=%.1f" % (w, b, k, h, pad)
                    classic(words, b, k, h, pad, case)
                    cases += 1
    torch.cuda.synchronize()
    print("phase 3 kernels: all five kernels bit-exact with their plain versions in %d "
          "cases (slice shapes W=%d m=%d B=%d K=512 h=%d, grouped streams of runs of ~%d "
          "k-mers at R=%d and ~%d at R=%d, D and E at tile_rows 16 and 32; ragged W 1/33, "
          "tile_rows 8/16/32/64, R 1/6/20, U 7/13/21/37, all-padding queries, B or K of 0)"
          % (cases, W, M, B, H, HEADLINE_RUN, HEADLINE_R, DEFAULT_RUN, DEFAULT_R), flush=True)


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
    """Records the arguments of every call of the named methods on every
    DeviceEngine (the CLI and the server make their own):
    ``with EngineCalls(name, ...) as calls`` gives {name: [args, ...]}."""

    def __init__(self, *names):
        from bigsi_tpu_torch.index.device_engine import DeviceEngine

        self.cls = DeviceEngine
        self.calls = {name: [] for name in names}
        self.real = {name: getattr(DeviceEngine, name) for name in names}

    def __enter__(self):
        for name, real in self.real.items():
            def wrapper(engine, *args, _seen=self.calls[name], _real=real):
                _seen.append(args)
                return _real(engine, *args)

            setattr(self.cls, name, wrapper)
        return self.calls

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.cls, name, real)


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
    port = BIGSI(config, device=DEVICE)
    check(type(port.engine).__name__ == "DeviceEngine", "the port runs its CUDA engine")
    kmer = name in KMER_PATHS
    if kmer:
        engine = port.engine
        check(engine.run_len == KMER_PATHS[name] and engine.slot_scheme == 3
              and engine.cols is not None and engine.words is None,
              "%s: cols engine with slot scheme 3 and r = %d" % (name, KMER_PATHS[name]))
        check(engine.supports_kmer_batch(), "%s: counts_batch_kmers serves" % name)
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
    with EngineCalls("counts_batch", "counts_batch_kmers") as calls:
        for t in (1.0, 0.7):
            args = make_parser().parse_args(
                ["bulk_search", str(fasta), "-t", str(t), "-c", str(cfg_path)])
            got = json.loads(run(args, device=DEVICE))
            want = [result_dict(s, t, r) for s, r in zip(seqs, host.search_batch(seqs, t))]
            check(got == want, "%s bulk_search at %.1f equals the host's" % (name, t))
            n_hits[t] = sum(len(d["results"]) for d in got)
            compared += len(got)
    check(n_hits[1.0] > 0 and n_hits[0.7] > n_hits[1.0],
          "bulk_search finds exact and inexact hits: %s" % n_hits)
    served = {method: len(args) for method, args in calls.items()}
    used, unused = ("counts_batch_kmers", "counts_batch")[::1 if kmer else -1]
    check(served[used] > 0 and served[unused] == 0,
          "%s: %s served every batch: %s" % (name, used, served))

    # HTTP /search: 3 GET and 1 POST
    server = make_server(config, host="127.0.0.1", port=0, device=DEVICE)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://127.0.0.1:%d/search" % server.server_address[1]
        gets = ((seqs[0], 1.0), (seqs[1], 0.7), (seqs[3], 0.7))
        for s, t in gets:
            got = http_json(base + "?" + urllib.parse.urlencode({"seq": s, "threshold": t}))
            check(got == result_dict(s, t, host.search(s, t)),
                  "%s GET /search equals the host's" % name)
        got = http_json(base, {"seq": seqs[5], "threshold": 0.7})
        check(got == result_dict(seqs[5], 0.7, host.search(seqs[5], 0.7)),
              "%s POST /search equals the host's" % name)
        compared += 4
    finally:
        server.shutdown()
        server.invalidate()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the HTTP server stopped")
    print("phase %d %s: index of %d samples, m=%d, made in %.1f s; %d result "
          "lists equal the host engine's (search, bulk_search at 1.0 and 0.7 with "
          "%d and %d hits through %s, HTTP 3 GET + 1 POST)"
          % (number, name, N, M, t_index, compared, n_hits[1.0], n_hits[0.7],
             "counts_batch_kmers" if kmer else "counts_batch"),
          flush=True)
    return port, seqs


# -- phase 9 ------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call, each started with a cold L2, as a
    batch of new queries finds it: a 512 MB write (ten times the L2)
    runs before each call and keeps the device busy while the host
    enqueues it, so the time excludes the host's launch overhead."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.int32, device=DEVICE)
    fn()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def search_batch_layers(port, seqs, reps: int) -> list[dict]:
    """Times of `reps` search_batch calls of the whole batch, each split
    by the facade's own timers inside that call: the engine's
    counts_batch or counts_batch_kmers ("search.batch_counts"), result
    building ("search.batch_results"), and the rest, which is k-mer
    extraction, hashing and padding on the host; inside
    counts_batch_kmers, the engine's own spans split the native prep
    ("engine.kmer_prep") from copies, kernel and counts back
    ("engine.kmer_counts").  All in ms."""
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
        for span in ("engine.kmer_prep", "engine.kmer_counts"):
            if span in timers:
                call[span] = timers[span]["total_s"] * 1e3
        calls.append(call)
    return calls


def engine_inputs(port, seqs, method: str):
    """The arguments the facade hands the engine's ``method`` in one
    search_batch of `seqs`."""
    with EngineCalls(method) as calls:
        port.search_batch(seqs, 1.0)
    seen = calls[method]
    check(len(seen) == 1, "one %s per search_batch, got %d" % (method, len(seen)))
    return seen[0]


def timed_kernel(name, kernel, reference, args, errors, case):
    errors.compare(name, kernel(*args), reference(*args), case)
    return cuda_ms(lambda: kernel(*args), 20), cuda_ms(lambda: reference(*args), 5)


def phase_times(number: int, gpu: str, runs, errors: Errors) -> dict:
    """-> {kernel: (ms, plain ms)}, each kernel on the first index of its
    path (kernel E on minimizer/16)."""
    import torch

    from bigsi_tpu_torch.index.device_engine import kmer_streams_to_device, load_words, tile_streams
    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    kernel_ms, kmer_streams = {}, {}
    for name, (port, seqs) in runs.items():
        engine = port.engine
        dev = engine.device
        calls = search_batch_layers(port, seqs, 5)
        mid = sorted(calls, key=lambda c: c["search_batch"])[len(calls) // 2]
        kmer = name in KMER_PATHS
        if kmer:
            kname = "cols_counts"
            prep, _ = engine_inputs(port, seqs, "_dispatch_kmer_chunk")
            kmer_streams[name] = kmer_streams_to_device(prep, dev)
            args = (engine.cols, *kmer_streams[name])
            kernel, reference = fl.cols_counts, plain.grouped_counts_cols
            shape = "B=%d U=%d R=%d" % tuple(args[2].shape)
        else:
            idx, mask = engine_inputs(port, seqs, "counts_batch")[:2]
            idx_t = torch.from_numpy(idx.astype(np.int32)).to(dev)
            mask_t = torch.from_numpy(mask).to(dev)
            shape = "B=%d K=%d h=%d" % idx.shape
            if engine.layout == "classic":
                kname, kernel, reference = "classic_counts", fl.classic_counts, plain.batched_counts
                args = (engine.words, idx_t, mask_t)
            else:
                tile, smask = tile_streams(idx_t, mask_t, engine.tile_rows)
                if engine.layout == "blocked":
                    kname, kernel, reference = "tile_counts", fl.tile_counts, plain.blocked_counts
                    args = (engine.words, tile, smask, engine.tile_rows)
                else:
                    kname = "grouped_tile_counts"
                    kernel, reference = fl.grouped_tile_counts, plain.grouped_counts
                    utile, gmask = plain.build_grouped_streams(tile, smask, engine.run_len)
                    args = (engine.words, utile, gmask, engine.tile_rows)
                    shape += " U=%d R=%d" % gmask.shape[1:]
        k_ms, p_ms = timed_kernel(kname, kernel, reference, args, errors, "%s batch" % name)
        kernel_ms.setdefault(kname, (k_ms, p_ms))
        inside = ""
        if kmer:
            inside = " (native prep %.3f ms, copies + kernel + counts back %.3f ms)" % (
                mid["engine.kmer_prep"], mid["engine.kmer_counts"])
        print("phase %d times %s [%s]: search_batch of %d queries, median of %d calls "
              "%.3f ms (%.1f queries/s); inside that call: k-mer extraction and padding "
              "on the host %.3f ms, engine %s %.3f ms%s, result building %.3f ms; %s "
              "kernel %.4f ms vs plain PyTorch %.4f ms (%s, cold L2); kernel share of "
              "search_batch %.4f"
              % (number, name, gpu, B, len(calls), mid["search_batch"],
                 B / mid["search_batch"] * 1e3, mid["prep"],
                 "counts_batch_kmers" if kmer else "counts_batch", mid["counts"], inside,
                 mid["results"], kname, k_ms, p_ms, shape, k_ms / mid["search_batch"]),
              flush=True)
        print("phase %d calls %s [%s]: %s" % (number, name, gpu, json.dumps(calls)), flush=True)

    # kernel D once on the full-size matrix of the minimizer/16 index,
    # held to the cols its engine built at load and to the plain version
    engine = runs[HEADLINE][0].engine
    tile_rows = engine.tile_rows
    words = load_words(np.asarray(engine.matrix.words), engine.device, tile_rows)
    cols = fl.pack_tile_cols(words, tile_rows)
    check(torch.equal(cols, engine.cols), "kernel D repeats the engine's cols")
    del cols
    args = (words, tile_rows)
    errors.compare("pack_tile_cols", (fl.pack_tile_cols(*args),),
                   (plain.pack_tile_cols(*args),), "full size")
    d_ms = cuda_ms(lambda: fl.pack_tile_cols(*args), 5)
    d_plain = cuda_ms(lambda: plain.pack_tile_cols(*args), 2)
    kernel_ms["pack_tile_cols"] = (d_ms, d_plain)
    print("phase %d times pack_tile_cols [%s]: m=%d W=%d tile_rows=%d, %.4f ms vs plain "
          "PyTorch %.4f ms (%.1f GB/s read + write)"
          % (number, gpu, M, W, tile_rows, d_ms, d_plain,
             2 * words.numel() * 4 / d_ms / 1e6), flush=True)

    # kernel C on kernel E's minimizer/16 streams, over the row-major
    # words: the same counts, from the layout without cols
    utile, gmask, n_valid = kmer_streams[HEADLINE]
    c_args = (words, utile, gmask, tile_rows)
    c_ms, c_plain = timed_kernel("grouped_tile_counts", fl.grouped_tile_counts,
                                 plain.grouped_counts, c_args, errors, "minimizer/16 streams")
    e_out = fl.cols_counts(engine.cols, utile, gmask, n_valid)
    check(all(torch.equal(c, e) for c, e in zip(fl.grouped_tile_counts(*c_args), e_out)),
          "kernels C and E agree on the minimizer/16 streams")
    print("phase %d times C vs E [%s]: minimizer/16 streams of the facade (B=%d U=%d R=%d), "
          "kernel C over the row-major words %.4f ms (plain %.4f ms) vs kernel E over the "
          "cols %.4f ms (cold L2); equal counts and exact"
          % ((number, gpu) + tuple(gmask.shape) + (c_ms, c_plain, kernel_ms["cols_counts"][0])),
          flush=True)
    del words, args, c_args
    print("phase %d memory [%s]: peak %.2f GB allocated on the device"
          % (number, gpu, torch.cuda.max_memory_allocated() / 1e9), flush=True)
    return kernel_ms


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
    check("jax" not in sys.modules, "jax was never imported")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errors.max[name],
         "ms": kernel_ms[name][0], "plain_ms": kernel_ms[name][1]}
        for name, replaces in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
