#!/usr/bin/env python3
"""Smoke run of bigsi_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Drives the port's search path at BASELINE.json's second config: 1,024
samples, m = 2.5e7 bloom bits, h = 3, k = 31, so a uint32[25,000,000, 32]
matrix, 3.2 GB on the card; batches of 256 queries of 542 bp (512
k-mers each), the shape of bench.py.  Phases:

1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles bigsi_tpu_torch/csrc/lookup.cu with nvcc;
3. kernels: kernel A (classic_counts) and kernel B (tile_counts) agree
   bit for bit with their plain PyTorch versions, at the slice's shapes
   and at ragged ones (W 1 and 33, tile_rows 8 to 64, empty and partial
   masks, K past the kernels' staging chunk);
4. classic index, 5. minimizer index at tile_rows 32: an in-memory
   index of random rows at the bit density of scripts/synth_index.py,
   drawn on the card, with 4 planted samples; a single search, a
   bulk_search of a 256-record FASTA through the port's CLI at
   thresholds 1.0 and 0.7, and 3 GET and 1 POST /search against the
   port's HTTP server.  Every result dict must equal what the facade
   returns on the numpy host engine (``engine: numpy``) on the same
   index, and kernel A (phase 4) and kernel B (phase 5) must have been
   launched;
6. times, each beside the GPU's name and power limit: search_batch
   latency and queries/s for 256 queries, split inside each call by the
   facade's timers into host k-mer prep, the engine's counts_batch and
   result building; and each kernel beside its plain version on the
   inputs the facade gave the engine.

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
TILE_ROWS = 32
DEVICE = "cuda"
SOURCE = "bigsi_tpu_torch/csrc/lookup.cu"
REPLACES = {
    "classic_counts": "bigsi_tpu/index/device_engine.py:89",
    "tile_counts": "bigsi_tpu/ops/pallas_lookup.py:203",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + what)


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
    path = _build.build("lookup.cu")
    _build.load("lookup.cu")
    print(
        "phase 2 build: %s ready in %.1f s"
        % (path.relative_to(ROOT), time.perf_counter() - t0),
        flush=True,
    )


# -- phase 3 ------------------------------------------------------------


class Errors:
    """Largest |kernel - plain| seen per kernel; any nonzero fails."""

    def __init__(self):
        self.max = {"classic_counts": 0, "tile_counts": 0}

    def compare(self, name, got, want, case):
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  "%s %s: shape/dtype %s %s vs %s %s"
                  % (name, case, g.shape, g.dtype, w.shape, w.dtype))
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            self.max[name] = max(self.max[name], err)
            check(err == 0, "%s %s differs from its plain version by %d"
                  % (name, case, err))


def random_tile_inputs(gen, b, k, num_tiles, tile_rows, pad_frac, dev):
    """Tile ids in runs (as the minimizer layout makes them) and slot
    masks of H random rows; a fraction of k-mers are padding (mask 0)."""
    import torch

    tile = torch.randint(0, num_tiles, (b, k), generator=gen, device=dev, dtype=torch.int32)
    tile[:, 1::2] = tile[:, 0::2][:, : tile[:, 1::2].shape[1]]
    slots = torch.randint(0, tile_rows, (b, k, H), generator=gen, device=dev)
    smask = (torch.ones_like(slots) << slots)
    smask = smask[..., 0] | smask[..., 1] | smask[..., 2]
    pad = torch.rand((b, k), generator=gen, device=dev) < pad_frac
    return tile, torch.where(pad, 0, smask).contiguous()


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

    # the slice's shapes: the full-size matrix, B = 256, K = 512, h = 3
    words = torch.randint(-2**31, 2**31, (M, W), generator=gen, device=dev,
                          dtype=torch.int32)
    classic(words, B, 512, H, 0.05, "slice")
    tiled(words, B, 512, TILE_ROWS, 0.05, "slice")
    cases += 2
    del words
    # ragged shapes
    for w in (1, 33):
        for tile_rows in (8, 16, 32, 64):
            words = torch.randint(-2**31, 2**31, (tile_rows * 3001, w),
                                  generator=gen, device=dev, dtype=torch.int32)
            for b, k, pad in ((5, 700, 0.3), (3, 0, 0.0), (2, 64, 1.0), (2, 3000, 0.1)):
                case = "W=%d tile_rows=%d B=%d K=%d pad=%.1f" % (w, tile_rows, b, k, pad)
                tiled(words, b, k, tile_rows, pad, case)
                cases += 1
            if tile_rows == 32:
                for b, k, h, pad in ((5, 700, 3, 0.3), (1, 1, 1, 0.0), (3, 0, 3, 0.0),
                                     (2, 64, 3, 1.0), (2, 3000, 3, 0.1), (4, 200, 1, 0.5)):
                    case = "W=%d B=%d K=%d h=%d pad=%.1f" % (w, b, k, h, pad)
                    classic(words, b, k, h, pad, case)
                    cases += 1
    torch.cuda.synchronize()
    print("phase 3 kernels: classic_counts and tile_counts bit-exact with their "
          "plain versions in %d cases (slice shapes W=%d m=%d B=%d K=512 h=%d "
          "tile_rows=%d; ragged W 1/33, tile_rows 8/16/32/64, empty and partial "
          "masks)" % (cases, W, M, B, H, TILE_ROWS), flush=True)


# -- phases 4 and 5 -----------------------------------------------------


def random_seq(rng, n: int) -> str:
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def mutate(rng, seq: str, snps: int) -> str:
    out = list(seq)
    for pos in rng.choice(len(seq), size=snps, replace=False):
        out[pos] = "ACGT"[("ACGT".index(out[pos]) + 1 + rng.integers(0, 3)) % 4]
    return "".join(out)


def make_index(layout: str, gen, rng) -> tuple[dict, list[str]]:
    """An in-memory index of N samples: random rows drawn on the card at
    the density of a bloom of KMERS_PER_SAMPLE k-mers, with the planted
    samples' blooms in columns 0..PLANTED-1.  Returns its config and the
    planted sequences."""
    from bigsi_tpu_torch.synth import bloom_density, synth_index

    config = {
        "storage-engine": "memory",
        "storage-config": {"filename": "chip-smoke-" + layout},
        "k": K_LEN, "m": M, "h": H, "layout": layout,
    }
    if layout != "classic":
        config["tile-rows"] = TILE_ROWS
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


def phase_slice(number: int, layout: str, gen, rng):
    import yaml

    from bigsi_tpu_torch import BIGSI
    from bigsi_tpu_torch.__main__ import make_parser, result_dict, run
    from bigsi_tpu_torch.http.server import make_server

    t0 = time.perf_counter()
    config, planted = make_index(layout, gen, rng)
    t_index = time.perf_counter() - t0
    seqs = make_queries(rng, planted)
    host = BIGSI(dict(config, engine="numpy"))  # the numpy HostEngine, the reference
    check(type(host.engine).__name__ == "HostEngine", "the reference runs the host engine")
    port = BIGSI(config, device=DEVICE)
    check(type(port.engine).__name__ == "DeviceEngine", "the port runs its CUDA engine")
    compared = 0

    # single search of a planted query
    q = planted[0][:QUERY_LEN]
    for t in (1.0, 0.7):
        got = port.search(q, t)
        check(got == host.search(q, t), "%s search at %.1f equals the host's" % (layout, t))
        compared += 1
    check(any(r["sample_name"] == "planted0" and r["percent_kmers_found"] == 100.0
              for r in port.search(q, 1.0)), "the planted sample is found")

    # bulk_search of a FASTA through the port's CLI
    WORK.mkdir(parents=True, exist_ok=True)
    fasta = WORK / "queries.fasta"
    fasta.write_text("".join(">q%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))
    cfg_path = WORK / ("%s.yaml" % layout)
    cfg_path.write_text(yaml.safe_dump(config))
    n_hits = {}
    for t in (1.0, 0.7):
        args = make_parser().parse_args(
            ["bulk_search", str(fasta), "-t", str(t), "-c", str(cfg_path)])
        got = json.loads(run(args, device=DEVICE))
        want = [result_dict(s, t, r) for s, r in zip(seqs, host.search_batch(seqs, t))]
        check(got == want, "%s bulk_search at %.1f equals the host's" % (layout, t))
        n_hits[t] = sum(len(d["results"]) for d in got)
        compared += len(got)
    check(n_hits[1.0] > 0 and n_hits[0.7] > n_hits[1.0],
          "bulk_search finds exact and inexact hits: %s" % n_hits)

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
                  "%s GET /search equals the host's" % layout)
        got = http_json(base, {"seq": seqs[5], "threshold": 0.7})
        check(got == result_dict(seqs[5], 0.7, host.search(seqs[5], 0.7)),
              "%s POST /search equals the host's" % layout)
        compared += 4
    finally:
        server.shutdown()
        server.invalidate()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the HTTP server stopped")
    print("phase %d %s: index of %d samples, m=%d, made in %.1f s; %d result "
          "lists equal the host engine's (search, bulk_search at 1.0 and 0.7 with "
          "%d and %d hits, HTTP 3 GET + 1 POST)"
          % (number, layout, N, M, t_index, compared, n_hits[1.0], n_hits[0.7]),
          flush=True)
    return port, seqs


# -- phase 6 ------------------------------------------------------------


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
    counts_batch ("search.batch_counts"), result building
    ("search.batch_results"), and the rest, which is k-mer extraction,
    hashing and padding on the host.  All in ms."""
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
        calls.append({"search_batch": total, "prep": total - counts - results,
                      "counts_batch": counts, "results": results})
    return calls


def engine_inputs(port, seqs):
    """The (row ids, mask) that the facade hands the engine's
    counts_batch in one search_batch of `seqs`."""
    engine = port.engine
    seen = []

    def spy(row_idx, mask, num_cols):
        seen.append((row_idx, mask))
        return type(engine).counts_batch(engine, row_idx, mask, num_cols)

    engine.counts_batch = spy
    try:
        port.search_batch(seqs, 1.0)
    finally:
        del engine.counts_batch
    check(len(seen) == 1, "one counts_batch per search_batch, got %d" % len(seen))
    return seen[0]


def phase_times(gpu: str, runs, errors: Errors) -> dict:
    import torch

    from bigsi_tpu_torch.index.device_engine import tile_streams
    from bigsi_tpu_torch.ops import fused_lookup as fl
    from bigsi_tpu_torch.ops import lookup as plain

    kernel_ms = {}
    for layout, (port, seqs) in runs.items():
        engine = port.engine
        calls = search_batch_layers(port, seqs, 5)
        mid = sorted(calls, key=lambda c: c["search_batch"])[len(calls) // 2]
        idx, mask = engine_inputs(port, seqs)
        dev = engine.device
        if layout == "classic":
            name = "classic_counts"
            args = (engine.words, torch.from_numpy(idx.astype(np.int32)).to(dev),
                    torch.from_numpy(mask).to(dev))
            kernel, reference = fl.classic_counts, plain.batched_counts
        else:
            name = "tile_counts"
            tile, smask = tile_streams(torch.from_numpy(idx).to(dev),
                                       torch.from_numpy(mask).to(dev), TILE_ROWS)
            args = (engine.words, tile, smask, TILE_ROWS)
            kernel, reference = fl.tile_counts, plain.blocked_counts
        errors.compare(name, kernel(*args), reference(*args), "%s batch" % layout)
        k_ms = cuda_ms(lambda: kernel(*args), 20)
        p_ms = cuda_ms(lambda: reference(*args), 5)
        kernel_ms[name] = (k_ms, p_ms)
        print("phase 6 times %s [%s]: search_batch of %d queries, median of %d calls "
              "%.3f ms (%.1f queries/s); inside that call: k-mer extraction, hashing "
              "and padding on the host %.3f ms, engine counts_batch %.3f ms, result "
              "building %.3f ms; %s kernel %.4f ms vs plain PyTorch %.4f ms (B=%d, "
              "K=%d, h=%d, cold L2); kernel share of search_batch %.4f"
              % (layout, gpu, B, len(calls), mid["search_batch"],
                 B / mid["search_batch"] * 1e3, mid["prep"], mid["counts_batch"],
                 mid["results"], name, k_ms, p_ms, idx.shape[0], idx.shape[1], H,
                 k_ms / mid["search_batch"]),
              flush=True)
        print("phase 6 calls %s [%s]: %s" % (layout, gpu, json.dumps(calls)), flush=True)
    print("phase 6 memory [%s]: peak %.2f GB allocated on the device"
          % (gpu, torch.cuda.max_memory_allocated() / 1e9), flush=True)
    return kernel_ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    from bigsi_tpu_torch.ops import fused_lookup as fl  # the port, from this checkout

    gpu = phase_device()
    phase_build()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rng = np.random.default_rng(seed)
    errors = Errors()
    phase_kernels(gen, errors)

    # the main path: only its launches are counted
    fl.classic_counts.launches = fl.tile_counts.launches = 0
    runs = {"classic": phase_slice(4, "classic", gen, rng)}
    check(fl.classic_counts.launches > 0, "kernel A ran on the classic path")
    runs["minimizer"] = phase_slice(5, "minimizer", gen, rng)
    check(fl.tile_counts.launches > 0, "kernel B ran on the minimizer path")
    launches = {"classic_counts": fl.classic_counts.launches,
                "tile_counts": fl.tile_counts.launches}

    kernel_ms = phase_times(gpu, runs, errors)
    check("jax" not in sys.modules, "jax was never imported")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errors.max[name],
         "ms": kernel_ms[name][0], "plain_ms": kernel_ms[name][1]}
        for name in ("classic_counts", "tile_counts")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
