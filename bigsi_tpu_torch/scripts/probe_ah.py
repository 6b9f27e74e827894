"""Kernels A (``classic_counts``) and H (``seq_streams``) on the card, at
the shapes where their designs differ.

* Kernel A over the resident matrix of a full-size classic index (1,024
  samples, m = 2.5e7 bloom bits, h = 3, drawn on the device by
  :func:`bigsi_tpu_torch.synth.synth_index`): a batch (B = 256, K = 512,
  5 % padding) and single queries (B = 1, K = 512 and 20,000, every
  k-mer valid, as ``DeviceEngine._single`` passes them).  Each is checked
  bit for bit against its plain version and timed beside it.
* The classic index's single ``search`` of a 542 bp and a 20 kb query
  (a planted sample's prefix, and that sample whole), on the host clock,
  median of 5 calls, at thresholds 1.0 and 0.7.
* Kernel H at the seq arm's shapes: 256 queries of 542 bp padded to 576
  bytes at both cols configs (tile_rows 16, w = 19, r = 20; tile_rows
  32, w = 11, r = 6), and 8 queries of 4,096 bytes (tile_rows 16), each
  at the engine's safe entry budget.  The wrapper (kernel and its
  ``ok``) is timed beside the kernel alone (the library called with
  preallocated outputs) and beside builds of the kernel cut after each
  of its passes (``seq_streams_cut``), whose differences split its time;
  with the dedup work per query those inputs need: the pairwise scan's
  compares and the hash table's probes (one insert order).

Only the wrappers' public functions and the library's C symbols are
used, so the script also times another checkout's kernels: ``cd
<checkout> && PYTHONPATH=. python <this file>`` imports that checkout's
package (a library without ``seq_streams_cut`` gives no split).  Device
times are CUDA events with a cold L2, each line beside the card's name
and power limit; ``--device cpu`` runs the plain versions on the host
clock at a size set by ``--m`` and ``--samples``.

Usage:
  python -m bigsi_tpu_torch.scripts.probe_ah [--seed N] [--json PATH]
  python -m bigsi_tpu_torch.scripts.probe_ah --device cpu --m 200000 --samples 64 --reps 1
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from bigsi_tpu_torch.index.device_engine import DeviceEngine, resolve_device
from bigsi_tpu_torch.ops import fused_lookup as fl
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.ops import prep
from bigsi_tpu_torch.scripts.timing import device_label, print_time, same, time_ms

M, SAMPLES, H, K_LEN = 25_000_000, 1024, 3, 31
A_SHAPES = ((256, 512), (1, 512), (1, 20_000))
# (case, B, L, query length, tile_rows, window, r)
H_CASES = (
    ("minimizer/16 B=256 L=576", 256, 576, 542, 16, 19, 20),
    ("minimizer/32 B=256 L=576", 256, 576, 542, 32, 11, 6),
    ("minimizer/16 B=8 L=4096", 8, 4096, 4096, 16, 19, 20),
)
H_PASSES = ("bytes and zero fill", "s-mer hashes", "codes, masks, minima", "dedup",
            "runs, entries, scatter")
SEARCH_LENGTHS = (542, 20_000)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + what)


# -- kernel A -------------------------------------------------------------


def a_times(words, gen, label: str, reps: int = 20) -> dict:
    """Kernel A at A_SHAPES over ``words``; -> {(B, K): {"ms", "plain_ms",
    "args"}}, args the kernel's (words, row ids, mask)."""
    dev = words.device
    out = {}
    for b, k in A_SHAPES:
        idx = torch.randint(0, words.shape[0], (b, k, H), generator=gen, device=dev,
                            dtype=torch.int32)
        if b == 1:
            mask = torch.ones((b, k), dtype=torch.bool, device=dev)
        else:
            mask = torch.rand((b, k), generator=gen, device=dev) >= 0.05
        args = (words, idx, mask)
        check(same(fl.classic_counts(*args), plain.batched_counts(*args)),
              "classic_counts B=%d K=%d equals its plain version" % (b, k))
        ms = time_ms(lambda: fl.classic_counts(*args), reps, dev)
        plain_ms = time_ms(lambda: plain.batched_counts(*args), max(1, reps // 10), dev)
        rows = int(mask.sum()) * H * words.shape[1] * 4
        print_time("classic_counts B=%d K=%d" % (b, k), ms, label,
                   "plain PyTorch %10.4f ms, %.1f GB/s of rows, bit-exact"
                   % (plain_ms, rows / ms / 1e6))
        out[b, k] = {"ms": ms, "plain_ms": plain_ms, "args": args}
    return out


# -- single search on the classic index -------------------------------------


def search_times(port, queries, label: str, reps: int = 5) -> dict:
    """Host-clock medians of ``reps`` single searches of each query at
    thresholds 1.0 and 0.7; -> {(length, threshold): ms}."""
    out = {}
    for q in queries:
        for t in (1.0, 0.7):
            port.search(q, t)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                port.search(q, t)
                times.append((time.perf_counter() - t0) * 1e3)
            out[len(q), t] = sorted(times)[reps // 2]
            print("single search of %d bp at %.1f: median %.3f ms of %d (host clock) %s [%s]"
                  % (len(q), t, out[len(q), t], reps, json.dumps(times), label), flush=True)
    return out


# -- kernel H -------------------------------------------------------------


def h_inputs(rng, b: int, l: int, length: int, tile_rows: int, window: int, r: int, m: int,
             device):
    """Random ACGT queries of ``length`` bytes padded with A to ``l`` (as
    the engine pads) and the prep arguments at the engine's safe budget;
    -> (seqs uint8[B, L], lens int32[B], kw)."""
    seqs = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=(b, l))]
    seqs[:, length:] = ord("A")
    lens = np.full(b, length, dtype=np.int32)
    kw = dict(k=K_LEN, s=K_LEN - window + 1, num_tiles=max(1, m // tile_rows), h=H,
              tile_rows=tile_rows, r=r, u_cap=DeviceEngine._seq_u_cap(l - K_LEN + 1, window))
    return torch.from_numpy(seqs).to(device), torch.from_numpy(lens).to(device), kw


def forward_codes(seqs: np.ndarray, lens: np.ndarray, k: int):
    """Per query, the forward 2-bit codes (uint64) of its valid k-mers."""
    table = np.zeros(256, dtype=np.uint64)
    for c, v in zip(b"CGT", (1, 2, 3)):
        table[c] = v
    out = []
    for row, n in zip(seqs, lens):
        nv = max(0, int(n) - k + 1)
        codes = np.zeros(nv, dtype=np.uint64)
        vals = table[row]
        for j in range(k):
            codes = (codes << np.uint64(2)) | vals[j : j + nv]
        out.append(codes)
    return out


def dedup_work(seqs: np.ndarray, lens: np.ndarray, k: int) -> dict:
    """Mean work per query of the two dedups on these inputs: the
    pairwise scan's compares (position i scans 0..i-1 until it meets its
    code) and the table's probes (:func:`prep.table_dedup`, inserts in
    position order; absent from a checkout without it)."""
    table_dedup = getattr(prep, "table_dedup", None)
    compares = probes = 0
    for codes in forward_codes(seqs, lens, k):
        first = {}
        for i, c in enumerate(codes.tolist()):
            f = first.setdefault(c, i)
            compares += i if f == i else f + 1
        if table_dedup is not None:
            probes += table_dedup(codes.tolist(), nk=seqs.shape[1] - k + 1)[1]
    out = {"pairwise compares": compares / len(lens)}
    if table_dedup is not None:
        out["table probes"] = probes / len(lens)
    return out


def seq_library():
    """The kernels' library, with ``seq_streams_cut`` bound where it has
    one; -> (library, has_cut)."""
    lib = fl._library()
    try:
        cut = lib.seq_streams_cut
    except AttributeError:
        return lib, False
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    cut.argtypes = [ptr, i32, i32, ptr, i32, i32, ctypes.c_uint64, i64, i32, i32, i32, i32,
                    ptr, ptr, ptr, ptr, i32, ptr]
    cut.restype = i32
    return lib, True


def kernel_alone(lib, seqs, lens, kw, passes=None):
    """One launch of kernel H straight from the library (cut after
    ``passes`` passes when given), outputs preallocated; -> (utile, gmask,
    n_valid)."""
    b, l = seqs.shape
    u = kw["u_cap"]
    utile = torch.empty((b, u), dtype=torch.int32, device=seqs.device)
    gmask = torch.empty((b, u, kw["r"]), dtype=torch.int64, device=seqs.device)
    n_valid = torch.empty(b, dtype=torch.int32, device=seqs.device)
    flag = torch.empty(b, dtype=torch.int32, device=seqs.device)  # u_count, or the ok byte
    args = [seqs.data_ptr(), b, l, lens.data_ptr(), kw["k"], kw["s"],
            prep.MINIMIZER_SEED & (2**64 - 1), kw["num_tiles"], kw["h"], kw["tile_rows"], kw["r"],
            u, utile.data_ptr(), gmask.data_ptr(), n_valid.data_ptr(), flag.data_ptr()]
    if passes is not None:
        args.append(passes)
    args.append(torch.cuda.current_stream(seqs.device).cuda_stream)
    fn = lib.seq_streams if passes is None else lib.seq_streams_cut
    err = fn(*args)
    check(err == 0, "seq_streams launch: %s" % lib.lookup_error_string(err).decode())
    return utile, gmask, n_valid


def h_times(rng, m: int, label: str, device, reps: int = 20) -> dict:
    """Kernel H at H_CASES; -> {case: {"ms" (wrapper), "plain_ms",
    "kernel_ms", "passes_ms" (cumulative, or None), "work", "args"}}."""
    on_card = torch.device(device).type == "cuda"
    lib, has_cut = seq_library() if on_card else (None, False)
    out = {}
    for case, b, l, length, tile_rows, window, r in H_CASES:
        seqs, lens, kw = h_inputs(rng, b, l, length, tile_rows, window, r, m, device)
        got = fl.seq_streams(seqs, lens, **kw)
        want = prep.prep_streams(seqs, lens, **kw)
        check(same(got, want), "seq_streams %s equals prep_streams" % case)
        ms = time_ms(lambda: fl.seq_streams(seqs, lens, **kw), reps, device)
        plain_ms = time_ms(lambda: prep.prep_streams(seqs, lens, **kw), max(1, reps // 10), device)
        row = {"ms": ms, "plain_ms": plain_ms, "kernel_ms": None, "passes_ms": None,
               "args": (seqs, lens, kw, got[:3])}
        extra = ""
        if on_card:
            check(same(kernel_alone(lib, seqs, lens, kw), got[:3]),
                  "seq_streams %s: the library call gives the wrapper's streams" % case)
            row["kernel_ms"] = time_ms(lambda: kernel_alone(lib, seqs, lens, kw), reps, device)
            extra = "kernel alone %.4f ms, ok ops %.4f ms; " % (row["kernel_ms"],
                                                                 ms - row["kernel_ms"])
            if has_cut:
                row["passes_ms"] = [
                    time_ms(lambda p=p: kernel_alone(lib, seqs, lens, kw, p), reps, device)
                    for p in range(1, len(H_PASSES) + 1)]
                split = np.diff([0.0] + row["passes_ms"])
                extra += "passes: %s; " % ", ".join(
                    "%s %.4f" % (name, t) for name, t in zip(H_PASSES, split))
        row["work"] = dedup_work(seqs.cpu().numpy(), lens.cpu().numpy(), K_LEN)
        print_time("seq_streams %s U=%d" % (case, kw["u_cap"]), ms, label,
                   "wrapper; %splain PyTorch %.4f ms; dedup work per query %s; bit-exact"
                   % (extra, plain_ms, json.dumps(row["work"])))
        out[case] = row
    return out


def classic_index(m: int, samples: int, gen, device):
    """A classic in-memory index of ``samples`` samples at m bits drawn on
    ``gen``'s device, a 20 kb planted sample in column 0; -> (port on
    ``device``, the planted sequence)."""
    from bigsi_tpu_torch import BIGSI
    from bigsi_tpu_torch.synth import bloom_density, synth_index

    rng = np.random.default_rng(0)
    planted = "".join(np.array(list("ACGT"))[rng.integers(0, 4, max(SEARCH_LENGTHS))])
    config = {"storage-engine": "memory", "storage-config": {"filename": "probe-ah-classic"},
              "k": K_LEN, "m": m, "h": H, "layout": "classic"}
    names = ["planted"] + ["synth%d" % i for i in range(1, samples)]
    synth_index(config, names, [planted], bloom_density(H, 4_000_000 * m // M, m), gen)
    return BIGSI(config, device=device), planted


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter,
                                 epilog="\n".join(__doc__.splitlines()[1:]))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m", type=int, default=M, help="bloom bits of the classic index")
    ap.add_argument("--samples", type=int, default=SAMPLES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the times to this file")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = device_label(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    h = h_times(rng, args.m, label, dev, args.reps)
    t0 = time.perf_counter()
    port, planted = classic_index(args.m, args.samples, gen, dev)
    print("classic index of %d samples at m=%d made in %.1f s"
          % (args.samples, args.m, time.perf_counter() - t0), flush=True)
    a = a_times(port.engine.words, gen, label, args.reps)
    searched = search_times(port, [planted[:n] for n in SEARCH_LENGTHS], label)
    out = {"label": label,
           "classic_counts": {"B=%d K=%d" % key: {k: v for k, v in row.items() if k != "args"}
                              for key, row in a.items()},
           "search": {"%d bp at %.1f" % key: ms for key, ms in searched.items()},
           "seq_streams": {case: {k: v for k, v in row.items() if k != "args"}
                           for case, row in h.items()}}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
