"""The span log against the device trace, on the card: one
``device_trace`` of seq-arm calls, and every kernel H and E in it inside
its call's ``engine.seq_kernels`` span.

A minimizer/16 memory index (w = 19, slot scheme 3, m = --m, --samples
samples of random bits at density 49/128) is drawn on the device
(``synth.synth_index``).  Batches of 256 random ACGT queries of 300-1,000
bp go through ``BIGSI.search_batch`` (the seq arm: kernels H and E)
inside ``device_trace("probe.spans", {"trace_dir": --out})``, which
writes the profiler's Chrome trace with the span log's records on a track
of their own.  Each ``seq_streams_kernel`` (H) and ``cols_counts_kernel``
(E) event is matched with the last ``engine.seq_kernels`` span that
starts before it; it has to lie inside that span within SLACK_MS.  The
span ends with the blocking read of H's ``ok``, which waits for E too.
Prints one JSON line (and writes it to ``<out>/probe_spans.json``): the
kernels and spans matched, the largest overhang of a kernel past its
span, the median time from the span's start to H's start and from E's
end to the span's end, the card.  Exits 1 when a kernel lies outside its
span or the trace has no kernel of the seq arm on a card.

Usage:
  python -m bigsi_tpu_torch.scripts.probe_spans [--out build/spans] [--calls 24]
  python -m bigsi_tpu_torch.scripts.probe_spans --device cpu --m 200000 --samples 64
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys

import numpy as np
import torch

from bigsi_tpu_torch import BIGSI
from bigsi_tpu_torch.index.device_engine import resolve_device
from bigsi_tpu_torch.scripts.timing import device_label
from bigsi_tpu_torch.synth import synth_index
from bigsi_tpu_torch.utils.profiling import device_trace

KERNELS = {"seq_streams_kernel": "H", "cols_counts_kernel": "E"}
SLACK_MS = 0.05  # how far a kernel may seem to lie outside its span
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--m", type=int, default=25_000_000)
    p.add_argument("--samples", type=int, default=1024)
    p.add_argument("--calls", type=int, default=24)
    p.add_argument("--out", default="build/spans")
    return p.parse_args(argv)


def batches(rng, n: int) -> list:
    """n batches of 256 random ACGT queries of 300-1,000 bp."""
    return [[BASES[rng.integers(0, 4, int(length))].tobytes().decode()
             for length in rng.integers(300, 1001, 256)] for _ in range(n)]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def match(trace: dict, slack_us: float) -> dict:
    """Each H and E kernel of the trace against the last
    ``engine.seq_kernels`` span that starts before it (µs, one clock)."""
    events = trace["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "program_span" and e["name"] == "engine.seq_kernels")
    starts = [s for s, _ in spans]
    found = {"H": 0, "E": 0}
    overhang, lead, outside = 0.0, [], 0
    last_e = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") == "program_span":
            continue
        kind = next((v for k, v in KERNELS.items() if k in e["name"]), None)
        if kind is None:
            continue
        found[kind] += 1
        a, b = e["ts"], e["ts"] + e["dur"]
        i = bisect.bisect_right(starts, a + slack_us) - 1
        if i < 0:
            outside += 1
            continue
        s, t = spans[i]
        over = max(s - a, b - t, 0.0)
        overhang = max(overhang, over)
        outside += over > slack_us
        if kind == "H":
            lead.append(a - s)
        else:
            last_e[i] = max(last_e.get(i, b), b)
    tail = [spans[i][1] - b for i, b in last_e.items()]
    return {"spans": len(spans), "kernels": found, "outside": outside,
            "max_overhang_ms": overhang / 1e3,
            "median_span_start_to_h_ms": statistics.median(lead) / 1e3 if lead else None,
            "median_e_end_to_span_end_ms": statistics.median(tail) / 1e3 if tail else None}


def main(argv=None) -> int:
    args = parse(argv)
    device = resolve_device(args.device)
    config = {"storage-engine": "memory", "storage-config": {"filename": "probe-spans"},
              "k": 31, "m": args.m, "h": 3, "layout": "minimizer", "tile-rows": 16,
              "minimizer-window": 19}
    gen = torch.Generator(device=device).manual_seed(0)
    synth_index(config, ["s%d" % i for i in range(args.samples)], [], 49 / 128, gen)
    bigsi = BIGSI(config, device=device)
    work = batches(np.random.default_rng(0), 4)
    for b in work:  # warm-up: every shape of the window
        bigsi.search_batch(b, 0.7)
    sync(device)
    os.makedirs(args.out, exist_ok=True)
    with device_trace("probe.spans", {"trace_dir": args.out}):
        for i in range(args.calls):
            bigsi.search_batch(work[i % len(work)], 0.7)
        sync(device)
    with open(os.path.join(args.out, "probe.spans.json")) as f:
        trace = json.load(f)
    out = dict(match(trace, 1e3 * SLACK_MS), calls=args.calls, slack_ms=SLACK_MS,
               device=device_label(device))
    print(json.dumps(out))
    with open(os.path.join(args.out, "probe_spans.json"), "w") as f:
        json.dump(out, f)
    if device.type == "cuda" and (not out["kernels"]["H"] or not out["kernels"]["E"]):
        return 1
    return 1 if out["outside"] else 0


if __name__ == "__main__":
    sys.exit(main())
