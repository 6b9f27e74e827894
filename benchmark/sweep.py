"""Find an open-loop cell's knee on the card: one index and one server,
the cell's traffic offered at each of the given rates in turn, one
window each; a JSON line a rate (offered and answered rate, latency
quantiles from due time, failures, how late the client sent).

    python benchmark/sweep.py --workload <name> --seed <n> --seconds <s> --rates <r> ...

The knee is the highest rate whose answered rate keeps up with the
offered one and whose latency does not grow through the window; the
cell's mix then fixes its rate at about 4/5 of it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from benchmark.harness import cell, spec as specs, traffic
    from benchmark.harness.index import synthesize

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 1
    spec = specs.load(args.workload, False)
    index = synthesize(spec.config, args.seed, args.device)
    server, thread, load_s = cell.open_server(index, args.device)
    print(json.dumps({"synth_s": index.synth_s, "load_s": load_s}), flush=True)
    try:
        for rate in args.rates:
            mix = dict(spec.traffic, rate_per_s=rate)
            sched = traffic.open_schedule(mix, index.sources, args.seed, args.seconds)
            win = cell.drive(server, sched, mix["thresholds"], [], False, args.device)
            ok = np.asarray(win.out["ok"])
            lat = np.asarray([np.inf if x is None else x for x in win.out["latency"]])
            half = len(lat) // 2
            q = lambda a, p: float(np.percentile(a, p, method="higher")) * 1e3  # noqa: E731
            late = cell.lateness(win)
            batches = win.counts.get("serve.batches", 0)
            print(json.dumps({
                "offered_per_s": rate, "requests": len(lat), "failed": int((~ok).sum()),
                "answered_per_s": int(ok.sum()) / (win.end - win.start),
                "p50_ms": q(lat, 50), "p95_ms": q(lat, 95), "p99_ms": q(lat, 99),
                "p95_first_half_ms": q(lat[:half], 95), "p95_second_half_ms": q(lat[half:], 95),
                "late_p99_ms": float(np.percentile(late, 99)) * 1e3 if late.size else None,
                "queries_per_dispatch": win.counts.get("search.queries", 0) / batches
                if batches else None,
            }), flush=True)
    finally:
        cell.close_server(server, thread)
    return 0


if __name__ == "__main__":
    sys.exit(main())
