"""One run of one cell: set-up, the measured window, the check of its
answers and the metrics, as the result line reports them.

Set-up runs from the process's start to the window's: the benchmark's
index synthesis, the program's load (``BIGSI(config, device)``, or the
HTTP server opening it), and a warm-up on the cell's own traffic.  A
closed loop (``"loop": "closed"``) calls ``BIGSI.search_batch`` from one
client, each call after the last returns, until ``seconds`` have passed.
An open loop (``"loop": "open_http"``) sends single ``GET /search``
requests to the program's ``BigsiHTTPServer`` from a child process, at
the mix's fixed rate.  The answers are checked against the plain
reference once the window is closed, the device's peak read and the
program's state freed.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from benchmark.harness import check, spec as specs, traffic
from benchmark.harness.index import synthesize
from benchmark.harness.trace import DeviceTimeline, SpanTimes, Timeline
from benchmark.reference.search import Reference

KEPT_CALLS = 4  # closed loop: calls whose answers are kept for the check


@dataclasses.dataclass
class Run:
    """What the metric readers (``metrics/<name>.py``) read."""
    loop: str
    setup_s: float
    window_s: float
    attempted: int
    answered: int
    latencies_s: list  # a closed loop's calls or an open loop's requests; None: failed
    calls: int  # search_batch calls in the window (closed loop)
    load_s: float
    synth_s: float
    memory_peak_bytes: int
    timers: dict  # the program's spans over the window: name -> total seconds
    counts: dict  # the program's spans and counters over the window: name -> count
    timeline: Timeline | None = None
    work_bytes: float | None = None
    calls_made: list = dataclasses.field(default_factory=list)  # (pool batch, threshold) a call
    pool: traffic.ClosedPool | None = None

    def per_call_ms(self, *names, less=()) -> float | None:
        """Summed time of the named spans, less the ``less`` spans, per
        call of the window, in ms; None when none of them ran."""
        if not self.calls or not any(self.counts.get(n) for n in names):
            return None
        total = sum(self.timers.get(n, 0.0) for n in names)
        total -= sum(self.timers.get(n, 0.0) for n in less)
        return 1e3 * total / self.calls


def delta(before: dict, after: dict) -> tuple[dict, dict]:
    timers = {k: v["total_s"] - before["timers"].get(k, {}).get("total_s", 0.0)
              for k, v in after["timers"].items()}
    counts = {k: v["count"] - before["timers"].get(k, {}).get("count", 0)
              for k, v in after["timers"].items()}
    for k, v in after["counters"].items():
        counts[k] = v - before["counters"].get(k, 0)
    return timers, counts


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def execute(spec: specs.Spec, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, log=print) -> dict:
    """One run; -> the result line's object."""
    cuda = torch.device(device).type == "cuda"
    index = synthesize(spec.config, seed, device)
    log("index: %d samples x %d rows drawn in %.3f s (%s)" % (
        len(index.names), index.words.shape[0], index.synth_s,
        ", ".join("%s %.3f" % kv for kv in index.phases.items())), file=sys.stderr)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    mix = spec.traffic
    if mix["loop"] == "closed":
        run, asked, got = closed_loop(spec, index, seed, seconds, trace, device, t_start)
    elif mix["loop"] == "open_http":
        run, asked, got = open_loop(spec, index, seed, seconds, trace, device, t_start, log)
    else:
        raise ValueError("unknown loop %r" % mix["loop"])
    reference = Reference(index.words, index.names, spec.config["index"], spec.config["reference"])
    numbers = check.compare(reference, asked, got, bool(mix.get("score")))
    numbers["missing_answers"] = max(numbers["missing_answers"], run.attempted - run.answered)
    log("checked %d sampled answers against the reference" % len(asked), file=sys.stderr)
    if trace and mix["loop"] == "closed":
        run.work_bytes = window_work(spec, index, run, reference)
    metrics = {}
    for entry in spec.metrics:
        value = specs.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": check.verdict(numbers), "attempted": run.attempted,
           "failed": run.attempted - run.answered, "metrics": metrics, "device": dev}
    if trace and run.timeline is not None:
        dev["busy_s"] = run.timeline.busy_s
        dev["window_s"] = run.timeline.window_s
        out["breakdown"] = {"device_ops": run.timeline.device_ops,
                            "idle_gaps": run.timeline.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}
    return out


def peak_bytes(device) -> int:
    cuda = torch.device(device).type == "cuda"
    return torch.cuda.max_memory_allocated(device) if cuda else 0


def drop(device) -> None:
    """Return the freed program state's device memory."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def closed_loop(spec, index, seed, seconds, trace, device, t_start):
    from bigsi_tpu_torch import BIGSI, metrics

    pool = traffic.closed_pool(spec.traffic, index.sources, seed)
    t = time.perf_counter()
    bigsi = BIGSI(index.port_config, device=device)
    sync(device)
    load_s = time.perf_counter() - t
    for i in range(min(2, len(pool.batches))):  # both thresholds, the cell's shapes
        _, batch, threshold = pool.call(i)
        bigsi.search_batch(batch, threshold, pool.score)
    sync(device)
    before = metrics.snapshot()
    spans = SpanTimes(metrics) if trace else None
    timeline = DeviceTimeline(device) if trace and torch.device(device).type == "cuda" else None
    if spans:
        spans.__enter__()
    rng = np.random.default_rng([seed, 4])
    kept, times, calls, bench = [], [], [], []
    t0 = timeline.open() if timeline else time.perf_counter()
    i = 0
    while True:
        j, batch, threshold = pool.call(i)
        a = time.perf_counter()
        res = bigsi.search_batch(batch, threshold, pool.score)
        z = time.perf_counter()
        times.append(z - a)
        calls.append((j, threshold))
        bench.append(("bench.search_batch", a, z))
        if len(kept) < KEPT_CALLS:  # a reservoir of the window's calls
            kept.append((j, threshold, res))
        else:
            r = int(rng.integers(i + 1))
            if r < KEPT_CALLS:
                kept[r] = (j, threshold, res)
        i += 1
        if z - t0 >= seconds:
            break
    tl = timeline.close(t0, z, spans.events + bench) if timeline else None
    if spans:
        spans.__exit__()
    timers, counts = delta(before, metrics.snapshot())
    peak = peak_bytes(device)
    del bigsi
    drop(device)
    n = sum(len(pool.batches[j]) for j, _ in calls)
    run = Run("closed", t0 - t_start, z - t0, n, n, times, len(calls), load_s, index.synth_s,
              peak, timers, counts, tl, calls_made=calls, pool=pool)
    asked, got = [], []
    per_call = spec.traffic.get("checked_answers", 128) // KEPT_CALLS
    for j, threshold, res in kept:
        batch = pool.batches[j]
        for q in check.pick(rng, list(range(len(batch))), [len(s) for s in batch], per_call):
            asked.append((batch[q], threshold))
            got.append(res[q])
    return run, asked, got


def window_work(spec, index, run, reference) -> float:
    """The bytes the window's work needs, by ``work/<work>.py``: summed over
    the window's calls, each pool batch worked out once."""
    work = specs.module("work", spec.config["work"])
    cfg = dict(spec.config["index"], samples=len(index.names))
    score = run.pool.score
    memo = {}
    total = 0.0
    for j, threshold in run.calls_made:
        key = (j, threshold if score else None)
        if key not in memo:
            memo[key] = work.batch_bytes(cfg, reference, run.pool.batches[j], threshold, score)
        total += memo[key]
    return total


def open_server(index, device):
    """The program's HTTP server on a free local port, its index opened
    through the program's entry; -> (server, its thread, load seconds)."""
    from bigsi_tpu_torch.http.server import make_server

    server = make_server(index.port_config, "127.0.0.1", 0, device)
    t = time.perf_counter()
    server.bigsi  # the server opens the index at its first use: here
    sync(device)
    load_s = time.perf_counter() - t
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, load_s


def close_server(server, thread) -> None:
    server.shutdown()
    thread.join(timeout=60)
    server.invalidate()
    server.server_close()


@dataclasses.dataclass
class Window:
    """An open loop's window as the client saw it (``http_client.py``'s
    output) with its start and end on the host's clock, and the program's
    spans and counters over it."""
    out: dict
    start: float
    end: float
    timers: dict
    counts: dict
    timeline: Timeline | None


def drive(server, sched: traffic.OpenSchedule, thresholds, keep, trace, device) -> Window:
    """Run the client over ``sched`` against ``server``: the warm-up, then
    the window."""
    from bigsi_tpu_torch import metrics

    warm_q = np.arange(len(sched.warmup)) % len(sched.queries)
    job = {"port": server.server_address[1], "queries": sched.queries,
           "requests": [[int(q), float(t)] for q, t in zip(sched.query, sched.thresholds)],
           "offsets": sched.offsets.tolist(),
           "warmup": [[int(q), float(thresholds[i % len(thresholds)])]
                      for i, q in enumerate(warm_q)],
           "warmup_offsets": sched.warmup.tolist(), "keep": list(keep)}
    clock = time.perf_counter() - time.monotonic()  # monotonic -> perf_counter
    client = subprocess.Popen([sys.executable, str(specs.HERE / "harness" / "http_client.py")],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                              cwd=str(specs.ROOT))
    spans = timeline = None
    try:
        client.stdin.write(json.dumps(job) + "\n")
        client.stdin.flush()
        if client.stdout.readline().strip() != "warm":
            raise RuntimeError("the HTTP client failed in its warm-up")
        sync(device)
        before = metrics.snapshot()
        if trace:
            spans = SpanTimes(metrics).__enter__()
            if torch.device(device).type == "cuda":
                timeline = DeviceTimeline(device)
        opened = timeline.open() if timeline else time.perf_counter()
        client.stdin.write("go\n")
        client.stdin.flush()
        out = json.loads(client.stdout.readline())
        client.wait(timeout=60)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
        if spans:
            spans.__exit__()
    start = out["start"] + clock
    ends = [start + o + lat for o, lat, good in zip(sched.offsets, out["latency"], out["ok"])
            if good]
    end = max(ends) if ends else start + float(sched.offsets[-1])
    tl = timeline.close(opened, end, spans.events) if timeline else None
    timers, counts = delta(before, metrics.snapshot())
    return Window(out, start, end, timers, counts, tl)


def lateness(window: Window) -> np.ndarray:
    return np.asarray([x for x in window.out["late"] if x is not None])


def open_loop(spec, index, seed, seconds, trace, device, t_start, log):
    mix = spec.traffic
    sched = traffic.open_schedule(mix, index.sources, seed, seconds)
    server, thread, load_s = open_server(index, device)
    rng = np.random.default_rng([seed, 5])
    n = len(sched.offsets)
    lengths = [len(sched.queries[q]) for q in sched.query]
    keep = check.pick(rng, list(range(n)), lengths, mix.get("checked_answers", 128))
    try:
        win = drive(server, sched, mix["thresholds"], keep, trace, device)
        peak = peak_bytes(device)
    finally:
        close_server(server, thread)
    del server
    drop(device)
    out, ok = win.out, win.out["ok"]
    late = lateness(win)
    if late.size:
        log("http client: %d requests, %d warm-up failed; sent late by p50 %.6f s, p99 %.6f s, "
            "max %.6f s" % (n, out["warmup_failed"], np.percentile(late, 50),
                            np.percentile(late, 99), late.max()), file=sys.stderr)
    lat = np.array([np.inf if x is None else x for x in out["latency"]])
    log("http latency from due time, ms: " + ", ".join(
        "p%d %.3f" % (q, 1e3 * np.percentile(lat, q, method="higher")) for q in (50, 90, 95, 99)),
        file=sys.stderr)
    answered = sum(1 for good in ok if good)
    run = Run("open_http", win.start - t_start, win.end - win.start, n, answered,
              [lat if good else None for lat, good in zip(out["latency"], ok)], 0, load_s,
              index.synth_s, peak, win.timers, win.counts, win.timeline)
    asked, got = [], []
    for i in keep:
        seq, threshold = sched.queries[sched.query[i]], float(sched.thresholds[i])
        asked.append((seq, threshold))
        body = out["bodies"].get(str(i)) if ok[i] else None
        if body is None:
            got.append(None)
            continue
        d = json.loads(body)
        same = d.get("query") == seq and d.get("threshold") == threshold
        got.append(d.get("results") if same else [{"query or threshold": "differs"}])
    return run, asked, got
