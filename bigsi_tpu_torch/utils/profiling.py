"""First-class tracing, phase timing, and metrics.

The reference has no tracing or metrics at all — only ``logger.debug``
phase markers during build (``bigsi/graph/bigsi.py:161-163``,
``bigsi/graph/index.py:34-36``).  This module is the rebuild's
observability story (SURVEY §5.1/§5.5):

* :func:`phase` — a context manager that times a named phase, logs it,
  and accumulates into the process-wide :class:`Metrics` registry;
* :class:`Metrics` — counters + timers, snapshot as a plain dict
  (exposed over HTTP at ``/metrics`` by bigsi_tpu_torch.http.server);
* :class:`SpanLog` (``spans``) — while on, each ``phase`` also leaves a
  :class:`Span` record: its id, its parent's, its call's (the root
  span's id), start and end on ``time.perf_counter_ns`` and the thread,
  in a ring of ``SPAN_LOG_CAPACITY`` records.  On while a trace dir is
  configured, or between ``spans.start()`` and ``spans.stop()``;
* :func:`device_trace` — wraps ``torch.profiler.profile`` when a trace
  dir is configured (``config["trace_dir"]`` or ``BIGSI_TPU_TRACE_DIR``),
  a no-op otherwise, so hot paths can be annotated unconditionally.  The
  Chrome trace it writes holds the span log's records of its window on a
  track of their own, on the profiler's clock.

Importing this module pulls in only the standard library;
``device_trace`` imports torch's profiler lazily, only when tracing is
on.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import logging
import os
import threading
import time
from typing import NamedTuple

logger = logging.getLogger("bigsi_tpu_torch.profiling")


class Metrics:
    """Thread-safe counters and phase timers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._timers: dict[str, dict] = {}

    def incr(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timers.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            t["count"] += 1
            t["total_s"] += seconds
            t["max_s"] = max(t["max_s"], seconds)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "timers": {k: dict(v) for k, v in self._timers.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()


#: process-wide registry (the HTTP server serves this at /metrics)
metrics = Metrics()

SPAN_LOG_CAPACITY = 1 << 20  # records the span log keeps; older ones drop
SPAN_TRACK_PID = 0x5350414E  # the spans' process id in a Chrome trace


class Span(NamedTuple):
    """One span: ids are positive; ``parent`` is None for a root, and
    ``call`` is the root's id.  Times are ``time.perf_counter_ns``."""
    name: str
    id: int
    parent: int | None
    call: int
    start_ns: int
    end_ns: int
    thread: int  # threading.get_ident() of the thread that ran it (no system call)


# the span log records only while this is set (SpanLog.start / stop)
_SPANS_ON = False
# the innermost open span of this context: (span id, call id)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("bigsi_span", default=None)


class SpanLog:
    """A bounded ring of :class:`Span` records.  Records past the
    capacity push the oldest out, each counted under the process
    registry's ``trace.spans_dropped``."""

    def __init__(self, capacity: int = SPAN_LOG_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        #: (perf_counter_ns, time_ns) read back to back when the log turned on
        self.anchor: tuple[int, int] | None = None

    def start(self) -> None:
        """Turn the log on, reading the clocks' anchor; the records held
        are kept.  A no-op while on."""
        global _SPANS_ON
        if not _SPANS_ON:
            self.anchor = (time.perf_counter_ns(), time.time_ns())
            _SPANS_ON = True

    def stop(self) -> None:
        global _SPANS_ON
        _SPANS_ON = False

    @property
    def on(self) -> bool:
        return _SPANS_ON

    def next_id(self) -> int:
        return next(self._ids)

    def add(self, span: tuple) -> None:
        """One record, a plain tuple of :class:`Span`'s fields (the
        cheapest to build on the hot path)."""
        with self._lock:
            full = len(self._ring) == self.capacity
            self._ring.append(span)
        if full:
            metrics.incr("trace.spans_dropped")

    def records(self) -> list:
        """The records held, oldest first, as :class:`Span`."""
        with self._lock:
            held = list(self._ring)
        return [Span._make(r) for r in held]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def chrome_events(self, t0_ns: int, t1_ns: int, base_ns: int = 0) -> list:
        """The records that overlap [t0_ns, t1_ns] (perf_counter_ns) as
        Chrome trace complete events in µs after ``base_ns`` on the Unix
        epoch's clock (``torch.profiler``'s), through the anchor, on a
        process track of their own, one thread a row (its native id, as
        the profiler's rows, while the thread lives)."""
        pc, wall = self.anchor
        native = {t.ident: t.native_id for t in threading.enumerate()}
        events = [{"ph": "M", "name": "process_name", "pid": SPAN_TRACK_PID, "tid": 0,
                   "args": {"name": "bigsi_tpu_torch spans"}}]
        for s in self.records():
            if s.end_ns < t0_ns or s.start_ns > t1_ns:
                continue
            events.append({
                "ph": "X", "cat": "program_span", "name": s.name,
                "pid": SPAN_TRACK_PID, "tid": native.get(s.thread, s.thread),
                "ts": (wall + s.start_ns - pc - base_ns) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"span": s.id, "parent": s.parent, "call": s.call},
            })
        return events


#: the process-wide span log; on from import when BIGSI_TPU_TRACE_DIR is set
spans = SpanLog()


def current_span() -> tuple[int, int] | None:
    """(span id, call id) of the innermost open span here, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def phase(name: str, registry: Metrics | None = None, log_level=logging.DEBUG):
    """Time a named phase: logs the duration and records it in the
    registry, and while the span log is on in ``spans`` too, as a child
    of the innermost open span.  Usage::

        with phase("build.transpose"):
            words = transpose_blooms(...)
    """
    reg = registry if registry is not None else metrics
    if not _SPANS_ON:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            reg.observe(name, dt)
            logger.log(log_level, "%s: %.3f s", name, dt)
        return
    parent = _CURRENT.get()
    sid = spans.next_id()
    call = parent[1] if parent else sid
    token = _CURRENT.set((sid, call))
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        _CURRENT.reset(token)
        dt = (t1 - t0) * 1e-9
        reg.observe(name, dt)
        spans.add((name, sid, parent[0] if parent else None, call, t0, t1,
                   threading.get_ident()))
        logger.log(log_level, "%s: %.3f s", name, dt)


def record_span(name: str, start_ns: int, end_ns: int, parent: tuple[int, int] | None,
                thread: int, registry: Metrics | None = None) -> None:
    """A span timed outside a ``phase`` (``perf_counter_ns`` times, maybe
    on two threads): observed in the registry like a phase, and while the
    log is on recorded as a child of ``parent`` (``current_span()`` of
    the span it ran under), on the row of ``thread`` (a
    ``threading.get_ident()``)."""
    (registry if registry is not None else metrics).observe(name, (end_ns - start_ns) * 1e-9)
    if _SPANS_ON:
        sid = spans.next_id()
        spans.add((name, sid, parent[0] if parent else None,
                   parent[1] if parent else sid, start_ns, end_ns, thread))


def trace_dir(config: dict | None = None) -> str | None:
    """Trace destination: config["trace_dir"] > BIGSI_TPU_TRACE_DIR > off."""
    if config and config.get("trace_dir"):
        return str(config["trace_dir"])
    return os.environ.get("BIGSI_TPU_TRACE_DIR") or None


@contextlib.contextmanager
def device_trace(name: str, config: dict | None = None):
    """``torch.profiler`` wrapper gated on a configured trace dir.

    Writes a Chrome trace (``<trace dir>/<name>.json``, loadable in
    Perfetto or TensorBoard) of everything inside the block: host ops
    and, where CUDA is available, copies and kernel timings, and the span
    log's records of the block (the log turns on here if it was off).
    No-op (zero overhead beyond one dict lookup) when tracing is off.
    """
    d = trace_dir(config)
    if not d:
        with phase(name):
            yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(d, exist_ok=True)
    spans.start()
    t0 = time.perf_counter_ns()
    with phase(name):
        with profile(activities=activities) as prof:
            yield
    t1 = time.perf_counter_ns()
    path = os.path.join(d, name + ".json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    # ts is µs after baseTimeNanoseconds (Unix ns); older exports have
    # no base and stamp µs since the epoch
    trace["traceEvents"].extend(
        spans.chrome_events(t0, t1, int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)


if trace_dir():
    spans.start()

__all__ = ["Metrics", "metrics", "phase", "device_trace", "trace_dir", "spans", "SpanLog",
           "Span", "current_span", "record_span"]
