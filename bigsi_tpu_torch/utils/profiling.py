"""First-class tracing, phase timing, and metrics.

The reference has no tracing or metrics at all — only ``logger.debug``
phase markers during build (``bigsi/graph/bigsi.py:161-163``,
``bigsi/graph/index.py:34-36``).  This module is the rebuild's
observability story (SURVEY §5.1/§5.5):

* :func:`phase` — a context manager that times a named phase, logs it,
  and accumulates into the process-wide :class:`Metrics` registry;
* :class:`Metrics` — counters + timers, snapshot as a plain dict
  (exposed over HTTP at ``/metrics`` by bigsi_tpu_torch.http.server);
* :func:`device_trace` — wraps ``torch.profiler.profile`` when a trace
  dir is configured (``config["trace_dir"]`` or ``BIGSI_TPU_TRACE_DIR``),
  a no-op otherwise, so hot paths can be annotated unconditionally.

Importing this module pulls in only the standard library;
``device_trace`` imports torch's profiler lazily, only when tracing is
on.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

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


@contextlib.contextmanager
def phase(name: str, registry: Metrics | None = None, log_level=logging.DEBUG):
    """Time a named phase: logs the duration and records it in the
    registry.  Usage::

        with phase("build.transpose"):
            words = transpose_blooms(...)
    """
    reg = registry if registry is not None else metrics
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        reg.observe(name, dt)
        logger.log(log_level, "%s: %.3f s", name, dt)


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
    and, where CUDA is available, copies and kernel timings.  No-op
    (zero overhead beyond one dict lookup) when tracing is off.
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
    with phase(name):
        with profile(activities=activities) as prof:
            yield
    prof.export_chrome_trace(os.path.join(d, name + ".json"))


__all__ = ["Metrics", "metrics", "phase", "device_trace", "trace_dir"]
