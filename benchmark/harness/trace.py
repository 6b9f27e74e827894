"""What a traced run reads besides the program's counters: the program's
spans with their times, and the device's timeline from ``torch.profiler``.

The program's ``phase`` spans record only durations into its registry.
:class:`SpanTimes` wraps the registry's ``observe`` while the window is
open and keeps each span's end (the moment it is observed) and start
(end less its duration) on the host's clock.  The benchmark adds spans
of its own around its calls into the program.

:class:`DeviceTimeline` runs the profiler with CUDA activity only over
the window.  A marker kernel launched after a synchronize, at a known
host time, ties the trace's clock to the host's, so each idle gap on the
device can be labelled with the innermost span the host was in.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from collections import defaultdict

import torch

NOT_KERNELS = ("Memcpy", "Memset")  # device activity that is a copy or a fill


class SpanTimes:
    """``with SpanTimes(registry) as spans``: spans.events is a list of
    (name, start_s, end_s) on ``time.perf_counter``'s clock."""

    def __init__(self, registry):
        self.registry, self.events, self._lock = registry, [], threading.Lock()

    def __enter__(self):
        real = self.registry.observe

        def observe(name, seconds, _real=real):
            end = time.perf_counter()
            with self._lock:
                self.events.append((name, end - seconds, end))
            _real(name, seconds)

        self.registry.observe = observe
        return self

    def __exit__(self, *exc):
        del self.registry.observe


@dataclasses.dataclass
class Timeline:
    busy_s: float  # union of device activity inside the window
    kernel_s: float  # summed kernel time inside the window
    window_s: float
    device_ops: list  # [[name, seconds], ...] most time first
    idle_gaps: list  # [[host label, seconds], ...] most idle time first


class DeviceTimeline:
    """Profile the device between :meth:`open` and :meth:`close`."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def open(self) -> float:
        """Start the profiler and the window; -> the window's start on the
        host's clock."""
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self.marker_host = time.perf_counter()
        torch.cuda._sleep(1000)  # the marker: the trace's first device activity
        torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def close(self, start: float, end: float, spans: list) -> Timeline | None:
        """Stop the profiler and reduce the window [start, end] (host
        clock); None when the trace holds no device activity."""
        torch.cuda.synchronize(self.device)
        self.prof.stop()
        acts = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            acts.append((e.start_ns() * 1e-9, e.duration_ns() * 1e-9, e.name()))
        self.prof = None
        if len(acts) < 2:
            return None
        acts.sort()
        offset = acts[0][0] - self.marker_host  # trace time = host time + offset
        lo, hi = start + offset, end + offset
        busy = kernel = 0.0
        by_name = defaultdict(float)
        gaps = []
        edge = lo
        for t, dur, name in acts[1:]:
            a, b = max(t, lo), min(t + dur, hi)
            if b <= a:
                continue
            by_name[name] += b - a
            if not name.startswith(NOT_KERNELS):
                kernel += b - a
            if a > edge:
                gaps.append((edge, a))
            if b > edge:
                busy += b - max(a, edge)
                edge = b
        if hi > edge:
            gaps.append((edge, hi))
        idle = label_gaps(gaps, [(n, s + offset, e + offset) for n, s, e in spans])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return Timeline(busy, kernel, end - start, [[n[:200], s] for n, s in top], idle)


LABEL_STEP_S = 0.001  # resolution at which idle time is labelled


def label_gaps(gaps: list, spans: list) -> list:
    """Idle time by what the host was doing: each gap is cut into steps of
    about LABEL_STEP_S, each step labelled with the innermost span that
    covers its middle ('no span' where none does); the labels with the
    most idle time first, at most 10."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    total = defaultdict(float)
    for a, b in gaps:
        n = max(1, round((b - a) / LABEL_STEP_S))
        step = (b - a) / n
        for k in range(n):
            mid = a + (k + 0.5) * step
            i = bisect.bisect_right(starts, mid)
            best = None
            for name, s, e in spans[max(0, i - 64):i]:
                if mid <= e and (best is None or e - s < best[1]):
                    best = (name, e - s)
            total[best[0] if best else "no span"] += step
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:10]]
