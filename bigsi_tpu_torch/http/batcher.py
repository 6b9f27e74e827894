"""Serving micro-batcher: coalesce concurrent searches into one dispatch.

The reference scales query serving with a multiprocessing pool per bulk
request (``bigsi/__main__.py:276-283``) and one-off searches hit the
index individually.  On an accelerator the economics invert: one batched program
execution answers hundreds of queries for the price of one dispatch, so
the HTTP layer funnels concurrent ``/search`` requests through this
batcher: a lone request dispatches immediately (no linger floor);
burst co-arrivals coalesce — naturally while a dispatch is in flight,
plus a linger capped at ``max_wait_ms`` once a burst is detected — and
run as a single :meth:`BIGSI.search_batch` call (up to ``max_batch``).

Requests are grouped by ``(threshold, score)`` since those change the
result semantics, not the device program.  ``score=True`` queries pass
straight through (scoring needs per-kmer presence, a per-query path).

Each dispatch is a span, ``serve.dispatch``; each request's wait, from
its enqueue to the start of the dispatch that serves it, is the timer
``serve.queue_wait``, in the span log a child of that dispatch.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

from bigsi_tpu_torch.utils.profiling import current_span, metrics, phase, record_span

logger = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("seq", "threshold", "event", "result", "error", "queued_ns", "thread")

    def __init__(self, seq, threshold):
        self.seq = seq
        self.threshold = threshold
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.queued_ns = time.perf_counter_ns()
        self.thread = threading.get_ident()


class QueryBatcher:
    def __init__(self, bigsi, max_batch: int = 256, max_wait_ms: float = 3.0):
        self.bigsi = bigsi
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def search(self, seq: str, threshold: float = 1.0, score: bool = False):
        """Blocking search; batched with concurrent callers."""
        if score or self._closed:
            return self.bigsi.search(seq, threshold, score)
        p = _Pending(seq, threshold)
        self._queue.put(p)
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def close(self):
        """Stop the worker.  Every already-queued request is still
        answered: the worker drains the queue on shutdown, and any
        straggler that raced past the ``_closed`` check is drained here
        after the worker exits (callers block on their event, so none
        may be abandoned)."""
        self._closed = True
        self._queue.put(None)  # wake the worker
        self._thread.join(timeout=30)
        self._run(self._drain())

    def _drain(self):
        batch = []
        while True:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                return batch
            if nxt is not None:
                batch.append(nxt)

    # -- worker ---------------------------------------------------------

    def _worker(self):
        while True:
            p = self._queue.get()
            if p is None:
                if self._closed:
                    self._run(self._drain())
                    return
                continue
            batch = [p] + self._drain()
            # A SOLO query dispatches immediately — no linger floor
            # (bursts still coalesce naturally: arrivals during _run
            # accumulate in the queue and drain as the next batch).
            # Only when co-arrivals are already present do we linger for
            # the rest of the burst, capped at max_wait from pickup.
            if len(batch) > 1:
                deadline = time.monotonic() + self.max_wait_s
                while len(batch) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is None:
                        # shutdown sentinel: answer what we have; the
                        # outer loop sees _closed on its next get
                        self._queue.put(None)
                        break
                    batch.append(nxt)
            self._run(batch)

    def _run(self, batch):
        if not batch:
            return
        # group by threshold (score=True never enters the queue);
        # oversize groups dispatch in max_batch slices
        by_t: dict = {}
        for p in batch:
            by_t.setdefault(p.threshold, []).append(p)
        for threshold, whole in by_t.items():
            for i in range(0, len(whole), self.max_batch):
                group = whole[i : i + self.max_batch]
                try:
                    with phase("serve.dispatch"):
                        started, dispatch = time.perf_counter_ns(), current_span()
                        for p in group:
                            record_span("serve.queue_wait", p.queued_ns, started, dispatch,
                                        p.thread)
                        results = self.bigsi.search_batch(
                            [p.seq for p in group], threshold
                        )
                    for p, r in zip(group, results):
                        p.result = r
                except Exception as e:  # noqa: BLE001 — delivered to callers
                    logger.exception("batched search failed")
                    for p in group:
                        p.error = e
                finally:
                    for p in group:
                        p.event.set()
        if len(batch) > 1:
            metrics.incr("serve.coalesced_queries", len(batch))
        metrics.incr("serve.batches")
