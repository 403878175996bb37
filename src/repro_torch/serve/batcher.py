"""Microbatching front-end: ragged request stream -> fixed-shape batches.

Port of ``repro.serve.batcher`` (same config, errors, metric names and
``serve.batch`` span).  Serving traffic arrives one variable-length
document at a time, but the projector is held to one shape forever (in
the reference a new (B, n) is an XLA recompile mid-traffic; here
`TopicProjector.trace_count` counts the shapes it has seen).  The batcher
therefore coalesces up to ``max_batch`` requests (waiting at
most ``max_wait_ms`` after the first), scatters them into a zero-padded
``(max_batch, n)`` count matrix, and pushes batches through
``data.pipeline.prefetch`` so host-side batch assembly overlaps device
compute — the same producer/consumer idiom the LM input pipeline uses.

Every request resolves a ``concurrent.futures.Future`` with its (k,) score
vector, a numpy row; per-request wall latency feeds the p50/p99 report.
A projector that returns a device tensor is read back with ``.cpu()`` on
the server thread before any future resolves: that copy waits for the
projection launched on the same thread's stream, so no future sees a
score that has not landed.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from ..data.pipeline import prefetch
from ..device import to_host
from ..obs import metrics, trace
from ..obs.metrics import Histogram


@dataclass(frozen=True)
class BatcherConfig:
    max_batch: int = 64      # the ONE batch shape the projector ever sees
    max_wait_ms: float = 2.0  # coalescing window after the first request
    prefetch_depth: int = 2
    # Graceful degradation under overload (0 = off for both):
    deadline_ms: float = 0.0  # per-request budget; a request popped after
    #                           this long in the queue fails fast with
    #                           RequestTimeout instead of occupying a slot
    max_queue: int = 0        # bound on queued requests; submits past it
    #                           are shed immediately (RequestShed) rather
    #                           than growing an unbounded backlog


class RequestTimeout(TimeoutError):
    """The request sat in the queue past ``cfg.deadline_ms`` — by the time
    a batch slot opened, the client had already given up on the answer."""


class RequestShed(RuntimeError):
    """The submit queue is at ``cfg.max_queue``: the batcher rejects new
    work at the door instead of queueing latency it can never repay."""


class LatencyStats:
    """Per-request wall-latency accumulator -> p50/p99/docs-per-second.

    Backed by the shared `obs.metrics.Histogram` (bounded window + lifetime
    moments), so a long-lived server holds O(window) memory while
    ``count``/``docs_per_s`` reflect the full lifetime.  Each batcher owns
    its OWN histogram instance (snapshots stay per-batcher); the samples
    are also mirrored into the process registry's ``serve.latency_s``.

    Percentiles use the histogram's clamped nearest-rank estimator: the
    previous ``np.percentile(lat, 99)`` linearly interpolated to within a
    hair of the window max for any count < 100, so one slow warm-up
    request over-reported the steady-state p99; now p99 of e.g. 10
    samples reads the second-largest (see `Histogram.percentile`)."""

    def __init__(self, window: int = 100_000):
        self._h = Histogram("serve.latency_s", window=window)
        self._t0: float | None = None
        self._t1: float | None = None
        self._lock = threading.Lock()

    def record(self, latencies_s, now: float) -> None:
        with self._lock:
            if self._t0 is None:
                # Clock starts at the first batch's earliest submit, so the
                # first service time is inside the throughput window (and a
                # single-batch snapshot doesn't divide by ~zero).
                self._t0 = now - (max(latencies_s) if latencies_s else 0.0)
            self._t1 = now
        self._h.observe_many(latencies_s)
        metrics.histogram("serve.latency_s").observe_many(latencies_s)
        metrics.counter("serve.requests").inc(len(latencies_s))

    def snapshot(self) -> dict:
        n = self._h.count
        if n == 0:
            return {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0,
                    "docs_per_s": 0.0}
        with self._lock:
            wall = max((self._t1 or 0.0) - (self._t0 or 0.0), 1e-9)
        return {
            "count": n,
            "p50_ms": self._h.percentile(50) * 1e3,
            "p99_ms": self._h.percentile(99) * 1e3,
            "docs_per_s": float(n / wall),
        }


class _Request:
    __slots__ = ("word_ids", "counts", "t_submit", "future")

    def __init__(self, word_ids, counts):
        self.word_ids = np.asarray(word_ids, np.int64)
        self.counts = np.asarray(counts, np.float32)
        self.t_submit = time.perf_counter()
        self.future: Future = Future()


class MicroBatcher:
    """Queue -> coalesce -> pad -> project -> resolve futures.

    ``projector`` is any object with ``.project((B, n) array) -> (B, k)``
    (normally the active ``TopicProjector``; pass a registry-backed lambda
    for hot-swappable serving).  ``observer`` (optional) receives each
    batch's *live* rows — the drift monitor taps traffic here.
    """

    def __init__(self, projector, n_features: int,
                 cfg: BatcherConfig | None = None, *, observer=None):
        self.projector = projector
        self.n = int(n_features)
        self.cfg = cfg if cfg is not None else BatcherConfig()
        self.observer = observer
        self.stats = LatencyStats()
        self.batches_served = 0
        self.timeouts = 0        # requests expired past cfg.deadline_ms
        self.shed = 0            # submits rejected at cfg.max_queue
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- client
    def submit(self, word_ids, counts) -> Future:
        """Enqueue one sparse document; resolves to its (k,) score row.

        Over-capacity submits (``cfg.max_queue``) return an already-failed
        future (`RequestShed`) — the client learns instantly, and the
        backlog can't grow past what the deadline budget could ever
        service.  The queue stays UNBOUNDED internally so the shutdown
        sentinel can never block; capacity is enforced here at the door."""
        if self._stop.is_set():
            raise RuntimeError("batcher is stopped")
        r = _Request(word_ids, counts)
        if self.cfg.max_queue > 0 and self._q.qsize() >= self.cfg.max_queue:
            self.shed += 1
            metrics.counter("serve.shed").inc()
            r.future.set_exception(RequestShed(
                f"submit queue at capacity ({self.cfg.max_queue}); "
                "request shed"
            ))
            return r.future
        self._q.put(r)
        if self._stop.is_set():
            # stop() raced between our check and the put: its drain may
            # already have run, so drain again — never strand a future.
            self._drain_failed()
        return r.future

    # ------------------------------------------------------------- server
    def _expired(self, r: "_Request") -> bool:
        """Deadline check at pop time: a request that already overstayed
        ``cfg.deadline_ms`` in the queue fails fast (`RequestTimeout`) and
        never occupies a batch slot — under overload the batcher spends
        its capacity on answers someone is still waiting for."""
        if self.cfg.deadline_ms <= 0:
            return False
        waited = time.perf_counter() - r.t_submit
        if waited * 1e3 <= self.cfg.deadline_ms:
            return False
        self.timeouts += 1
        metrics.counter("serve.timeouts").inc()
        r.future.set_exception(RequestTimeout(
            f"request expired after {waited * 1e3:.1f}ms in queue "
            f"(deadline {self.cfg.deadline_ms:.1f}ms)"
        ))
        return True

    def _collect(self):
        """Yield (requests, padded (max_batch, n) matrix) until stopped."""
        cfg = self.cfg
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if first is None:       # shutdown sentinel
                return
            if self._expired(first):
                continue
            reqs = [first]
            deadline = time.perf_counter() + cfg.max_wait_ms / 1e3
            while len(reqs) < cfg.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    r = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if r is None:
                    break
                if not self._expired(r):
                    reqs.append(r)
            X = np.zeros((cfg.max_batch, self.n), np.float32)
            live = []
            for r in reqs:
                try:   # a malformed request fails ITS future, not the loop
                    w = r.word_ids
                    if w.size and (int(w.min()) < 0 or int(w.max()) >= self.n):
                        # negative ids would silently alias into the vocab
                        # tail via numpy indexing — reject them explicitly
                        raise IndexError(
                            f"word ids outside [0, {self.n})")
                    np.add.at(X[len(live)], w, r.counts)
                    live.append(r)
                except (IndexError, ValueError, TypeError) as e:
                    X[len(live)] = 0.0   # scatter may have partially landed
                    r.future.set_exception(e)
            if live:
                yield live, X

    def _serve_loop(self):
        # Runs on the server thread: spans opened here land on that
        # thread's own root timeline (see obs.trace thread model).
        for reqs, X in prefetch(self._collect(), size=self.cfg.prefetch_depth):
            with trace.span("serve.batch", batch=len(reqs)):
                try:
                    scores = to_host(self.projector.project(X))
                except Exception as e:      # fail the waiting futures, not us
                    for r in reqs:
                        r.future.set_exception(e)
                    continue
                for i, r in enumerate(reqs):
                    r.future.set_result(scores[i])
                now = time.perf_counter()   # after resolution: honest latency
                self.stats.record([now - r.t_submit for r in reqs], now)
                self.batches_served += 1
                metrics.counter("serve.batches").inc()
                metrics.histogram("serve.batch_size").observe(len(reqs))
                # live backlog gauge: what /metrics and /varz scrape while
                # the server runs — rising depth is the overload signal
                # *before* deadline/shed tallies start moving
                metrics.gauge("serve.queue_depth").set(self._q.qsize())
                if self.observer is not None:  # off the response critical path
                    self.observer(X[: len(reqs)])

    def snapshot(self) -> dict:
        """Latency percentiles plus the degradation tallies — the one
        read-out an operator needs to see overload (rising ``queue_depth``,
        then ``timeouts`` / ``shed``) before it becomes an outage.  This
        dict is what the telemetry exporter's ``/varz`` serves for the
        batcher, so it must be the *complete* picture: the deadline /
        load-shed counters and the live queue depth are all here."""
        s = self.stats.snapshot()
        s.update(
            batches=self.batches_served,
            timeouts=self.timeouts,
            shed=self.shed,
            queue_depth=self._q.qsize(),
            max_queue=self.cfg.max_queue,
            deadline_ms=self.cfg.deadline_ms,
        )
        return s

    def start(self) -> "MicroBatcher":
        if self._thread is not None:
            raise RuntimeError("batcher already started")
        # Warm-up: one (max_batch, n) projection on the caller's thread
        # before traffic arrives (the reference compiles its program here;
        # the port loads the kernel's library and registers the shape).
        self.projector.project(np.zeros((self.cfg.max_batch, self.n),
                                        np.float32))
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()
        return self

    def _drain_failed(self) -> None:
        """Fail every request still sitting in the queue (post-shutdown)."""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if r is not None and not r.future.done():
                r.future.set_exception(RuntimeError("batcher stopped"))

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        # Requests that raced past the sentinel would otherwise hang their
        # futures forever; fail them promptly instead (submit() re-drains
        # on its own post-put stop check, closing the enqueue race).
        self._drain_failed()

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
