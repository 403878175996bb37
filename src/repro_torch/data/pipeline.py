"""LM token pipeline and the background-thread prefetch of the streaming
corpus passes (port of ``repro.data.pipeline``, numpy and the stdlib
only).

Fault-tolerance contract: batch ``t`` is a pure function of ``(seed, t)``
(`TokenPipeline.batch_at`, seeded by ``SeedSequence([seed, step,
host_lo])``, the reference's draws bit for bit), so restoring a checkpoint
at step ``t`` resumes the exact data stream with no replay buffer or
loader state.  The port runs in one process, so `host_slice` defaults to
process 0 of 1: the whole batch.

The synthetic stream is not uniform noise: tokens follow a per-sequence
random walk over the vocabulary with occasional resets, giving the LM a
learnable short-range structure.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    batch: int          # global batch (sequences)
    seq_len: int
    seed: int = 0
    walk_step: int = 7  # random-walk stride in token space


class TokenPipeline:
    """Stateless synthetic LM data: ``batch_at(t)`` is pure in (seed, t)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg

    def batch_at(self, step: int, *, host_lo: int = 0,
                 host_hi: int | None = None) -> np.ndarray:
        """Rows ``host_lo:host_hi`` of batch ``step``, (rows, seq_len)
        int32."""
        cfg = self.cfg
        hi = cfg.batch if host_hi is None else host_hi
        n = hi - host_lo
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_lo])
        )
        start = rng.integers(0, cfg.vocab_size, size=(n, 1))
        steps = rng.integers(-cfg.walk_step, cfg.walk_step + 1,
                             size=(n, cfg.seq_len))
        reset = rng.random((n, cfg.seq_len)) < 0.02
        jump = rng.integers(0, cfg.vocab_size, size=(n, cfg.seq_len))
        walk = np.cumsum(steps, axis=1) + start
        toks = np.where(reset, jump, walk) % cfg.vocab_size
        return toks.astype(np.int32)

    def __iter__(self):
        t = 0
        while True:
            yield self.batch_at(t)
            t += 1


class _PrefetchError:
    """Wrapper carrying a worker-thread exception across the queue (a bare
    exception instance could collide with a stream that yields exceptions)."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(it, size: int = 2, *, stats: dict | None = None):
    """Background-thread prefetch — overlaps host data generation with device
    compute (the CPU-side analogue of the device prefetch a real input
    pipeline would use).

    A producer-side exception is captured and re-raised here in the
    consumer (with the worker traceback chained), instead of silently
    truncating the stream.

    ``stats`` (any mutable mapping, e.g. a plain dict or an ingest
    counters dict) receives the pipeline's stall accounting, answering
    "is this pass read-bound or reduce-bound?":

      consumer_stall_s — time the CONSUMER blocked on an empty queue
                         (the reader can't keep up: read-bound)
      producer_stall_s — time the WORKER blocked on a full queue
                         (the reduction can't keep up: reduce-bound)
      items            — items that crossed the queue
      occupancy_sum    — queue depth sampled before each get (divide by
                         ``items`` for mean occupancy; ~size means the
                         buffer is actually ahead)

    The two stall keys are written from different threads but never the
    same key from both, so plain dict arithmetic is race-free under the
    GIL.  The ingest engine forwards these into the shared metrics
    registry as ``ingest.prefetch.*`` (see `repro_torch.sparse.engine`).

    Abandonment: if the consumer stops early (``break``, an exception, or
    generator ``close()``), the worker is signalled via a cancellation
    event, unblocked (its pending ``q.put`` uses a polling timeout), joined,
    and the SOURCE iterator is closed — so a half-consumed pass cannot
    leave a thread parked on a full queue pinning the ring-buffered
    megabatch arrays (or holding mmap handles) for the process lifetime."""
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    cancel = threading.Event()

    def _put(x) -> bool:
        """Blocking put that aborts when the consumer is gone."""
        while not cancel.is_set():
            try:
                q.put(x, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            try:
                for x in it:
                    if stats is None:
                        if not _put(x):
                            return
                    else:
                        t0 = time.perf_counter()
                        if not _put(x):
                            return
                        stats["producer_stall_s"] = (
                            stats.get("producer_stall_s", 0.0)
                            + (time.perf_counter() - t0)
                        )
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                _put(_PrefetchError(e))
            else:
                _put(_END)
        finally:
            # release the source's resources (ring buffers, mmaps) in the
            # thread that owns the iteration, whether we finished, failed,
            # or were cancelled
            close = getattr(it, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            if stats is None:
                x = q.get()
            else:
                stats["occupancy_sum"] = stats.get("occupancy_sum", 0) + q.qsize()
                t0 = time.perf_counter()
                x = q.get()
                stats["consumer_stall_s"] = (
                    stats.get("consumer_stall_s", 0.0)
                    + (time.perf_counter() - t0)
                )
            if x is _END:
                return
            if isinstance(x, _PrefetchError):
                raise x.exc
            if stats is not None:
                stats["items"] = stats.get("items", 0) + 1
            yield x
    finally:
        # runs on exhaustion AND on abandonment (close()/break/throw):
        # stop the worker, drain anything it already queued, and reap it.
        cancel.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def host_slice(global_batch: int, *, process_index: int = 0,
               process_count: int = 1) -> tuple[int, int]:
    """Row range of the global batch a process should materialise (the
    port runs in one process: process 0 of 1 by default)."""
    per = global_batch // process_count
    return process_index * per, (process_index + 1) * per
