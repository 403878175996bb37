"""Typed metrics registry — the one home for the system's counters.

Absorbs the scattered instrumentation state the driver grew organically
(the ``diagnostics`` dicts in `core.spca`, the ingest counter dict in
`sparse.engine`, the serve batcher's private latency window) into three
instrument types:

  Counter    — monotone float total (``solver.launches``,
               ``ingest.chunks``, ``ingest.prefetch.consumer_stall_s``)
  Gauge      — last-written value (``ingest.prefetch.queue_depth``)
  Histogram  — bounded sample window + lifetime count/sum/min/max
               (``solver.sweeps``, ``serve.latency_s``)

All instruments are thread-safe (the serve and prefetch paths record from
worker threads) and mergeable: `Registry.merge` pools another registry's
instruments — counters add, gauges take the freshest write, histograms
pool windows and lifetime moments — which is the multi-host/-component
story (partial registries combine exactly like `combine_screens` pools
partial Screens).

The ``diagnostics=`` dicts on `core.spca.fit_components` / `search_lambda`
remain the stable read-out API; they are now a *view* over the same
events this registry records (the driver writes both from one code path),
so ``diag["solve_launches"] == registry counter "solver.launches"`` by
construction — asserted by tests/test_obs.py.

Export: `Registry.snapshot()` (plain dict) and `Registry.dump_jsonl(path)`
(one self-contained JSON line per call — a time series of snapshots).

Zero dependencies beyond the stdlib.
"""
from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from collections import deque


class Counter:
    """Monotone float total."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, delta: float = 1.0) -> None:
        with self._lock:
            self._v += delta

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self):
        v = self._v
        return int(v) if float(v).is_integer() else v

    def merge(self, other: "Counter") -> None:
        with self._lock:
            self._v += other._v


class Gauge:
    """Last-written value, with the write time for merge ordering."""

    __slots__ = ("name", "_v", "_t", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._t = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)
            self._t = time.monotonic()

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self):
        return self._v

    def merge(self, other: "Gauge") -> None:
        with self._lock:
            if other._t >= self._t:
                self._v, self._t = other._v, other._t


class Histogram:
    """Bounded-window sample histogram with lifetime moments.

    Percentiles are computed over the ``window`` most-recent samples with
    the *nearest-rank* method, and the requested quantile is clamped to
    the resolution ``n`` samples support (``q <= (n-1)/n``): the old
    serve-side ``np.percentile(lat, 99)`` linearly interpolated to within
    a hair of the sample max for any n < 100, so a single slow warm-up
    request masqueraded as the steady-state p99.  Under the clamp, p99 of
    10 samples reads the second-largest sample (q_eff = 0.9), and from
    n >= 100 the clamp is inactive and nearest-rank p99 is the standard
    ceil(0.99 n)-th order statistic.

    ``count``/``total`` (and min/max) cover the full lifetime, not just
    the window, so long-lived throughput numbers stay exact with O(window)
    memory.
    """

    __slots__ = ("name", "window", "_samples", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, *, window: int = 8192):
        self.name = name
        self.window = int(window)
        self._samples: deque = deque(maxlen=self.window)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._samples.append(v)
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def observe_many(self, vs) -> None:
        for v in vs:
            self.observe(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return self._sum

    def window_samples(self) -> list:
        """A stable copy of the current sample window (oldest first).

        This is the delta-snapshot seam: `obs.export.TelemetryExporter`
        pairs it with the lifetime ``count`` to recover the samples that
        arrived since its previous snapshot (the tail of the window), so
        per-interval percentiles can be computed without the instrument
        keeping any exporter-specific state."""
        with self._lock:
            return list(self._samples)

    def percentile(self, q: float) -> float:
        """Clamped nearest-rank quantile of the sample window; ``q`` in
        [0, 100].  0.0 when empty."""
        with self._lock:
            xs = list(self._samples)
        return percentile_of(xs, q)

    def snapshot(self) -> dict:
        with self._lock:
            n = self._count
            mean = self._sum / n if n else 0.0
            mn = self._min if n else 0.0
            mx = self._max if n else 0.0
        return {
            "count": n,
            "sum": self._sum,
            "mean": mean,
            "min": mn,
            "max": mx,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }

    def merge(self, other: "Histogram") -> None:
        with other._lock:
            samples = list(other._samples)
            count, total = other._count, other._sum
            mn, mx = other._min, other._max
        with self._lock:
            self._samples.extend(samples)       # deque drops the oldest
            self._count += count
            self._sum += total
            self._min = min(self._min, mn)
            self._max = max(self._max, mx)


def percentile_of(samples, q: float) -> float:
    """Clamped nearest-rank quantile of an arbitrary sample list — the
    same estimator `Histogram.percentile` runs on its window, exposed for
    consumers that hold their own sample sets (the telemetry exporter's
    per-interval windows, the health engine's trailing windows)."""
    xs = sorted(samples)
    n = len(xs)
    if n == 0:
        return 0.0
    q_eff = min(q / 100.0, (n - 1) / n)
    idx = max(0, math.ceil(q_eff * n) - 1)
    return xs[min(idx, n - 1)]


class Registry:
    """Get-or-create instrument registry with a stable dotted namespace.

    Naming scheme (documented in ROADMAP "Observability"): instruments are
    ``<subsystem>.<event>`` — ``solver.*`` for BCD launches/sweeps,
    ``cov.*`` for the reduced-covariance cache, ``search.*`` for the
    lambda search, ``ingest.*`` for corpus passes (with
    ``ingest.prefetch.*`` for the pipeline), ``kernel.launches.<op>`` for
    per-op dispatch counts, ``serve.*`` for the microbatcher.
    """

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, *, window: int = 8192) -> Histogram:
        h = self._get(name, Histogram)
        return h

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def get(self, name: str):
        """The instrument registered under ``name``, or None."""
        with self._lock:
            return self._instruments.get(name)

    def value(self, name: str, default=0):
        """Counter/gauge value (or histogram snapshot) by name — the
        read-out the diagnostics-dict view compares against."""
        inst = self.get(name)
        if inst is None:
            return default
        return inst.snapshot()

    def snapshot(self) -> dict:
        """All instruments as one plain JSON-ready dict."""
        with self._lock:
            items = list(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}

    def merge(self, other: "Registry") -> "Registry":
        """Pool another registry into this one (same-typed instruments
        merge; new names are adopted)."""
        with other._lock:
            items = list(other._instruments.items())
        for name, inst in items:
            mine = self._get(name, type(inst))
            mine.merge(inst)
        return self

    def dump_jsonl(self, path: str, *, extra: dict | None = None) -> str:
        """Append one snapshot line — repeated calls build a time series."""
        rec = {"t_unix_s": time.time(), "metrics": self.snapshot()}
        if extra:
            rec.update(extra)
        with open(path, "a") as f:
            json.dump(rec, f, sort_keys=True)
            f.write("\n")
        return path


# ---------------------------------------------------------------------------
# Process-wide default registry.
# ---------------------------------------------------------------------------

_registry = Registry()


def get_registry() -> Registry:
    return _registry


def set_registry(reg: Registry) -> Registry:
    global _registry
    _registry = reg
    return reg


def reset() -> Registry:
    """Fresh process-wide registry (test isolation)."""
    return set_registry(Registry())


@contextlib.contextmanager
def use_registry(reg: Registry | None = None):
    """``with metrics.use_registry() as reg:`` — swap in a (fresh)
    registry for the block, restore the previous one after."""
    prev = _registry
    r = reg if reg is not None else Registry()
    set_registry(r)
    try:
        yield r
    finally:
        set_registry(prev)


# Convenience module-level recorders (the instrumentation fast path).

def counter(name: str) -> Counter:
    return _registry.counter(name)


def gauge(name: str) -> Gauge:
    return _registry.gauge(name)


def histogram(name: str, *, window: int = 8192) -> Histogram:
    return _registry.histogram(name, window=window)
