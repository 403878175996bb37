"""Declarative health rules over the metrics registry -> a typed verdict
(port of ``repro.obs.health``, stdlib only).

A `HealthRule` names an instrument, an *aspect* of it (current value,
delta/rate over a trailing window, or an interval percentile for
histograms), a comparison, and a severity.  The `HealthEngine` is fed one
*delta sample* per exporter interval (see `obs.export.TelemetryExporter`
— counters arrive with their per-interval delta, histograms with the
samples observed during the interval) and keeps a bounded history so
``window_s`` aggregations see more than one interval.  Each evaluation
produces a `HealthStatus`:

  ok        — no rule firing
  degraded  — only ``severity="warn"`` rules firing
  unhealthy — any ``severity="critical"`` rule firing (``/healthz`` 503)

Rules are data, not code: the default packs below cover the serving path
(`serving_rules` — p99 latency ceiling, shed/timeout burst, drift flag),
the ingestion path (`ingestion_rules` — prefetch-occupancy floor, retry
burst), and the solver's numerical health (`solver_rules` — any
non-finite objective is terminal-critical, a stall burst warns).
Thresholds are keyword-tunable so launchers can ship SLOs without
subclassing anything.

Beyond the declarative rules, this module carries the fit runtime's
WATCHDOGS: a `Watchdog` is a cooperative wall-clock budget (`check()` at
work boundaries — megabatches, solve rounds) that raises a typed
`WatchdogTimeout` subclass when exceeded, incrementing the
``watchdog.expired`` counter the `runtime_rules` pack escalates on.

Stdlib only, like the rest of the port's ``obs`` package.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from . import metrics as _metrics
from .metrics import percentile_of


class WatchdogTimeout(TimeoutError):
    """A cooperative wall-clock budget was exceeded.  Typed (and
    subclassed per budget) so callers can catch exactly the deadline they
    armed; carries what was being watched and the elapsed/budget pair."""

    def __init__(self, what: str, *, budget_s: float, elapsed_s: float):
        super().__init__(
            f"{what} exceeded its {budget_s:.3g}s wall-clock budget "
            f"({elapsed_s:.3g}s elapsed)"
        )
        self.what = what
        self.budget_s = float(budget_s)
        self.elapsed_s = float(elapsed_s)


class PassDeadlineError(WatchdogTimeout):
    """A streaming corpus pass blew ``SPCAConfig.pass_deadline_s``."""


class SolveDeadlineError(WatchdogTimeout):
    """A solve round blew ``SPCAConfig.solve_deadline_s``."""


class Watchdog:
    """Cooperative deadline: arm at the start of a bounded piece of work,
    `check()` at internal boundaries.  A check past the budget increments
    ``watchdog.expired`` and raises ``exc`` (a `WatchdogTimeout`
    subclass).  Cooperative on purpose — the work it guards is a kernel
    launch or a file read, neither of which can be safely interrupted
    mid-flight, and the checkpointers sit exactly at the boundaries where
    `check` runs, so an expiry is always resumable."""

    def __init__(self, budget_s: float, *, what: str = "work",
                 exc: type = WatchdogTimeout, clock=time.monotonic):
        self.budget_s = float(budget_s)
        self.what = str(what)
        self.exc = exc
        self._clock = clock
        self._t0 = clock()

    def elapsed_s(self) -> float:
        return self._clock() - self._t0

    def expired(self) -> bool:
        return self.elapsed_s() > self.budget_s

    def check(self) -> None:
        elapsed = self.elapsed_s()
        if elapsed > self.budget_s:
            _metrics.counter("watchdog.expired").inc()
            raise self.exc(self.what, budget_s=self.budget_s,
                           elapsed_s=elapsed)

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

#: aspect -> which instrument records it applies to and how it aggregates
#: over the trailing window (see `HealthEngine._aspect_value`).
ASPECTS = ("value", "delta", "rate", "p50", "p99", "max", "mean")


@dataclass(frozen=True)
class HealthRule:
    """One declarative judgment: ``<metric>.<aspect> <op> <threshold>``.

    ``window_s = 0`` evaluates the newest sample only; otherwise deltas
    sum (and rates normalise) over every sample in the trailing window and
    percentile aspects pool the window's interval samples.  ``min_count``
    suppresses percentile verdicts until that many samples are in the
    window — the serving analogue of DriftMonitor's ``min_docs``."""

    name: str
    metric: str
    op: str
    threshold: float
    window_s: float = 0.0
    severity: str = "critical"          # "critical" | "warn"
    aspect: str = "value"
    min_count: int = 1

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r} (use one of {sorted(_OPS)})")
        if self.aspect not in ASPECTS:
            raise ValueError(
                f"unknown aspect {self.aspect!r} (use one of {ASPECTS})")
        if self.severity not in ("critical", "warn"):
            raise ValueError(f"unknown severity {self.severity!r}")


@dataclass(frozen=True)
class Firing:
    """One rule that tripped, with the observed value that tripped it."""

    rule: str
    metric: str
    aspect: str
    value: float
    op: str
    threshold: float
    severity: str

    def describe(self) -> str:
        return (f"{self.rule}: {self.metric}.{self.aspect}="
                f"{self.value:.6g} {self.op} {self.threshold:.6g} "
                f"[{self.severity}]")


@dataclass(frozen=True)
class HealthStatus:
    """The typed verdict behind ``/healthz`` and the launchers' reports."""

    status: str                         # "ok" | "degraded" | "unhealthy"
    firing: tuple = ()
    t_unix_s: float = 0.0
    rules_evaluated: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def http_status(self) -> int:
        """503 only when unhealthy: degraded still serves (it is the
        operator's early warning, not a load-balancer eviction)."""
        return 503 if self.status == "unhealthy" else 200

    def __bool__(self) -> bool:
        return self.ok

    def describe(self) -> str:
        if not self.firing:
            return f"health: {self.status}"
        return (f"health: {self.status} — "
                + "; ".join(f.describe() for f in self.firing))

    def to_dict(self) -> dict:
        return {
            "status": self.status,
            "t_unix_s": self.t_unix_s,
            "rules_evaluated": self.rules_evaluated,
            "firing": [vars(f).copy() for f in self.firing],
        }


class HealthEngine:
    """Evaluates a rule set against the exporter's delta-sample stream.

    ``evaluate(sample, t)`` appends the sample to a bounded history and
    judges every rule; a rule whose metric has produced no data yet simply
    does not fire (absence of evidence is not an outage).  The history
    depth is bounded by ``max_history`` samples AND pruned to the longest
    rule window, so a day-long serve process holds O(window) state."""

    def __init__(self, rules, *, max_history: int = 512):
        self.rules = tuple(rules)
        self._max_window = max(
            [r.window_s for r in self.rules], default=0.0)
        self._history: deque = deque(maxlen=int(max_history))
        self._last = HealthStatus(status="ok")

    # ------------------------------------------------------------ feeding
    def evaluate(self, sample: dict, t: float | None = None) -> HealthStatus:
        """``sample`` is one delta sample: name -> record dict with
        ``type`` plus ``value``/``delta`` (counter), ``value`` (gauge) or
        ``count_delta``/``samples`` (histogram)."""
        t = time.time() if t is None else float(t)
        self._history.append((t, sample))
        cutoff = t - self._max_window - 1e-9
        while len(self._history) > 1 and self._history[0][0] < cutoff:
            self._history.popleft()

        firing = []
        for rule in self.rules:
            v = self._aspect_value(rule, t)
            if v is None:
                continue
            if _OPS[rule.op](v, rule.threshold):
                firing.append(Firing(
                    rule=rule.name, metric=rule.metric, aspect=rule.aspect,
                    value=float(v), op=rule.op, threshold=rule.threshold,
                    severity=rule.severity,
                ))
        if any(f.severity == "critical" for f in firing):
            status = "unhealthy"
        elif firing:
            status = "degraded"
        else:
            status = "ok"
        self._last = HealthStatus(
            status=status, firing=tuple(firing), t_unix_s=t,
            rules_evaluated=len(self.rules),
        )
        return self._last

    @property
    def last(self) -> HealthStatus:
        return self._last

    # --------------------------------------------------------- aggregation
    def _window(self, rule: HealthRule, t: float):
        """(t, record) pairs inside the rule's trailing window — at least
        the newest sample, so ``window_s=0`` means "this interval"."""
        if not self._history:
            return []
        lo = t - rule.window_s - 1e-9
        out = [(ts, s[rule.metric]) for ts, s in self._history
               if ts >= lo and rule.metric in s]
        if not out:
            newest_t, newest = self._history[-1]
            if rule.metric in newest:
                out = [(newest_t, newest[rule.metric])]
        return out

    def _aspect_value(self, rule: HealthRule, t: float):
        recs = self._window(rule, t)
        if not recs:
            return None
        newest = recs[-1][1]
        a = rule.aspect
        if a == "value":
            if newest.get("type") == "histogram":
                # lifetime mean — rarely what you want, but well-defined
                c = newest.get("count", 0)
                return newest.get("sum", 0.0) / c if c else None
            return newest.get("value")
        if a in ("delta", "rate"):
            deltas = [r.get("delta", r.get("count_delta", 0.0))
                      for _, r in recs]
            total = float(sum(deltas))
            if a == "delta":
                return total
            span = max(recs[-1][0] - recs[0][0],
                       recs[-1][1].get("dt_s", 0.0), 1e-9)
            return total / span
        # percentile / extremum aspects pool the window's interval samples
        samples: list = []
        for _, r in recs:
            samples.extend(r.get("samples", ()))
        if len(samples) < max(1, rule.min_count):
            return None
        if a == "p50":
            return percentile_of(samples, 50)
        if a == "p99":
            return percentile_of(samples, 99)
        if a == "max":
            return max(samples)
        return sum(samples) / len(samples)          # "mean"


# ---------------------------------------------------------------------------
# Default rule packs — the launchers' SLOs, thresholds tunable per call.
# ---------------------------------------------------------------------------

def solver_rules(*, stall_burst: float = 8.0,
                 stall_window_s: float = 120.0) -> list[HealthRule]:
    """Numerical health of the BCD path.  A non-finite objective is
    *terminal*-critical: the rule reads the lifetime counter value, so once
    a fit NaNs, ``/healthz`` stays 503 until the process (or registry) is
    replaced — a NaN'd model must never ship behind a green check."""
    return [
        HealthRule("solver_nonfinite", "solver.nonfinite", ">=", 1.0,
                   severity="critical", aspect="value"),
        HealthRule("solver_stall_burst", "solver.stalled", ">=", stall_burst,
                   window_s=stall_window_s, severity="warn", aspect="delta"),
    ]


def serving_rules(*, p99_latency_s: float = 0.5,
                  latency_window_s: float = 60.0,
                  shed_per_s: float = 1.0,
                  timeout_per_s: float = 1.0,
                  burst_window_s: float = 30.0) -> list[HealthRule]:
    """SLOs for the microbatcher: a p99 ceiling on request latency, burst
    rates on the two graceful-degradation counters (shedding is critical —
    clients are being turned away — timeouts warn first), and the drift
    gauge (`serve.drift.triggered`, set by `DriftMonitor.check`): a stale
    Thm 2.1 certificate degrades the deployment until a refit lands."""
    return [
        HealthRule("serve_p99_latency", "serve.latency_s", ">", p99_latency_s,
                   window_s=latency_window_s, severity="warn", aspect="p99",
                   min_count=20),
        HealthRule("serve_shed_burst", "serve.shed", ">=", shed_per_s,
                   window_s=burst_window_s, severity="critical",
                   aspect="rate"),
        HealthRule("serve_timeout_burst", "serve.timeouts", ">=",
                   timeout_per_s, window_s=burst_window_s, severity="warn",
                   aspect="rate"),
        HealthRule("serve_drift", "serve.drift.triggered", ">=", 1.0,
                   severity="warn", aspect="value"),
    ]


def ingestion_rules(*, occupancy_floor: float = 0.25,
                    occupancy_window_s: float = 60.0,
                    retry_burst: float = 8.0,
                    retry_window_s: float = 60.0) -> list[HealthRule]:
    """SLOs for the streaming corpus passes: a floor on mean prefetch
    occupancy (a starved ring means the pass is read-bound — the reduction
    is waiting on disk) and a burst bound on absorbed transient-read
    retries (a few are weather; a burst is a failing disk)."""
    return [
        HealthRule("ingest_prefetch_starved", "ingest.prefetch.occupancy",
                   "<", occupancy_floor, window_s=occupancy_window_s,
                   severity="warn", aspect="mean", min_count=4),
        HealthRule("ingest_retry_burst", "ingest.retries", ">=", retry_burst,
                   window_s=retry_window_s, severity="warn", aspect="delta"),
    ]


def runtime_rules(*, fallback_burst: float = 4.0,
                  fallback_window_s: float = 120.0) -> list[HealthRule]:
    """SLOs for the supervised fit runtime: the fallback ladder and
    watchdogs.  A fallback is a *survived* fault — the fused solve went
    bad and the oracle path patched it — so a burst only DEGRADES the fit
    (``/healthz`` stays 200, results are still sound).  Divergence (both
    rungs failed; the fit raised after dumping a repro bundle) and an
    expired watchdog are critical: the fit is dead or past its budget and
    an operator has to act.  Degraded-mode mesh execution warns: the fit
    is finishing, just on fewer devices than it was given."""
    return [
        HealthRule("solver_fallback_burst", "solver.fallbacks", ">=",
                   fallback_burst, window_s=fallback_window_s,
                   severity="warn", aspect="delta"),
        HealthRule("solver_divergence", "solver.divergence", ">=", 1.0,
                   severity="critical", aspect="value"),
        HealthRule("watchdog_expired", "watchdog.expired", ">=", 1.0,
                   severity="critical", aspect="value"),
        HealthRule("mesh_degraded", "mesh.degraded", ">=", 1.0,
                   severity="warn", aspect="value"),
    ]


def default_rules() -> list[HealthRule]:
    """Everything: what a process that both ingests and serves should run."""
    return (solver_rules() + serving_rules() + ingestion_rules()
            + runtime_rules())
