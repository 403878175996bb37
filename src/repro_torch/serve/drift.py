"""Streaming drift monitor for the safe-elimination certificate.

Port of ``repro.serve.drift`` (same verdicts and ``serve.drift.*``
gauges); the running screen lives on the monitor's device.

The fit was cheap because Thm 2.1 (Zhang & El Ghaoui 2011) let us drop
every feature with training variance below lambda *before* solving.  That
proof is about the distribution the screen saw — if live traffic drifts (a
tail word becomes hot), an eliminated feature's true variance can cross
lambda and the served components are no longer certified optimal for the
traffic.

``DriftMonitor`` folds served batches into a running ``Screen`` via the same
pooled-moment merge the sharded fit uses (``elimination.combine_screens``),
and flags a refit when any *eliminated* feature's running variance reaches
``margin * lambda``.  Features kept at fit time may drift freely — they are
inside the solve, not covered by the certificate — so they never trigger.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..core import elimination
from ..core.elimination import Screen
from ..device import as_tensor, resolve, to_host
from ..obs import metrics


@dataclass(frozen=True)
class DriftReport:
    triggered: bool
    n_offending: int
    offending: np.ndarray   # eliminated feature ids whose variance >= margin*lam
    max_ratio: float        # max over eliminated features of var / lam
    docs_seen: int

    def __bool__(self) -> bool:  # ``if monitor.check(): refit()``
        return self.triggered


class DriftMonitor:
    """Running-variance watch over the features the fit eliminated.

    ``fitted_screen`` is the training-time screen; ``lam`` is either one
    threshold or the per-component vector (``ModelVersion.lams``) — each
    component carries its own Thm 2.1 certificate, and a feature eliminated
    only from the *higher*-lambda solves still invalidates those components
    when its variance crosses *their* threshold, so all k boundaries are
    watched.  ``margin`` sets the trip line at ``margin * lam_c``: the
    default 1.25 absorbs the sampling noise of a running variance estimate
    for features sitting just below a cutoff (on Zipf data the rank just
    past the elimination boundary has variance lam*(1-eps) with
    eps ~ alpha/rank — well inside estimator noise), while a genuinely
    drifted word overshoots the band immediately.  Use 1.0 for the strict
    Thm 2.1 boundary, or < 1 as an early-warning band.  ``min_docs``
    suppresses verdicts until the running estimate has seen enough traffic
    to mean anything.  Observed batches are folded on the device of the
    fitted screen's variances (the card when they are not a tensor).
    """

    def __init__(self, fitted_screen: Screen, lam, *,
                 margin: float = 1.25, min_docs: int = 256):
        self.lams = np.atleast_1d(np.asarray(lam, np.float64))
        self.lam = float(self.lams.min())
        self.margin = float(margin)
        self.min_docs = int(min_docs)
        v = fitted_screen.variances
        self.device = v.device if isinstance(v, torch.Tensor) else resolve()
        train = to_host(v)
        # (k, n): was feature j eliminated from component c's solve?
        self.eliminated_by = train[None, :] < self.lams[:, None]
        self.eliminated = self.eliminated_by.any(axis=0)
        self._running: Screen | None = None
        self._lock = threading.Lock()

    # ---------------------------------------------------------- streaming
    def observe(self, batch) -> None:
        """Fold one (B, n) count batch of served traffic (numpy or a
        tensor; host data goes to the monitor's device first)."""
        part = elimination.feature_variances(as_tensor(batch, self.device),
                                             center=True)
        self.observe_screen(part)

    def observe_screen(self, part: Screen) -> None:
        """Fold a pre-computed partial screen (e.g. from a remote shard)."""
        with self._lock:
            if self._running is None:
                self._running = part
            else:
                self._running = elimination.combine_screens(
                    [self._running, part]
                )

    # ------------------------------------------------------------ verdict
    @property
    def docs_seen(self) -> int:
        s = self._running
        return 0 if s is None else int(s.count)

    def check(self) -> DriftReport:
        with self._lock:
            s = self._running
        if s is None or int(s.count) < self.min_docs:
            return self._report(DriftReport(
                False, 0, np.zeros(0, np.int64), 0.0,
                0 if s is None else int(s.count)))
        var = to_host(s.variances)
        lams = self.lams[:, None]
        # A feature offends component c when it was eliminated from c's
        # solve AND its live variance crosses c's own trip line.
        stale = self.eliminated_by & (var[None, :] >= self.margin * lams)
        offending = np.flatnonzero(stale.any(axis=0))
        with np.errstate(divide="ignore", invalid="ignore"):
            ratios = np.where(self.eliminated_by, var[None, :] / lams, 0.0)
        max_ratio = float(ratios.max()) if ratios.size else 0.0
        return self._report(DriftReport(
            triggered=offending.size > 0,
            n_offending=int(offending.size),
            offending=offending,
            max_ratio=max_ratio,
            docs_seen=int(s.count),
        ))

    @staticmethod
    def _report(rep: DriftReport) -> DriftReport:
        """Mirror the verdict into the registry: the ``serve.drift.*``
        gauges are what the telemetry exporter's ``serve_drift`` health
        rule watches — the first hop from monitoring toward auto-refit (a
        refit service consumes the same gauge the /healthz rule does)."""
        metrics.gauge("serve.drift.triggered").set(1.0 if rep.triggered
                                                   else 0.0)
        metrics.gauge("serve.drift.max_ratio").set(rep.max_ratio)
        metrics.gauge("serve.drift.offending").set(rep.n_offending)
        metrics.gauge("serve.drift.docs_seen").set(rep.docs_seen)
        return rep

    def reset(self) -> None:
        """Forget the running screen (call after acting on a refit flag)."""
        with self._lock:
            self._running = None
