"""Deterministic fault injection for the store's file-I/O seam (port of
``repro.testing.faults``).

All of `repro_torch.sparse.store`'s file access goes through one module-level
seam (``store.FILE_IO``).  `FaultInjector` is a drop-in replacement that
delegates to the real implementation while applying a fixed, seeded
schedule of faults, so tests and benches can script failures that land at
an EXACT operation ("the 7th shard-array read raises OSError", "the 2nd
manifest write is torn at 40%") and replay byte-identically every run —
no sleeps, no races, no flaky timing.

Rules (each matches file basenames with an fnmatch pattern and keeps its
own 0-based counter of matching operations):

  fail_nth_read(n, match, times)   reads n..n+times-1 raise
                                   InjectedReadError (an OSError — the
                                   retrying reader's territory; set
                                   ``times`` large to simulate a dead
                                   disk / kill)
  slow_read(delay_s, match, ...)   reads sleep first (latency injection)
  torn_write(n, match, frac)       write n publishes only ``frac`` of the
                                   payload then raises — what a kill
                                   mid-write leaves behind; the store's
                                   tmp+rename publication must never
                                   expose it
  flip_bytes(n, match, n_flips)    write n lands fully, then ``n_flips``
                                   seeded byte-flips corrupt it on disk —
                                   what the crc32 verification must catch

On-disk helpers (`corrupt_file`, `truncate_file`) damage already-written
stores directly for read-side integrity tests.

Usage::

    inj = FaultInjector(fail_nth_read(3, match="*.values.npy", times=2),
                        seed=0)
    with install(inj):
        ... stream a pass; reads 3 and 4 of values shards fail ...
    assert inj.injected["read_fail"] == 2

A second seam targets the SOLVER (``repro_torch.kernels.ops.
SOLVER_FAULTS``): `SolverFaultInjector` perturbs what `bcd_solve` /
`bcd_solve_batched` return — a non-finite objective
(``nonfinite_solve``), a sweep counter pinned at the budget
(``stalled_solve``) — or raises an `InjectedDispatchError` (a
RuntimeError, like a failed kernel launch) before the launch
(``dispatch_error``).  Rules fnmatch the call SITE ("bcd_solve",
"bcd_solve_batched") with the same 0-based occurrence windows as the
I/O rules, so a test can say "the 9th single solve goes non-finite" and
replay it exactly.  This is the surface the solver fallback ladder and
the fit's kill-and-resume tests drive::

    with install_solver(SolverFaultInjector(
            nonfinite_solve(2, match="bcd_solve"))):
        ... the 3rd fused solve reports obj=NaN; the supervisor must
        ... fall back to the whole-matrix program and finish finite ...

A solve's results are tensors on the device that ran it (the card, or the
CPU under the tests).  The injector perturbs them there, as tensors: an
injected run takes the code path of a real unhealthy solve and adds no
host copy to the launch path.
"""
from __future__ import annotations

import fnmatch
import io
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from ..sparse import store as _store


class InjectedReadError(OSError):
    """The injected transient read failure (an OSError, so the store's
    retry policy applies — exactly like a real flaky disk)."""


class InjectedWriteError(OSError):
    """The injected write failure (torn writes raise this after the
    partial payload lands)."""


@dataclass
class _Rule:
    op: str                      # "read" | "write"
    match: str = "*"
    n: int = 0                   # 0-based index of the first op to hit
    times: int = 1
    seen: int = field(default=0, compare=False)

    def _due(self, path: str) -> bool:
        if not fnmatch.fnmatch(os.path.basename(path), self.match):
            return False
        i, self.seen = self.seen, self.seen + 1
        return self.n <= i < self.n + self.times


@dataclass
class _FailRead(_Rule):
    op: str = "read"


@dataclass
class _SlowRead(_Rule):
    op: str = "read"
    delay_s: float = 0.0


@dataclass
class _TornWrite(_Rule):
    op: str = "write"
    frac: float = 0.5


@dataclass
class _FlipBytes(_Rule):
    op: str = "write"
    n_flips: int = 4


def fail_nth_read(n: int, *, match: str = "*", times: int = 1) -> _Rule:
    """Matching reads ``n .. n+times-1`` (0-based) raise
    InjectedReadError.  Large ``times`` = every read from n on fails — a
    kill, as far as the pass is concerned."""
    return _FailRead(match=match, n=n, times=times)


def slow_read(delay_s: float, *, match: str = "*", n: int = 0,
              times: int = 10**9) -> _Rule:
    """Matching reads sleep ``delay_s`` before delegating."""
    return _SlowRead(match=match, n=n, times=times, delay_s=delay_s)


def torn_write(n: int = 0, *, match: str = "*", frac: float = 0.5) -> _Rule:
    """Matching write ``n`` publishes only the leading ``frac`` of its
    payload, then raises InjectedWriteError."""
    return _TornWrite(match=match, n=n, frac=frac)


def flip_bytes(n: int = 0, *, match: str = "*", n_flips: int = 4) -> _Rule:
    """Matching write ``n`` completes, then ``n_flips`` seeded byte-flips
    corrupt the file on disk (header bytes are spared so the damage hits
    payload, not parseability — the crc32's job, not np.load's)."""
    return _FlipBytes(match=match, n=n, n_flips=n_flips)


class FaultInjector(_store._FileIO):
    """A ``store.FILE_IO`` replacement applying a deterministic fault
    schedule; everything it doesn't fault delegates to ``inner``."""

    def __init__(self, *rules: _Rule, seed: int = 0, inner=None):
        self.rules = list(rules)
        self.rng = np.random.default_rng(seed)
        self.inner = inner if inner is not None else _store._FileIO()
        self.reads = 0
        self.writes = 0
        self.injected: dict[str, int] = {
            "read_fail": 0, "slow": 0, "torn": 0, "flip": 0,
        }

    # -- read side --------------------------------------------------------

    def _before_read(self, path: str) -> None:
        self.reads += 1
        for r in self.rules:
            if r.op != "read" or not r._due(path):
                continue
            if isinstance(r, _SlowRead):
                self.injected["slow"] += 1
                time.sleep(r.delay_s)
            else:
                self.injected["read_fail"] += 1
                raise InjectedReadError(
                    f"injected read failure: {os.path.basename(path)}"
                )

    def load_array(self, path, *, mmap_mode=None):
        self._before_read(path)
        return self.inner.load_array(path, mmap_mode=mmap_mode)

    def read_text(self, path):
        self._before_read(path)
        return self.inner.read_text(path)

    # -- write side -------------------------------------------------------

    def _write_rule(self, path: str) -> _Rule | None:
        for r in self.rules:
            if r.op == "write" and r._due(path):
                return r
        return None

    def _write_bytes(self, path: str, payload: bytes) -> None:
        rule = self._write_rule(path)
        if isinstance(rule, _TornWrite):
            cut = int(len(payload) * rule.frac)
            with open(path, "wb") as f:
                f.write(payload[:cut])
                f.flush()
                os.fsync(f.fileno())
            self.injected["torn"] += 1
            raise InjectedWriteError(
                f"injected torn write at {cut}/{len(payload)} bytes: "
                f"{os.path.basename(path)}"
            )
        with open(path, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        if isinstance(rule, _FlipBytes):
            self.injected["flip"] += 1
            corrupt_file(path, n_flips=rule.n_flips, rng=self.rng)

    def save_array(self, path, arr):
        self.writes += 1
        buf = io.BytesIO()
        np.save(buf, arr)
        self._write_bytes(path, buf.getvalue())

    def write_text(self, path, text):
        self.writes += 1
        self._write_bytes(path, text.encode())

    def replace(self, src, dst):
        self.inner.replace(src, dst)


@contextmanager
def install(injector: FaultInjector):
    """Swap ``store.FILE_IO`` for ``injector`` within the block."""
    prev = _store.FILE_IO
    _store.FILE_IO = injector
    try:
        yield injector
    finally:
        _store.FILE_IO = prev


# -- solver-fault seam (repro_torch.kernels.ops.SOLVER_FAULTS) ------------


class InjectedDispatchError(RuntimeError):
    """The injected launch failure.  A RuntimeError — NOT a corruption
    error — as a failed CUDA launch raises."""


@dataclass
class _NonfiniteSolve(_Rule):
    op: str = "nonfinite"
    problem: int | None = None    # batched: which problem (None = seeded)


@dataclass
class _StalledSolve(_Rule):
    op: str = "stall"
    problem: int | None = None


@dataclass
class _DispatchError(_Rule):
    op: str = "dispatch"


def nonfinite_solve(n: int = 0, *, match: str = "*", times: int = 1,
                    problem: int | None = None) -> _Rule:
    """Matching solve calls ``n .. n+times-1`` report a NaN objective
    (batched calls poison ``problem``, or a seeded index when None) —
    what a diverged fused kernel looks like to `observe_result_health`."""
    return _NonfiniteSolve(match=match, n=n, times=times, problem=problem)


def stalled_solve(n: int = 0, *, match: str = "*", times: int = 1,
                  problem: int | None = None) -> _Rule:
    """Matching solve calls return ``sweeps == max_sweeps`` — a solve that
    burned its whole budget without converging."""
    return _StalledSolve(match=match, n=n, times=times, problem=problem)


def dispatch_error(n: int = 0, *, match: str = "*", times: int = 1) -> _Rule:
    """Matching calls raise InjectedDispatchError BEFORE any device work —
    a lost device or a failed launch, as far as the caller can tell."""
    return _DispatchError(match=match, n=n, times=times)


class SolverFaultInjector:
    """An ``ops.SOLVER_FAULTS`` occupant applying a deterministic schedule
    of solver faults.  ``before(site)`` may raise a dispatch error;
    ``after(site, out, max_sweeps=...)`` perturbs the returned
    ``(X, obj, sweeps, history)`` tuple (single or batched) in place of
    the real kernel result."""

    def __init__(self, *rules: _Rule, seed: int = 0):
        self.rules = list(rules)
        self.rng = np.random.default_rng(seed)
        self.calls: dict[str, int] = {}
        self.injected: dict[str, int] = {
            "nonfinite": 0, "stall": 0, "dispatch": 0,
        }

    def before(self, site: str) -> None:
        self.calls[site] = self.calls.get(site, 0) + 1
        for r in self.rules:
            if r.op == "dispatch" and r._due(site):
                self.injected["dispatch"] += 1
                raise InjectedDispatchError(
                    f"injected dispatch failure at {site}"
                )

    def after(self, site: str, out, *, max_sweeps: int):
        X, obj, sweeps, hist = out
        for r in self.rules:
            if r.op not in ("nonfinite", "stall") or not r._due(site):
                continue
            # clone on the results' own device: no host round trip
            obj = torch.as_tensor(obj).clone()
            sweeps = torch.as_tensor(sweeps).clone()
            if obj.dim() == 0:         # single solve
                if r.op == "nonfinite":
                    obj.fill_(float("nan"))
                else:
                    sweeps.fill_(max_sweeps)
            else:                      # batched: poison one problem
                b = r.problem
                if b is None:
                    b = int(self.rng.integers(0, obj.shape[0]))
                if r.op == "nonfinite":
                    obj[b] = float("nan")
                else:
                    sweeps[b] = max_sweeps
            self.injected[r.op] += 1
            out = (X, obj, sweeps, hist)
        return out


@contextmanager
def install_solver(injector: SolverFaultInjector):
    """Swap ``repro_torch.kernels.ops.SOLVER_FAULTS`` for ``injector``
    within the block."""
    from ..kernels import ops as _ops

    prev = _ops.SOLVER_FAULTS
    _ops.SOLVER_FAULTS = injector
    try:
        yield injector
    finally:
        _ops.SOLVER_FAULTS = prev


# -- on-disk damage helpers (no seam needed) ------------------------------

_HEADER_SPARE = 128   # keep the npy/json header parseable; hit the payload


def corrupt_file(path: str, *, n_flips: int = 4, seed: int = 0,
                 rng=None) -> None:
    """Flip ``n_flips`` seeded payload bytes in place — simulated bit rot
    that only checksum verification (not np.load) can catch."""
    rng = np.random.default_rng(seed) if rng is None else rng
    size = os.path.getsize(path)
    lo = min(_HEADER_SPARE, max(size - 1, 0) // 2)
    with open(path, "r+b") as f:
        for off in rng.integers(lo, size, size=n_flips):
            f.seek(int(off))
            b = f.read(1)
            f.seek(int(off))
            f.write(bytes([b[0] ^ 0xA5]))


def truncate_file(path: str, *, frac: float = 0.5) -> None:
    """Cut a file to the leading ``frac`` — simulated torn write / partial
    copy that np.load reports as a short mmap."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(int(size * frac))
