"""Hierarchical span tracer — the host-side timeline of a whole fit.

One `Tracer` holds a forest of nestable spans (screen pass -> megabatch
dispatches, lambda search -> per-eval / batched-round solves, serve
batches ...), each with monotonic wall time (`time.perf_counter_ns`),
attached attributes, and an optional *device-sync boundary*: a span that
ends right after a `torch.cuda.synchronize()` measures completed device work,
not just async dispatch.

Instrumentation sites call the module-level `span(...)` helper, which is a
shared no-op singleton until a tracer is installed (`install` /
`enable()` context manager) — the hot paths pay one global read and a
``None`` check when tracing is off.  Span stacks are per-thread (the serve
microbatcher and the ingest prefetcher run worker threads), so spans
opened on another thread become roots on that thread's own timeline
rather than corrupting the caller's stack.

Exports:

  to_chrome_trace() / dump_chrome_trace(path)
      Chrome trace-event JSON (``{"traceEvents": [...]}``, complete "X"
      events in microseconds) — loadable in Perfetto / chrome://tracing.
  tree() / tree_str()
      the span forest as nested dicts / a human-readable tree with
      per-span total and *self* time (total minus the children's totals).

Zero required dependencies: stdlib only; ``torch`` is imported lazily and
only for the optional sync boundary.  Port of ``repro.obs.trace``: the
only change is `device_sync`, which synchronises the CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque


class Span:
    """One timed region.  ``t0``/``t1`` are perf_counter_ns ticks."""

    __slots__ = ("name", "attrs", "t0", "t1", "children", "tid", "root")

    def __init__(self, name: str, attrs: dict, tid: str):
        self.name = name
        self.attrs = attrs
        self.tid = tid
        self.t0 = time.perf_counter_ns()
        self.t1: int | None = None
        self.children: list[Span] = []
        self.root = False

    # ------------------------------------------------------------- timings
    @property
    def total_s(self) -> float:
        end = self.t1 if self.t1 is not None else time.perf_counter_ns()
        return (end - self.t0) / 1e9

    @property
    def self_s(self) -> float:
        return self.total_s - sum(c.total_s for c in self.children)


class _SpanCtx:
    """Context manager binding one span to one tracer; re-entrant safe
    because each ``span()`` call creates a fresh instance."""

    __slots__ = ("_tracer", "_span", "_sync")

    def __init__(self, tracer: "Tracer", span: Span, sync):
        self._tracer = tracer
        self._span = span
        self._sync = sync

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._sync is not None:
            device_sync(self._sync)
        self._tracer._close(self._span)
        return False


class _NullSpan:
    """Shared no-op: what `span(...)` returns when no tracer is installed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    # mirror the Span surface instrumentation sites touch
    attrs: dict = {}

    def __setattr__(self, k, v):  # pragma: no cover - attrs is read-only
        raise AttributeError("the null span is immutable")


_NULL = _NullSpan()


class Tracer:
    """Collects a forest of spans across threads.

    Thread model: each OS thread owns a span *stack* (``threading.local``);
    a span opened while another is active on the same thread nests under
    it, a span opened on a fresh thread becomes a root tagged with that
    thread's name.  The roots list is append-only under one lock.

    Completed-span ring: the newest ``keep_recent`` *root* spans to close
    (with their full subtree) are kept in a bounded deque, so a live
    observer — the telemetry exporter's ``/tracez`` endpoint — can render
    recently finished work on a long-lived process without the unbounded
    ``_roots`` list being the only view (that list keeps every root for
    the end-of-run Chrome export; the ring is the "what just happened"
    window).
    """

    def __init__(self, *, keep_recent: int = 64):
        self._roots: list[Span] = []
        self._recent: deque = deque(maxlen=int(keep_recent))
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t_origin = time.perf_counter_ns()

    # ------------------------------------------------------------- spans
    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, *, sync=None, **attrs) -> _SpanCtx:
        """Open a nested span.  ``sync=x`` makes the close a device-sync
        boundary: `device_sync` (``torch.cuda.synchronize()``) runs before the end
        timestamp is taken."""
        sp = Span(name, attrs, threading.current_thread().name)
        st = self._stack()
        if st:
            st[-1].children.append(sp)
        else:
            sp.root = True
            with self._lock:
                self._roots.append(sp)
        st.append(sp)
        return _SpanCtx(self, sp, sync)

    def _close(self, sp: Span) -> None:
        sp.t1 = time.perf_counter_ns()
        st = self._stack()
        # Close out-of-order defensively (a leaked child span must not
        # wedge the whole thread's stack).
        while st and st[-1] is not sp:
            st.pop()
        if st:
            st.pop()
        if sp.root:
            with self._lock:
                self._recent.append(sp)

    # ------------------------------------------------------------ queries
    def roots(self) -> list[Span]:
        with self._lock:
            return list(self._roots)

    def find(self, name: str) -> list[Span]:
        """All spans with ``name``, depth-first."""
        out: list[Span] = []

        def rec(sp: Span):
            if sp.name == name:
                out.append(sp)
            for c in sp.children:
                rec(c)

        for r in self.roots():
            rec(r)
        return out

    # ------------------------------------------------------------ exports
    def to_chrome_trace(self) -> dict:
        """Trace-event JSON: complete ("ph": "X") events, microsecond
        timestamps relative to tracer creation, one Perfetto track per
        originating thread."""
        events: list[dict] = []
        pid = os.getpid()
        tids: dict[str, int] = {}

        def tid_of(name: str) -> int:
            if name not in tids:
                tids[name] = len(tids)
                events.append({
                    "ph": "M", "pid": pid, "tid": tids[name],
                    "name": "thread_name", "args": {"name": name},
                })
            return tids[name]

        def rec(sp: Span):
            end = sp.t1 if sp.t1 is not None else time.perf_counter_ns()
            events.append({
                "ph": "X",
                "name": sp.name,
                "cat": sp.name.split(".", 1)[0],
                "pid": pid,
                "tid": tid_of(sp.tid),
                "ts": (sp.t0 - self._t_origin) / 1e3,
                "dur": (end - sp.t0) / 1e3,
                "args": {k: _jsonable(v) for k, v in sp.attrs.items()},
            })
            for c in sp.children:
                rec(c)

        for r in self.roots():
            rec(r)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")
        return path

    def tree(self) -> list[dict]:
        """The span forest as nested dicts (schema round-trip target)."""

        def rec(sp: Span) -> dict:
            return {
                "name": sp.name,
                "total_s": sp.total_s,
                "self_s": sp.self_s,
                "attrs": {k: _jsonable(v) for k, v in sp.attrs.items()},
                "children": [rec(c) for c in sp.children],
            }

        return [rec(r) for r in self.roots()]

    def tree_str(self, *, min_s: float = 0.0) -> str:
        """Human-readable span tree with per-span total/self time."""
        return _render_tree(self.roots(), min_s=min_s)

    # -------------------------------------------------- completed-span ring
    def recent(self, n: int | None = None) -> list[Span]:
        """The newest completed root spans (oldest first, up to ``n``)."""
        with self._lock:
            spans = list(self._recent)
        return spans if n is None else spans[-int(n):]

    def recent_str(self, *, limit: int = 20, min_s: float = 0.0) -> str:
        """The completed-span ring rendered as the human tree — what the
        exporter's ``/tracez`` endpoint serves on a long-lived process."""
        spans = self.recent(limit)
        if not spans:
            return "(no completed spans yet)"
        return _render_tree(spans, min_s=min_s)


def _render_tree(roots: list[Span], *, min_s: float = 0.0) -> str:
    lines: list[str] = []

    def rec(sp: Span, depth: int):
        if sp.total_s < min_s:
            return
        attrs = " ".join(f"{k}={_jsonable(v)}" for k, v in sp.attrs.items())
        lines.append(
            f"{'  ' * depth}{sp.name:<{max(1, 40 - 2 * depth)}} "
            f"total={sp.total_s * 1e3:9.2f}ms self={sp.self_s * 1e3:9.2f}ms"
            + (f"  [{attrs}]" if attrs else "")
        )
        for c in sp.children:
            rec(c, depth + 1)

    for r in roots:
        rec(r, 0)
    return "\n".join(lines)


def _jsonable(v):
    """Attribute values must survive json.dump: numpy / torch scalars are
    coerced, anything exotic falls back to repr."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:
        return v.item()          # numpy / torch zero-dim scalar
    except (AttributeError, ValueError):
        pass
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return repr(v)


# ---------------------------------------------------------------------------
# Module-level active tracer: the instrumentation entry points.
# ---------------------------------------------------------------------------

_active: Tracer | None = None


def install(tracer: Tracer | None) -> Tracer | None:
    """Install ``tracer`` as the process-wide active tracer (None turns
    tracing off).  Returns the tracer for chaining."""
    global _active
    _active = tracer
    return tracer


def active() -> Tracer | None:
    return _active


@contextlib.contextmanager
def enable(tracer: Tracer | None = None):
    """``with trace.enable() as t:`` — install a (fresh) tracer for the
    block, restore the previous one after."""
    prev = _active
    t = tracer if tracer is not None else Tracer()
    install(t)
    try:
        yield t
    finally:
        install(prev)


def span(name: str, *, sync=None, **attrs):
    """Open a span on the active tracer — the shared no-op when tracing is
    off, so instrumentation sites cost one global read on the fast path."""
    t = _active
    if t is None:
        return _NULL
    return t.span(name, sync=sync, **attrs)


def device_sync(x):
    """Block until the device work producing ``x`` (a tensor, or a tuple or
    list of them) lands — but only while a tracer is active and a CUDA
    tensor is among them, so span ends mark real device completion
    without taxing untraced runs.  Returns ``x``."""
    if _active is not None:
        for t in x if isinstance(x, (tuple, list)) else (x,):
            if getattr(t, "is_cuda", False):
                import torch

                torch.cuda.synchronize(t.device)
                break
    return x
