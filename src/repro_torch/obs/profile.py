"""Profiler hooks: line host spans up with device traces.

Port of ``repro.obs.profile``.  The dispatch sites in `kernels.ops` are
annotated with `torch.profiler.record_function` (a region in the
`torch.profiler` trace) plus an NVTX range (a region for CUDA-side
tools), so the device trace reads next to the `obs.trace` host spans.

Everything here is a NO-OP until `enable()` is called (or a device trace
is started through `trace_device`): the dispatch wrappers are on hot
paths and must cost one module-global check when profiling is off.
``torch`` is imported lazily so the module stays importable (and inert)
anywhere the stdlib is.
"""
from __future__ import annotations

import contextlib

_enabled = False


def enable(on: bool = True) -> None:
    """Turn annotation emission on/off process-wide."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def _region(name: str):
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def annotate(name: str, **kwargs):
    """Host-side profiler region around a dispatch site: a
    `record_function` + NVTX range when enabled, a free no-op otherwise.
    ``kwargs`` are accepted for call-site parity with the reference and
    ignored (neither torch region takes attributes)."""
    if not _enabled:
        return contextlib.nullcontext()
    return _region(name)


def named_scope(name: str):
    """Scope for code inside a device program.  PyTorch runs eagerly, so
    this is the same region as `annotate`."""
    return annotate(name)


@contextlib.contextmanager
def trace_device(log_dir: str | None):
    """``with profile.trace_device(dir):`` — run a `torch.profiler` trace
    (CPU + CUDA activities) over the block and write it as Chrome
    trace-event JSON into ``log_dir``, enabling the dispatch annotations
    for its duration.  ``None`` is a no-op, so callers can pass an
    optional CLI flag straight through."""
    if not log_dir:
        yield
        return
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prev = _enabled
    enable(True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        enable(prev)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
