"""The benchmark's frame: finds a cell's configuration, traffic mix,
limits and per-layer metrics by name, runs its driver through set-up,
warm-up, the measured window and the check, and prints the result line.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by the name `BENCHMARK.json` gives it:

  portbench/configs/<config>.json      the deployment (a corpus law, the fit)
  portbench/traffic/<traffic>.json     a mix: ``driver`` names the generator
  portbench/drivers/<driver>.py        the general generator of a kind of mix
  portbench/limits/<workload>.json     the check's limits for one cell, or
  portbench/limits/<driver>.json       those of every cell of a driver
  portbench/metrics/<metric>.py        a per-layer metric's reader

A per-layer reader is a module with ``read(t) -> float | None`` over the
traced window's `Traced` record; None leaves the metric out of the line.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = ROOT / "src"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    """The cell asks for more cards than this machine has."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload with what it names, loaded from the benchmark's files."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def cell(name: str, bench: dict | None = None, *, base: Path = HERE) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench or read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = read_json(base / "configs" / f"{entry['config']}.json")
    traffic = read_json(base / "traffic" / f"{entry['traffic']}.json")
    own = base / "limits" / f"{name}.json"
    limits = read_json(own if own.exists()
                       else base / "limits" / f"{traffic['driver']}.json")

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name, entry, config, traffic, limits,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that the benchmark refuses: the
    JAX stack and the JAX package (a whole-name match, so the port's
    ``repro_torch`` is not among them)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def use_checkout_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


@dataclass
class Traced:
    """What a per-layer reader may read of the traced window: the
    profiler's events (``events``; ``device`` the kernels and copies) and
    the window's bounds in their microseconds, the program's span tracer
    and metrics registry, the kernel launches the benchmark recorded, and
    the traffic driver's run (``run``) with its own records."""

    run: object
    events: list
    device: list
    lo: float
    hi: float
    tracer: object
    registry: object
    launches: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6


class Tracing:
    """The traced window: the program's span tracer and metrics registry,
    the dispatch annotations, a `torch.profiler` session over host and
    device, and a record of every K1 launch's shapes and outputs
    (read after the window: nothing here waits for the card)."""

    def __init__(self):
        self.launches = {"k1": []}
        self._undo = []

    def _wrap(self, module, attr, record):
        orig = getattr(module, attr)

        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            record(a, kw, out)
            return out

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, orig))

    def __enter__(self):
        import torch
        from repro_torch.kernels import bcd_fused
        from repro_torch.obs import metrics, profile, trace

        def k1(a, kw, out):
            Sigma3, _, scal = a[:3]
            self.launches["k1"].append(dict(
                itemsize=Sigma3.element_size(), n_pad=int(Sigma3.shape[-1]),
                n_valid=scal[:, 2], meta=out[2], qp_sweeps=kw["qp_sweeps"],
                tau_iters=kw["tau_iters"]))

        self._wrap(bcd_fused, "launch", k1)
        self._k1_count = bcd_fused.launches
        self.registry = metrics.reset()
        self.tracer = trace.install(trace.Tracer())
        profile.enable(True)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._window = torch.profiler.record_function("portbench.window")
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        from repro_torch.obs import profile, trace

        self._window.__exit__(None, None, None)
        torch.cuda.synchronize()
        self.prof.stop()
        trace.install(None)
        profile.enable(False)
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        from repro_torch.kernels import bcd_fused

        self.launches["k1_counted"] = bcd_fused.launches - self._k1_count
        return False

    def reduce(self, run) -> Traced:
        from . import yardstick as ys

        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            events = ys.load_trace(path)
        finally:
            os.unlink(path)
        lo, hi = ys.window_of(events, ys.WINDOW)
        return Traced(run=run, events=events, device=ys.device_events(events),
                      lo=lo, hi=hi, tracer=self.tracer,
                      registry=self.registry, launches=self.launches)


def annotate(name: str, on: bool):
    """A profiler region around a call of the benchmark's, in traced runs."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(c: Cell, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             fault: str | None = None) -> dict:
    """One run of cell ``c``: set-up, warm-up, ``seconds`` of measured
    window (traced when ``trace``), the check; returns the result line.
    ``fault`` plants one of the traffic driver's faults under the timed path
    (the check's own tests use it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    dev = torch.device(device)
    chips = int(c.entry.get("chips", 1))
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < chips):
        raise NoCard(f"{c.name} needs {chips} CUDA card(s); this machine has "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    driver = load_module(HERE / "drivers" / f"{c.driver}.py",
                         f"portbench_driver_{c.driver}")
    run = driver.Run(c, seed=seed, device=dev, fault=fault)
    run.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run.warm(trace=trace)
    # what set-up made stays: the collector need not walk it in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    tracing = Tracing() if trace else None
    with tracing or contextlib.nullcontext():
        e2e = run.window(seconds, trace=trace)
    info = device_info(dev, chips)
    metrics: dict = {}
    breakdown = None
    if trace:
        t = tracing.reduce(run)
        from . import yardstick as ys

        busy = ys.busy_us(t.device, t.lo, t.hi) / 1e6
        info.update(busy_s=busy, window_s=t.window_s)
        for m in c.per_layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{m['name']}")
            v = reader.read(t)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": ys.top_ops(t.device, t.lo, t.hi),
                     "idle_gaps": ys.idle_gaps(t.events, t.device, t.lo, t.hi)}
        del t
    else:
        e2e["setup_s"] = setup_s
        for m in c.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    bad = forbidden_loaded()
    if bad:
        raise ImportError("modules of the JAX stack or the JAX package are "
                          f"loaded: {', '.join(bad)}")
    run.release()
    checks = run.check()
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def print_line(line: dict) -> None:
    """The compared numbers with their limits as the last lines on
    standard error, then the result as the last line on standard out."""
    sys.stdout.flush()
    for k, ch in line["checks"].items():
        print(f"check {k} = {ch['value']!r} (limit {ch['limit']!r})",
              file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
