"""Live telemetry: background exporter + stdlib HTTP endpoints (port of
``repro.obs.export``).

Every subsystem records into `obs.metrics` / `obs.trace`; without an
exporter the only way out is a JSONL line and a Chrome trace after the
run, of no use for a serve process that runs for days or a Gram pass
that streams for hours.  `TelemetryExporter` runs one background thread
that, every ``interval_s``:

  1. takes a **delta-aware sample** of the registry — counters report the
     interval delta and rate, gauges their current value, histograms the
     percentiles of the samples observed *during the interval* (plus
     lifetime count/sum) — via `Histogram.window_samples` + the lifetime
     count, so instruments carry no exporter state;
  2. feeds the sample to a `HealthEngine` (`obs.health`) whose verdict
     backs ``/healthz``;
  3. appends one timestamped JSONL record (``--metrics`` becomes a time
     *series*, not a run summary).

and serves four endpoints on a ``ThreadingHTTPServer`` (stdlib only):

  /metrics   Prometheus text exposition v0.0.4 of every instrument
             (counters as ``_total``, histograms as summaries)
  /healthz   200 while ok/degraded, 503 when a critical rule fires;
             body is the JSON `HealthStatus`
  /varz      current registry snapshot + registered snapshot providers
             (batcher/prefetch state) + health, as JSON
  /tracez    the active tracer's ring of recently completed spans,
             rendered with the span-tree formatter (text/plain)

Nothing here runs unless an exporter is constructed and started: no
thread, no socket, zero per-instrumentation-site overhead (the fast paths
pay only their one global read).  ``stop()`` (or
the context manager) joins the thread, closes the socket, and flushes one
final sample so even a short run's JSONL holds a complete series.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import metrics as metrics_mod
from . import trace as trace_mod
from .health import HealthEngine, HealthStatus
from .metrics import Counter, Gauge, Histogram, Registry, percentile_of

#: Cap on raw interval samples forwarded to the health engine per
#: histogram per interval — percentile aspects need samples, but an
#: unbounded burst must not balloon the engine's history.
_MAX_RULE_SAMPLES = 1024


def _prom_name(name: str) -> str:
    """Dotted registry name -> Prometheus metric name."""
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    if not s or not (s[0].isalpha() or s[0] == "_"):
        s = "_" + s
    return s


def _prom_num(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if not float(f).is_integer() else repr(int(f))


class _DeltaTracker:
    """Per-instrument previous-sample state: counter values and histogram
    lifetime counts, keyed by instrument *identity* (a registry swapped in
    by tests starts from scratch)."""

    def __init__(self):
        self._prev_counter: dict[int, float] = {}
        self._prev_hist_count: dict[int, int] = {}

    def sample(self, reg: Registry, dt_s: float) -> dict:
        out: dict[str, dict] = {}
        for name in reg.names():
            inst = reg.get(name)
            if isinstance(inst, Counter):
                v = float(inst.value)
                prev = self._prev_counter.get(id(inst), 0.0)
                self._prev_counter[id(inst)] = v
                delta = v - prev
                out[name] = {
                    "type": "counter", "value": v, "delta": delta,
                    "rate": delta / dt_s if dt_s > 0 else 0.0, "dt_s": dt_s,
                }
            elif isinstance(inst, Gauge):
                out[name] = {"type": "gauge", "value": float(inst.value)}
            elif isinstance(inst, Histogram):
                count = inst.count
                prev = self._prev_hist_count.get(id(inst), 0)
                self._prev_hist_count[id(inst)] = count
                new = count - prev
                window = inst.window_samples()
                # the tail of the window is exactly the interval's samples
                # unless the window overflowed, in which case the newest
                # window-full is the best available evidence
                tail = window[-new:] if 0 < new <= len(window) else (
                    window if new > len(window) else [])
                out[name] = {
                    "type": "histogram",
                    "count": count, "sum": float(inst.total),
                    "count_delta": new, "dt_s": dt_s,
                    "p50": percentile_of(tail, 50),
                    "p99": percentile_of(tail, 99),
                    "max": max(tail) if tail else 0.0,
                    "mean": sum(tail) / len(tail) if tail else 0.0,
                    "samples": tail[-_MAX_RULE_SAMPLES:],
                }
        return out


def _jsonl_record(sample: dict) -> dict:
    """The persisted form of a delta sample: everything except the raw
    histogram sample lists (bounded disk growth per interval)."""
    slim = {}
    for name, rec in sample.items():
        rec = dict(rec)
        rec.pop("samples", None)
        slim[name] = rec
    return slim


class TelemetryExporter:
    """Background delta-snapshot loop + optional HTTP endpoints.

    Args:
      registry: the registry to export (default: the process registry *at
        construction time* — tests pass their `use_registry` instance).
      interval_s: sampling cadence.
      port: None = no HTTP server; 0 = bind an ephemeral port (read
        ``.port`` after ``start()``); otherwise the literal port.
      host: bind address for the HTTP server.
      jsonl_path: append one timestamped delta record per interval.
      rules: `HealthRule` iterable for the `HealthEngine` behind /healthz.
      extra: constant keys merged into every JSONL record (run labels).

    ``start()`` takes an immediate baseline sample (so the first interval
    has a meaningful delta), ``stop()`` flushes a final one — a run that
    lives a single interval still produces a >= 2-point series.
    """

    def __init__(self, registry: Registry | None = None, *,
                 interval_s: float = 5.0, port: int | None = None,
                 host: str = "127.0.0.1", jsonl_path: str | None = None,
                 rules=(), extra: dict | None = None):
        self.registry = registry if registry is not None \
            else metrics_mod.get_registry()
        self.interval_s = float(interval_s)
        self.jsonl_path = jsonl_path
        self.extra = dict(extra or {})
        self.engine = HealthEngine(rules)
        self.samples_taken = 0
        self._req_port = port
        self._host = host
        self._tracker = _DeltaTracker()
        self._providers: dict[str, object] = {}
        self._lock = threading.Lock()
        self._latest_sample: dict = {}
        self._latest_t = 0.0
        self._prev_t: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._server: ThreadingHTTPServer | None = None
        self._server_thread: threading.Thread | None = None

    # ------------------------------------------------------------ providers
    def add_snapshot_provider(self, name: str, fn) -> None:
        """Register a zero-arg callable whose dict return joins ``/varz``
        (the batcher's ``snapshot()``, a store handle's stats, ...)."""
        self._providers[name] = fn

    # ------------------------------------------------------------- sampling
    def sample_now(self) -> dict:
        """Take one delta sample, run the health rules, persist the JSONL
        record.  Called by the loop; callable directly for tests."""
        t = time.time()
        with self._lock:
            dt = (t - self._prev_t) if self._prev_t is not None \
                else self.interval_s
            self._prev_t = t
            sample = self._tracker.sample(self.registry, max(dt, 1e-9))
            self.engine.evaluate(sample, t)
            self._latest_sample = sample
            self._latest_t = t
            self.samples_taken += 1
        if self.jsonl_path:
            rec = {"t_unix_s": t, "interval_s": dt,
                   "health": self.engine.last.status,
                   "metrics": _jsonl_record(sample)}
            rec.update(self.extra)
            with open(self.jsonl_path, "a") as f:
                json.dump(rec, f, sort_keys=True)
                f.write("\n")
        return sample

    def health(self) -> HealthStatus:
        return self.engine.last

    def latest(self) -> tuple[float, dict]:
        with self._lock:
            return self._latest_t, self._latest_sample

    # ------------------------------------------------------------ rendering
    def prometheus_text(self) -> str:
        """The registry as Prometheus text exposition format v0.0.4."""
        lines: list[str] = []
        reg = self.registry
        for name in reg.names():
            inst = reg.get(name)
            pn = _prom_name(name)
            if isinstance(inst, Counter):
                lines.append(f"# TYPE {pn}_total counter")
                lines.append(f"{pn}_total {_prom_num(inst.value)}")
            elif isinstance(inst, Gauge):
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {_prom_num(inst.value)}")
            elif isinstance(inst, Histogram):
                lines.append(f"# TYPE {pn} summary")
                lines.append(
                    f'{pn}{{quantile="0.5"}} {_prom_num(inst.percentile(50))}')
                lines.append(
                    f'{pn}{{quantile="0.99"}} {_prom_num(inst.percentile(99))}')
                lines.append(f"{pn}_sum {_prom_num(inst.total)}")
                lines.append(f"{pn}_count {_prom_num(inst.count)}")
        return "\n".join(lines) + "\n"

    def varz(self) -> dict:
        t, sample = self.latest()
        out = {
            "t_unix_s": t or time.time(),
            "health": self.engine.last.to_dict(),
            "metrics": self.registry.snapshot(),
            "sample": _jsonl_record(sample),
        }
        for name, fn in list(self._providers.items()):
            try:
                out[name] = fn()
            except Exception as e:   # a dead provider must not kill /varz
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        if self.extra:
            out["labels"] = dict(self.extra)
        return out

    def tracez(self) -> str:
        tracer = trace_mod.active()
        if tracer is None:
            return "(no tracer installed — run with --trace)\n"
        return tracer.recent_str() + "\n"

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int | None:
        """The bound HTTP port (resolves 0 -> the ephemeral port)."""
        return self._server.server_address[1] if self._server else None

    def start(self) -> "TelemetryExporter":
        assert self._thread is None, "exporter already started"
        if self._req_port is not None:
            self._server = ThreadingHTTPServer(
                (self._host, self._req_port), _make_handler(self))
            self._server.daemon_threads = True
            self._server_thread = threading.Thread(
                target=self._server.serve_forever, name="telemetry-http",
                daemon=True)
            self._server_thread.start()
        self.sample_now()                       # baseline for the deltas
        self._thread = threading.Thread(
            target=self._loop, name="telemetry-exporter", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_now()
            except Exception:       # sampling must never kill the process
                pass

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10)
        self._thread = None
        try:
            self.sample_now()                   # final flush
        except Exception:
            pass
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            if self._server_thread is not None:
                self._server_thread.join(timeout=10)
            self._server = None
            self._server_thread = None

    def __enter__(self) -> "TelemetryExporter":
        return self.start() if self._thread is None else self

    def __exit__(self, *exc) -> None:
        self.stop()


def _make_handler(exporter: TelemetryExporter):
    class Handler(BaseHTTPRequestHandler):
        server_version = "repro-telemetry/1.0"

        def log_message(self, *args):           # silence per-request stderr
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):                       # noqa: N802 (stdlib API)
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    self._send(
                        200, exporter.prometheus_text().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    hs = exporter.health()
                    self._send(hs.http_status,
                               json.dumps(hs.to_dict()).encode(),
                               "application/json")
                elif path == "/varz":
                    self._send(200, json.dumps(
                        exporter.varz(), sort_keys=True, default=repr,
                    ).encode(), "application/json")
                elif path == "/tracez":
                    self._send(200, exporter.tracez().encode(),
                               "text/plain; charset=utf-8")
                else:
                    self._send(404, b"not found: try /metrics /healthz "
                               b"/varz /tracez\n", "text/plain")
            except BrokenPipeError:             # client went away mid-write
                pass
            except Exception as e:
                try:
                    self._send(500, f"{type(e).__name__}: {e}\n".encode(),
                               "text/plain")
                except Exception:
                    pass

    return Handler
