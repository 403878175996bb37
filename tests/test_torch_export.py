"""The port's telemetry exporter (``repro_torch.obs.export``) against the
reference's (``repro.obs.export``) on the CPU.

The same registry contents, made from a seed with numpy, are recorded into
a registry of each package; the two exporters must render byte-equal
``/metrics`` text and equal ``/varz`` JSON, both as methods and over HTTP
on an ephemeral 127.0.0.1 port (no network).  Tolerance: exact — the
instruments hold the same Python floats and both render them with the
same stdlib calls.  The wall clock is pinned while the exporters sample,
so the timestamps agree too.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.obs import export as jexport
from repro.obs import health as jhealth
from repro.obs import metrics as jmetrics
from repro_torch.obs import export as texport
from repro_torch.obs import health as thealth
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace


def _fill(reg, seed: int) -> None:
    """Seeded contents over every instrument type, with the launchers'
    names (dotted, so the Prometheus renaming is exercised)."""
    rng = np.random.default_rng(seed)
    for name in ("ingest.chunks", "solver.launches", "kernel.launches.gram",
                 "ingest.prefetch.consumer_stall_s", "0bad.name"):
        reg.counter(name).inc(float(rng.integers(0, 50)))
        if rng.random() < 0.5:
            reg.counter(name).inc(float(rng.random()))
    for name in ("serve.queue_depth", "serve.drift.triggered"):
        reg.gauge(name).set(float(rng.random()))
    reg.histogram("serve.latency_s").observe_many(
        rng.exponential(0.01, size=int(rng.integers(1, 300))).tolist())
    reg.histogram("solver.sweeps").observe_many(
        rng.integers(1, 9, size=20).astype(float).tolist())
    reg.histogram("serve.batch_size")          # an empty histogram


def _pair(seed, **kw):
    jreg, treg = jmetrics.Registry(), tmetrics.Registry()
    _fill(jreg, seed)
    _fill(treg, seed)
    return (jexport.TelemetryExporter(jreg, **kw),
            texport.TelemetryExporter(treg, **kw))


def _get(port, path):
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                   timeout=10)
        return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


@pytest.fixture()
def pinned_clock(monkeypatch):
    """time.time() stands at 1000.0 for both modules (they share it)."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_metrics_text_is_byte_equal(seed):
    jexp, texp = _pair(seed)
    text = texp.prometheus_text()
    assert text == jexp.prometheus_text()
    assert "kernel_launches_gram_total" in text
    assert "_0bad_name_total" in text
    assert 'serve_latency_s{quantile="0.99"}' in text


@pytest.mark.parametrize("name", ["serve.latency_s", "kernel.launches.gram",
                                  "0bad", "a-b c", "", "_ok"])
def test_prom_name_matches_reference(name):
    assert texport._prom_name(name) == jexport._prom_name(name)


@pytest.mark.parametrize("v", [5.0, 0.25, -3, 1e-300, 2**60, float("nan"),
                               float("inf"), float("-inf"), True, 7])
def test_prom_num_matches_reference(v):
    assert texport._prom_num(v) == jexport._prom_num(v)


@pytest.mark.parametrize("seed", [0, 1])
def test_varz_and_delta_samples_are_equal(seed, pinned_clock):
    rules = dict(rules=jhealth.default_rules())
    jexp = jexport.TelemetryExporter(jmetrics.Registry(), **rules)
    texp = texport.TelemetryExporter(
        tmetrics.Registry(), rules=thealth.default_rules())
    for _ in range(3):                     # three intervals of new data
        _fill(jexp.registry, seed)
        _fill(texp.registry, seed)
        js = jexp.sample_now()
        ts = texp.sample_now()
        assert ts == js
    assert texp.varz() == jexp.varz()
    assert texp.health().to_dict() == jexp.health().to_dict()


def test_http_endpoints_serve_the_same_bodies(pinned_clock):
    jexp, texp = _pair(5, interval_s=3600.0, port=0,
                       extra={"run": "parity"})
    with jexp, texp:
        assert texp.port and texp.port != jexp.port
        for path in ("/metrics", "/varz", "/healthz", "/tracez", "/nope"):
            jcode, jtype, jbody = _get(jexp.port, path)
            tcode, ttype, tbody = _get(texp.port, path)
            assert (tcode, ttype) == (jcode, jtype), path
            if path == "/varz":
                tv, jv = json.loads(tbody), json.loads(jbody)
                assert tv == jv and tv["labels"] == {"run": "parity"}
            else:
                assert tbody == jbody, path
        assert tcode == 404
    assert texp.port is None                 # socket closed at stop


def test_healthz_flips_to_503_when_a_critical_rule_fires():
    treg = tmetrics.Registry()
    with texport.TelemetryExporter(treg, interval_s=3600.0, port=0,
                                   rules=thealth.solver_rules()) as texp:
        code, _, body = _get(texp.port, "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        treg.counter("solver.nonfinite").inc()
        texp.sample_now()
        code, _, body = _get(texp.port, "/healthz")
        assert code == 503
        assert json.loads(body)["firing"][0]["rule"] == "solver_nonfinite"


def test_jsonl_sink_records_equal_series(tmp_path, pinned_clock):
    paths = [str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")]
    exps = [mod.TelemetryExporter(reg, interval_s=3600.0, jsonl_path=p,
                                  extra={"run": "x"})
            for mod, reg, p in ((jexport, jmetrics.Registry(), paths[0]),
                                (texport, tmetrics.Registry(), paths[1]))]
    for e in exps:
        e.registry.counter("ingest.chunks").inc(3)
        e.start()                            # baseline
        e.registry.counter("ingest.chunks").inc(2)
        e.sample_now()
    for e in exps:
        e.stop()                             # final flush
    j, t = ([json.loads(ln) for ln in open(p)] for p in paths)
    assert t == j and len(t) == 3
    assert [r["metrics"]["ingest.chunks"]["delta"] for r in t] == [3.0, 2.0,
                                                                    0.0]
    assert t[0]["t_unix_s"] == 1000.0


def test_tracez_renders_the_ports_tracer_and_providers_join_varz():
    texp = texport.TelemetryExporter(tmetrics.Registry())
    assert texp.tracez().startswith("(no tracer installed")
    with ttrace.enable():
        with ttrace.span("ingest.megabatch", kind="gram_launches"):
            pass
        assert "ingest.megabatch" in texp.tracez()
    texp.add_snapshot_provider("ok", lambda: {"depth": 2})
    texp.add_snapshot_provider("dead", lambda: 1 / 0)
    v = texp.varz()
    assert v["ok"] == {"depth": 2}
    assert v["dead"]["error"].startswith("ZeroDivisionError")
