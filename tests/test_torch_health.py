"""The port's health rules and watchdogs (``repro_torch.obs.health``)
against the reference's (``repro.obs.health``) on the CPU.

The same delta-sample stream, made from a seed with numpy, goes through
both `HealthEngine`s; their `HealthStatus.to_dict()` must be equal, key
for key and float for float (tolerance: exact — both engines run the same
stdlib arithmetic on the same Python floats).  Watchdog expiry is typed
and counted in the registry of the package that raised it.
"""
from dataclasses import asdict

import numpy as np
import pytest

from repro.obs import health as jhealth
from repro.obs import metrics as jmetrics
from repro_torch.obs import health as thealth
from repro_torch.obs import metrics as tmetrics

PACKS = ("solver_rules", "serving_rules", "ingestion_rules", "runtime_rules",
         "default_rules")


def _stream(seed: int, n: int = 24):
    """``n`` exporter-style delta samples over every metric the default
    rule packs read, with bursts and NaN-free values drawn from ``seed``:
    counters (value/delta/rate), gauges, histograms (interval samples)."""
    rng = np.random.default_rng(seed)
    counters = ("solver.nonfinite", "solver.stalled", "serve.shed",
                "serve.timeouts", "ingest.retries", "solver.fallbacks",
                "solver.divergence", "watchdog.expired", "mesh.degraded")
    totals = dict.fromkeys(counters, 0.0)
    t = 1000.0
    out = []
    for _ in range(n):
        dt = float(rng.uniform(0.5, 20.0))
        t += dt
        sample = {}
        for name in counters:
            if rng.random() < 0.4:
                continue             # not every metric reports every time
            d = float(rng.poisson(0.3 if rng.random() < 0.8 else 6.0))
            totals[name] += d
            sample[name] = {"type": "counter", "value": totals[name],
                            "delta": d, "rate": d / dt, "dt_s": dt}
        sample["serve.drift.triggered"] = {
            "type": "gauge", "value": float(rng.random() < 0.2)}
        for name, scale in (("serve.latency_s", 0.3),
                            ("ingest.prefetch.occupancy", 1.0)):
            xs = rng.exponential(scale, size=int(rng.integers(0, 30)))
            xs = [float(x) for x in xs]
            sample[name] = {
                "type": "histogram", "count": len(xs), "sum": sum(xs),
                "count_delta": len(xs), "dt_s": dt, "samples": xs}
        out.append((t, sample))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pack", PACKS)
def test_engines_give_equal_verdicts_on_one_stream(pack, seed):
    jeng = jhealth.HealthEngine(getattr(jhealth, pack)())
    teng = thealth.HealthEngine(getattr(thealth, pack)())
    statuses = set()
    for t, sample in _stream(seed):
        j = jeng.evaluate(sample, t)
        got = teng.evaluate(sample, t)
        assert got.to_dict() == j.to_dict()
        assert got.describe() == j.describe()
        assert got.http_status == j.http_status and bool(got) == bool(j)
        statuses.add(got.status)
    assert teng.last.to_dict() == jeng.last.to_dict()
    if pack == "default_rules":
        # the stream drives the engine through more than one verdict
        assert len(statuses) >= 2


@pytest.mark.parametrize("pack", PACKS)
def test_rule_packs_are_the_reference_rules(pack):
    kw = {"serving_rules": dict(p99_latency_s=0.25, shed_per_s=2.0),
          "solver_rules": dict(stall_burst=3.0),
          "ingestion_rules": dict(occupancy_floor=0.5),
          "runtime_rules": dict(fallback_burst=1.0)}.get(pack, {})
    j = [asdict(r) for r in getattr(jhealth, pack)(**kw)]
    t = [asdict(r) for r in getattr(thealth, pack)(**kw)]
    assert t == j and t


@pytest.mark.parametrize("bad", [dict(op="!="), dict(aspect="p75"),
                                 dict(severity="fatal")])
def test_rule_validation_matches_reference(bad):
    kw = dict(name="r", metric="m", op=">", threshold=1.0) | bad
    with pytest.raises(ValueError) as je:
        jhealth.HealthRule(**kw)
    with pytest.raises(ValueError) as te:
        thealth.HealthRule(**kw)
    assert str(te.value) == str(je.value)


def test_missing_metric_does_not_fire_and_window_ages_out():
    eng = thealth.HealthEngine([
        thealth.HealthRule("burst", "c", ">=", 5.0, window_s=10.0,
                           aspect="delta"),
        thealth.HealthRule("r", "never.recorded", ">=", 0.0)])
    for i in range(3):
        hs = eng.evaluate({"c": {"type": "counter", "value": 2.0 * (i + 1),
                                 "delta": 2.0}}, 100.0 + i)
    assert hs.status == "unhealthy" and hs.firing[0].value == 6.0
    assert [f.rule for f in hs.firing] == ["burst"]
    assert eng.evaluate({"c": {"type": "counter", "value": 6.0,
                               "delta": 0.0}}, 200.0).ok


@pytest.mark.parametrize("exc", ["PassDeadlineError", "SolveDeadlineError"])
def test_watchdog_expiry_is_typed_and_counted(exc):
    """An expired watchdog raises its typed subclass with the same fields
    and message in both packages, and counts ``watchdog.expired`` once in
    the registry of the package that raised it."""
    raised = {}
    for h, m in ((jhealth, jmetrics), (thealth, tmetrics)):
        wd = h.Watchdog(2.0, what="gram pass", exc=getattr(h, exc),
                        clock=iter([0.0, 1.5, 5.0]).__next__)
        with m.use_registry() as reg:
            wd.check()                       # 1.5 s: within budget
            with pytest.raises(getattr(h, exc)) as ei:
                wd.check()
            assert reg.value("watchdog.expired") == 1
        e = ei.value
        assert isinstance(e, h.WatchdogTimeout) and isinstance(e, TimeoutError)
        raised[h.__name__] = (str(e), e.what, e.budget_s, e.elapsed_s)
    assert raised["repro_torch.obs.health"] == raised["repro.obs.health"]
    assert raised["repro.obs.health"][1:] == ("gram pass", 2.0, 5.0)


def test_watchdog_within_budget_is_silent():
    wd = thealth.Watchdog(10.0, clock=iter([0.0, 1.0, 2.0]).__next__)
    with tmetrics.use_registry() as reg:
        wd.check()
        assert not wd.expired()
        assert reg.value("watchdog.expired") == 0


def test_runtime_rules_fallbacks_degrade_divergence_is_503():
    eng = thealth.HealthEngine(thealth.runtime_rules(fallback_burst=2.0))
    rec = lambda v: {"type": "counter", "value": v, "delta": v}  # noqa: E731
    st = eng.evaluate({"solver.fallbacks": rec(3.0)}, 100.0)
    assert st.status == "degraded" and st.http_status == 200
    st = eng.evaluate({"watchdog.expired": rec(1.0)}, 900.0)
    assert st.status == "unhealthy" and st.http_status == 503
