"""Both launchers (``repro.launch.spca_run`` and its port) on the same
small corpus on the CPU print the same component lines, in the dense mode
and out of core (``--streaming``), where they also print the same pass
economics.

The ``gap=`` field is left out of the comparison: it is the KKT
certificate, which inverts a nearly singular float32 X (see the
conditioning caveat of ``repro.core.validate.kkt_gap``), so two LU
implementations give different gaps for the same X.
"""
import re
import sys

import pytest

from repro.launch import spca_run as jrun
from repro_torch.launch import spca_run as trun

ARGS = ["--docs", "2000", "--words", "3000", "--components", "2"]


def _pc_lines(text):
    lines = text.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if ln.startswith("PC"):
            out.append(re.sub(r" gap=\S+", "", ln))
            out.append(lines[i + 1])
    return out


def test_launchers_print_the_same_components(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["spca_run", *ARGS])
    jrun.main()
    want = _pc_lines(capsys.readouterr().out)
    trun.main([*ARGS, "--device", "cpu"])
    got = _pc_lines(capsys.readouterr().out)
    assert len(want) == 4
    assert got == want


def test_launcher_devices_agrees_with_reference(monkeypatch, capsys,
                                               tmp_path):
    """``--devices 2`` on two forced lanes: the reference launcher's
    components (it runs on its one device, as it says), each pass in
    ceil(11/2) = 6 dispatches, 1 + 1 passes."""
    from repro_torch.launch.mesh import FORCE_LANES_ENV

    args = [*ARGS[:-1], "3", "--streaming", "--chunk-nnz", "2048",
            "--devices", "2"]
    monkeypatch.setattr(sys, "argv", ["spca_run", *args, "--store-dir",
                                      str(tmp_path / "ref")])
    jrun.main()
    jout = capsys.readouterr().out
    monkeypatch.setenv(FORCE_LANES_ENV, "2")
    _, _, diag = trun.main([*args, "--device", "cpu", "--store-dir",
                            str(tmp_path / "port")])
    tout = capsys.readouterr().out
    assert "sharding passes across 2 lane(s)" in tout
    assert len(_pc_lines(jout)) == 6
    assert _pc_lines(tout) == _pc_lines(jout)
    assert diag["corpus_passes"] == 2
    ing = diag["ingest"]
    assert ing["screen_launches"] == ing["gram_launches"] == 6
    assert ing["chunks"] == 2 * 88


def _ingest_lines(text):
    """The streaming mode's pass-economics lines, without timings/paths."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("corpus passes:"):
            out.append(ln)
        elif "out-of-core variance screen" in ln:
            out.append(re.sub(r"screen: \S+s", "screen:", ln))
        elif "wrote CSR store" in ln:
            out.append(ln.split(" MB at ")[0])
    return out


def test_streaming_launchers_agree(monkeypatch, capsys, tmp_path):
    """Several megabatches per pass and a ragged tail (chunk_nnz 2048 over
    ~175k nnz: 88 chunks, 11 launches a pass at megabatch 8)."""
    args = [*ARGS[:-1], "3", "--streaming", "--chunk-nnz", "2048"]
    monkeypatch.setattr(sys, "argv", ["spca_run", *args, "--store-dir",
                                      str(tmp_path / "ref")])
    jrun.main()
    jout = capsys.readouterr().out
    _, results, diag = trun.main([*args, "--device", "cpu", "--store-dir",
                                  str(tmp_path / "port")])
    tout = capsys.readouterr().out
    assert len(_pc_lines(jout)) == 6
    assert _pc_lines(tout) == _pc_lines(jout)
    assert _ingest_lines(tout) == _ingest_lines(jout)
    assert len(_ingest_lines(tout)) == 3
    assert diag["corpus_passes"] == 2
    ing = diag["ingest"]
    assert ing["screen_launches"] == ing["gram_launches"] == 11
    assert ing["chunks"] == 2 * 88


STREAM = ["--streaming", "--device", "cpu", "--docs", "2000", "--words",
          "3000", "--components", "2"]


def _supports(results):
    return [r.support.tolist() for r in results]


def test_streaming_fit_killed_by_a_read_fault_resumes(tmp_path, capsys):
    """The launcher with ``--store-dir S --resume R``, killed by an injected
    read fault in its Gram pass (no retries), then run again: the second
    run resumes the finished screen pass from its checkpoint, prints
    "resumed N megabatch(es)" with N > 0, streams only the Gram pass, and
    gives the supports of an uninterrupted run (and its lambdas and
    variances, exactly: the same arithmetic in the same order)."""
    from repro_torch.testing import (
        FaultInjector, fail_nth_read, install, slow_read)

    args = STREAM + ["--store-dir", str(tmp_path / "S"), "--resume",
                     str(tmp_path / "R"), "--checkpoint-every", "1",
                     "--io-retries", "0"]
    # each pass reads each shard's values file once (this store has one
    # shard): the second such read is the Gram pass's first
    probe = FaultInjector(slow_read(0.0, match="*.values.npy"))
    with install(probe):
        _, clean, d0 = trun.main(args[:-6])
    assert probe.injected["slow"] == 2
    kill = FaultInjector(fail_nth_read(1, match="*.values.npy",
                                       times=10**9))
    capsys.readouterr()
    with install(kill), pytest.raises(OSError, match="injected"):
        trun.main(args)
    assert kill.injected["read_fail"] == 1
    _, resumed, d1 = trun.main(args)
    out = capsys.readouterr().out
    m = re.search(r"resumed (\d+) megabatch\(es\)", out)
    assert m and int(m.group(1)) > 0, out
    assert "reliability: resumed" in out
    assert d1["ingest"]["chunks"] < d0["ingest"]["chunks"]
    assert d1["resumed_megabatches"] == int(m.group(1))
    assert _supports(resumed) == _supports(clean)
    assert [(r.lam, r.variance) for r in resumed] \
        == [(r.lam, r.variance) for r in clean]


def test_export_port_serves_metrics_and_healthz(capsys):
    import json
    import urllib.request

    seen = {}

    def scrape(exp):
        for path in ("/metrics", "/healthz"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{exp.port}{path}", timeout=10) as r:
                seen[path] = (r.status, r.read().decode())
        seen["exp"] = exp

    from repro_torch.obs import metrics

    with metrics.use_registry():      # the health rules read this run only
        _, results, _ = trun.main([*ARGS, "--device", "cpu", "--export-port",
                                   "0", "--export-interval", "0.05"],
                                  on_exporter=scrape)
    out = capsys.readouterr().out
    assert re.search(r"telemetry: http://127\.0\.0\.1:\d+/", out)
    assert seen["/metrics"][0] == 200 and seen["/healthz"][0] == 200
    assert json.loads(seen["/healthz"][1])["rules_evaluated"] == len(
        seen["exp"].engine.rules) > 0
    # after the fit the exporter's final sample carries the solver counters
    text = seen["exp"].prometheus_text()
    assert re.search(r"^search_evals_total \d+$", text, re.M)
    assert "health: " in out and seen["exp"].port is None
    assert len(results) == 2


def test_deadline_flags_reach_the_fit(tmp_path):
    from repro_torch.obs.health import PassDeadlineError, SolveDeadlineError

    with pytest.raises(SolveDeadlineError):
        trun.main([*ARGS, "--device", "cpu", "--solve-deadline-s", "0"])
    with pytest.raises(PassDeadlineError):
        trun.main([*STREAM, "--pass-deadline-s", "0", "--resume",
                   str(tmp_path / "R")])
