"""The harness finds everything by name, and BENCHMARK.json keeps to the
benchmark's contract (CPU, no card needed)."""
import json
import re
import shutil
import sys
import types

import pytest

from portbench import harness
from portbench.harness import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "portbench/")
        assert 1 <= len(c["source"]) <= 200
        assert c["name"] in {w["config"] for w in b["workloads"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for w in cells:
        c = harness.cell(w, b)
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer
        for m in c.per_layer:
            assert any(e["name"] == m["moves"] for e in c.end_to_end)
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_config_mix_and_metric_added_as_files_are_found(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    (base / "configs" / "tiny.json").write_text(json.dumps(
        {"corpus": {"n_docs": 10}, "fit": {}}))
    (base / "traffic" / "batched.json").write_text(json.dumps(
        {"driver": "fit", "batch_evals": 4}))
    (base / "limits" / "tiny-batched.json").write_text(json.dumps(
        {"gram_rel": 0.5}))
    (base / "metrics" / "answer.py").write_text(
        "def read(t):\n    return 42.0 if t else None\n")
    b = _bench()
    b["configs"].append({"name": "tiny", "source": "x",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "tiny-batched", "config": "tiny",
                           "traffic": "batched", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "answer", "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "driver",
                           "moves": "fits_per_min",
                           "workloads": ["tiny-batched"]})
    b["end_to_end"].append({"name": "fits_per_min", "unit": "fits/min",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["tiny-batched"]})
    c = harness.cell("tiny-batched", b, base=base)
    assert c.config["corpus"] == {"n_docs": 10}
    assert c.driver == "fit" and c.traffic["batch_evals"] == 4
    assert c.limits == {"gram_rel": 0.5}
    assert [m["name"] for m in c.per_layer] == ["answer"]
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "fits_per_min"]
    reader = harness.load_module(base / "metrics" / "answer.py", "pb_answer")
    assert reader.read(object()) == 42.0 and reader.read(None) is None
    # a cell without limits of its own takes its driver's
    assert harness.cell("nyt-fit", b, base=base).limits == json.loads(
        (HERE / "limits" / "fit.json").read_text())
    with pytest.raises(KeyError):
        harness.cell("no-such-cell", b, base=base)


def test_every_metric_reader_loads_and_reads_nothing_from_an_empty_trace():
    empty = harness.Traced(
        run=types.SimpleNamespace(fits=[], attempted=0, bag=None),
        events=[], device=[], lo=0.0, hi=0.0,
        tracer=types.SimpleNamespace(find=lambda name: []),
        registry=types.SimpleNamespace(get=lambda name: None),
        launches={"k1": []})
    for path in sorted((HERE / "metrics").glob("*.py")):
        reader = harness.load_module(path, f"pb_metric_{path.stem}")
        assert reader.read(empty) is None, path.name


def test_import_check_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", types.ModuleType("x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert harness.forbidden_loaded() == ["jax", "repro"]


def test_harness_sources_import_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|repro)\b",
                     re.M)
    for path in HERE.rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        assert not pat.search(path.read_text()), path
