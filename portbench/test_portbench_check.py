"""The check that decides ``correct``, driven end to end on the CPU at a
tiny size: a sound run passes it, and a run with a fault planted under
the timed path, or with the control (the reference one precision lower)
in the program's place, fails it.  Each run is a child interpreter, so
that what the run loads is its own (the check refuses a run in which the
JAX stack or the JAX package is loaded)."""
import json
import subprocess
import sys

import pytest

from portbench.harness import ROOT

CHILD = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
from portbench import control, harness
name, fault, mode, corpora = {name!r}, {fault!r}, {mode!r}, {corpora!r}
c = harness.cell(name)
c.traffic = dict(c.traffic, batch_evals={batch_evals!r})
c.config["corpus"].update(n_docs=500, n_words=800)
# two components: the second one's search takes three evaluations here
c.config["fit"].update(components=2, lam_search_evals=3)
if mode == "control":
    r = control.readings(c, 11, 0.2, torch.device("cpu"), corpora=corpora)
    out = {{"control": r["control"], "program": r["program"],
           "limits": c.limits}}
else:
    line = harness.run_cell(c, seed=2**31 + 11, seconds=0.2, trace=False,
                            device="cpu", fault=fault)
    out = dict(line, loaded=harness.forbidden_loaded())
print(json.dumps(out))
"""

FAULTS = ["state_unchanged", "half_batch", "answer_altered", "search_stopped"]


def _run(name, fault=None, mode="run", corpora=False, batch_evals=0):
    code = CHILD.format(root=str(ROOT), src=str(ROOT / "src"), name=name,
                        fault=fault, mode=mode, corpora=corpora,
                        batch_evals=batch_evals)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(ROOT))


def _child(name, fault=None, mode="run", corpora=False, batch_evals=0):
    p = _run(name, fault, mode, corpora, batch_evals)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("batch_evals", [0, 4])
def test_sound_run_is_correct_and_loads_no_jax(batch_evals):
    """The cell's sequential search, and a mix of batched search rounds
    (whose check leaves out the sequential search's `search_off`)."""
    line = _child("nyt-fit", batch_evals=batch_evals)
    assert ("search_off" in line["checks"]) == (batch_evals == 0)
    assert line["loaded"] == []
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-2:] == ["checks", "loaded"]
    for ch in line["checks"].values():
        assert ch["value"] <= ch["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_makes_the_run_incorrect(fault):
    """At this size every fault leaves a result, and it reads ``correct``
    false: a fault whose hook crashed would print no result and fail
    here, not pass."""
    line = _child("nyt-fit", fault)
    assert line["loaded"] == []
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("corpora", [False, True])
def test_control_fails_a_number_the_program_passes(corpora):
    r = _child("nyt-fit", mode="control", corpora=corpora)
    over = [k for k, v in r["control"].items() if v > r["limits"][k]]
    assert over, r
    for k in over:
        assert r["program"][k] <= r["limits"][k]
