"""The port's training launcher (``repro_torch.launch.train``) against the
reference's, with the same flags: ``--arch qwen2-0.5b --smoke --steps 6
--batch 2 --seq 16`` (``--device cpu`` for the port).

The two launchers draw their weights from different generators, so each
case first writes the reference's ``PRNGKey(0)`` training state as a
step-0 checkpoint into both checkpoint directories; each launcher resumes
it, so both train from the same weights on the same batches.  Then:

- the same event kinds at the same steps, and ``final step 6``;
- float32 dtypes (the smoke config's dtypes replaced in both launchers):
  the losses within 1e-5 relative, and the step-6 checkpoints'
  parameters within 1e-6 absolute and moments within 1e-5 of each leaf's
  largest (2e-5 for ``nu``), with byte-identical manifests;
- the smoke config's own dtypes (float32 parameters, bfloat16 compute):
  the losses within 1e-3 relative (a quarter of a bfloat16 ulp; the two
  libraries round bfloat16 intermediates at different points) and the
  parameters within 5e-4 absolute.  Six steps in the schedule's warmup
  move a parameter by at most ~5e-5, so that bound alone would pass an
  optimizer that did nothing: each leaf's update (step-6 parameters less
  step-0's) is also held to the reference's update, within 0.1 of its
  norm, so a missing or wrong update (relative error 1 or more) fails.
  The one exception is the attention key bias ``bk``: a softmax over
  keys cancels its gradient but for RoPE's rotation, so its gradient is
  small beside the bfloat16 rounding of the others and its update is
  held within 0.75 of its norm.

Both launchers log every step here (``log_every`` 1 in their trainer
configs, 10 in the launchers), so the losses of all six steps are
compared, not step 0's alone, which is a forward pass before any update.

Without a checkpoint the launchers give the same event kinds and steps.
``straggler`` events are left out of every comparison: the trainer's
watchdog adds one where a step takes 3x the running mean of the step
times, which the load on the host decides, not the code.
The reference launcher runs in a child interpreter with ``XLA_FLAGS``
removed (``repro.launch.dryrun``, imported by other test files, sets it
to 512 host devices).  ``--mesh`` wider than the lanes there are is
refused, naming ``REPRO_TORCH_FORCE_LANES``
(``tests/test_torch_sharded_train.py`` runs the meshes).
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from test_torch_train_parity import few_threads  # an autouse fixture

from repro.checkpoint import checkpoint as jck
from repro.configs import get_smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro.train import init_state as jinit
from repro_torch import device
from repro_torch.launch import train as ttrain

REPO = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "6", "--batch", "2",
        "--seq", "16"]
F32 = ("float32", "float32")


def _reference(ckpt_dir, f32, every_step=False):
    prog = textwrap.dedent(f"""
        import sys
        from repro.launch import train
        if {every_step}:
            config = train.TrainerConfig
            train.TrainerConfig = lambda **kw: config(
                **{{**kw, "log_every": 1}})
        if {f32}:
            smoke = train.get_smoke_config
            train.get_smoke_config = lambda a: smoke(a).scaled(
                dtypes=("float32", "float32"))
        sys.argv = ["train", *sys.argv[1:]]
        train.main()
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", prog, *ARGS, "--ckpt-dir",
                        ckpt_dir], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


def _port(ckpt_dir, f32, monkeypatch, capsys, every_step=False):
    if every_step:
        config = ttrain.TrainerConfig
        monkeypatch.setattr(ttrain, "TrainerConfig", lambda **kw: config(
            **{**kw, "log_every": 1}))
    if f32:
        smoke = ttrain.get_smoke_config
        monkeypatch.setattr(ttrain, "get_smoke_config",
                            lambda a: smoke(a).scaled(dtypes=F32))
    capsys.readouterr()
    ttrain.main([*ARGS, "--device", "cpu", "--ckpt-dir", ckpt_dir])
    return capsys.readouterr().out


def _events(out):
    """The launcher's events; ``straggler`` events, which a step's wall
    time alone decides, are left out: in a process that has run a train
    step before, step 0 takes ~16 ms, so a step of ~50 ms on a loaded
    host adds one to one launcher's events and not the other's."""
    lines = out.strip().splitlines()
    assert lines[-1] == "final step 6", lines[-1]
    events = (ast.literal_eval(line) for line in lines[:-1])
    return [e for e in events if e["kind"] != "straggler"]


def _npz(d, step=6):
    with np.load(os.path.join(d, f"step_{step:09d}", "host_00000.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("f32", [True, False], ids=["float32", "bfloat16"])
def test_launcher_matches_reference_from_one_checkpoint(tmp_path, f32,
                                                        monkeypatch, capsys):
    cfg = jsmoke("qwen2-0.5b")
    cfg = cfg.scaled(dtypes=F32) if f32 else cfg
    state = jinit(jbuild(cfg), jax.random.PRNGKey(0))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    for d in (ref_dir, port_dir):
        jck.save(d, 0, state)
    jev = _events(_reference(ref_dir, f32, every_step=True))
    tev = _events(_port(port_dir, f32, monkeypatch, capsys, every_step=True))
    assert [(e["kind"], e["step"]) for e in tev] == \
        [(e["kind"], e["step"]) for e in jev] == \
        [("resume", 0), *(("metrics", s) for s in range(6)),
         ("checkpoint", 6)]
    rtol = 1e-5 if f32 else 1e-3
    for t, j in zip(tev, jev):
        assert set(t) == set(j)
        if "loss" in j:
            assert abs(t["loss"] - j["loss"]) <= rtol * abs(j["loss"]), \
                (j["step"], t["loss"], j["loss"])
    manifest = "step_000000006/manifest.json"
    assert json.load(open(os.path.join(ref_dir, manifest))) == \
        json.load(open(os.path.join(port_dir, manifest)))
    got, want, start = _npz(port_dir), _npz(ref_dir), _npz(ref_dir, 0)
    assert list(got) == list(want)
    for k, a in want.items():
        diff = np.abs(got[k].astype(np.float64) - a)
        if k.startswith(".params/"):
            assert diff.max() < (1e-6 if f32 else 5e-4), k
            if not f32:
                ref_upd = a.astype(np.float64) - start[k]
                err = np.linalg.norm(got[k] - start[k] - ref_upd)
                bound = 0.75 if k.endswith("/bk") else 0.1
                assert err < bound * np.linalg.norm(ref_upd), k
        elif f32 and k.startswith(".opt/.mu/"):
            assert diff.max() < 1e-5 * np.abs(a).max(), k
        elif f32 and k.startswith(".opt/.nu/"):
            assert diff.max() < 2e-5 * np.abs(a).max(), k
        elif k in (".opt/.count", ".step"):
            assert int(got[k]) == int(a) == 6


def test_launcher_events_match_reference_without_checkpoint(
        tmp_path, monkeypatch, capsys):
    jev = _events(_reference(str(tmp_path / "ref"), False))
    tev = _events(_port(str(tmp_path / "port"), False, monkeypatch, capsys))
    assert [(e["kind"], e["step"]) for e in tev] == \
        [(e["kind"], e["step"]) for e in jev] == \
        [("metrics", 0), ("checkpoint", 6)]
    assert [set(e) for e in tev] == [set(e) for e in jev]


def test_launcher_refuses_a_mesh_and_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_FORCE_LANES", raising=False)
    with pytest.raises(RuntimeError, match="REPRO_TORCH_FORCE_LANES=2"):
        ttrain.main([*ARGS, "--device", "cpu", "--mesh", "2x1",
                     "--ckpt-dir", str(tmp_path)])
    monkeypatch.setattr(device.torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.DeviceUnavailable):
        ttrain.main([*ARGS, "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
