"""The port's fault-tolerant trainer (``repro_torch.train.Trainer``):

- the reference's ``test_trainer_resume_exact``
  (``tests/test_checkpoint.py``): 8 uninterrupted steps equal 5 steps, a
  stop, and 3 resumed steps, rtol 1e-6, atol 1e-7;
- checkpoints cross packages both ways: the reference's `Trainer`
  checkpoints step 5 and the port's resumes it to step 8, and the
  reverse; each against the reference's own 8-step run with the
  train-step tolerances (``tests/test_torch_train_parity.py``);
- a SIGTERM delivered during a step checkpoints after that step, adds a
  ``preempted`` event, stops, and restores the previous handler;
- a step that sleeps adds a ``straggler`` event (the EWMA rule, never in
  the first three steps of a run);
- ``history`` keeps every step's loss and time, the logged steps' equal
  to their ``metrics`` events;
- ``tests/test_system.py``'s ``test_lm_training_reduces_loss``: the loss
  falls below ln V - 1 within 60 steps.
"""
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import (  # few_threads: an autouse fixture
    MOMENT_TOL, few_threads, param_errors,
)
from repro.configs.base import ModelConfig as JModelConfig
from repro.data import PipelineConfig as JPipeCfg, TokenPipeline as JPipe
from repro.models import build_model as jbuild
from repro.train import (
    Trainer as JTrainer, TrainerConfig as JTrainerConfig,
    init_state as jinit, make_train_step as jmake_step,
)
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import train_state_to_reference
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.testing.lm_train_record import flatten
from repro_torch.train import (
    Trainer, TrainerConfig, init_state, make_train_step,
)

TINY = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=128,
            dtypes=("float32", "float32"))


def _port(seed=0):
    model = build_model(ModelConfig(**TINY), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return model, make_train_step(model)


def _pipe():
    return TokenPipeline(PipelineConfig(vocab_size=128, batch=4, seq_len=16))


def _params(state):
    return dict(flatten(train_state_to_reference(state).params))


def test_trainer_resume_exact(tmp_path):
    """Uninterrupted 8-step run == (5 steps, crash, resume, 3 steps)."""
    pipe = _pipe()
    model, step = _port()
    s_cont = init_state(model)
    for t in range(8):
        s_cont, _ = step(s_cont, {"tokens": torch.as_tensor(
            pipe.batch_at(t))})
    want = _params(s_cont)

    d1 = str(tmp_path / "interrupted")
    model, step = _port()
    tr1 = Trainer(step, pipe, TrainerConfig(total_steps=5, ckpt_every=5,
                                            ckpt_dir=d1, log_every=100))
    tr1.run(init_state(model))
    model, step = _port(seed=1)                    # this init is discarded
    tr2 = Trainer(step, pipe, TrainerConfig(total_steps=8, ckpt_every=100,
                                            ckpt_dir=d1, log_every=100))
    s_res = tr2.run(init_state(model))

    assert [e["kind"] for e in tr2.events] == ["resume", "checkpoint"]
    assert tr2.events[0]["step"] == 5 and int(s_res.step) == 8
    assert int(s_res.opt.count) == 8
    got = _params(s_res)
    for k, a in want.items():
        np.testing.assert_allclose(got[k], a, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # the state's params are the model's own, updated in place
    assert s_res.params["embed"] is model.embed


def _reference_run(ckpt_dir, total, init_key=0):
    m = jbuild(JModelConfig(**TINY))
    step = jax.jit(jmake_step(m))
    pipe = JPipe(JPipeCfg(vocab_size=128, batch=4, seq_len=16))
    tr = JTrainer(step, pipe, JTrainerConfig(
        total_steps=total, ckpt_every=5, ckpt_dir=ckpt_dir, log_every=100))
    state = tr.run(jinit(m, jax.random.PRNGKey(init_key)))
    return tr, jax.tree.map(np.asarray, state)


def _np_state(state):
    return {"params": dict(flatten(state.params)),
            "mu": dict(flatten(state.opt.mu)),
            "nu": dict(flatten(state.opt.nu))}


def _port_run(ckpt_dir, total):
    model, step = _port(seed=1)
    tr = Trainer(step, _pipe(), TrainerConfig(
        total_steps=total, ckpt_every=5, ckpt_dir=ckpt_dir, log_every=100))
    return tr, tr.run(init_state(model))


@pytest.fixture(scope="module")
def reference_8(tmp_path_factory):
    _, state = _reference_run(str(tmp_path_factory.mktemp("ref8")), 8)
    return _np_state(state)


def _assert_matches(got, want):
    par = param_errors(got, want, [0.0, *(3e-4 * float(warmup_cosine(s))
                                          for s in range(1, 8))])
    assert par["params_abs"] < 1e-6 and par["small_grad_abs"] <= par["bound"], \
        par
    for kind in ("mu", "nu"):
        for p, a in want[kind].items():
            err = np.abs(got[kind][p] - a).max() / max(np.abs(a).max(), 1e-30)
            assert err < MOMENT_TOL * (2 if kind == "nu" else 1), (kind, p)


def test_reference_checkpoint_resumes_in_the_port(tmp_path, reference_8):
    d = str(tmp_path / "ck")
    _reference_run(d, 5)                       # the reference writes step 5
    tr, state = _port_run(d, 8)
    assert [e["kind"] for e in tr.events] == ["resume", "checkpoint"]
    assert tr.events[0]["step"] == 5 and int(state.step) == 8
    s = train_state_to_reference(state)
    assert int(s.opt.count) == 8
    _assert_matches(_np_state(s), reference_8)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, reference_8):
    d = str(tmp_path / "ck")
    model, step = _port()
    # the port's first 5 steps from the reference's PRNGKey(0) weights
    from repro_torch.convert import lm_params_from_reference
    jm = jbuild(JModelConfig(**TINY))
    lm_params_from_reference(
        model, jax.tree.map(np.asarray, jinit(jm, jax.random.PRNGKey(0))
                            .params))
    Trainer(step, _pipe(), TrainerConfig(
        total_steps=5, ckpt_every=5, ckpt_dir=d, log_every=100)).run(
        init_state(model))
    tr, state = _reference_run(d, 8, init_key=1)
    assert [e["kind"] for e in tr.events] == ["resume", "checkpoint"]
    assert tr.events[0]["step"] == 5 and int(state.step) == 8
    _assert_matches(_np_state(state), reference_8)


class _Signalling:
    """A train step that delivers SIGTERM to this process during step
    ``at``."""

    def __init__(self, step, at):
        self.step, self.at, self.model = step, at, step.model
        self.calls = 0

    def __call__(self, state, batch):
        if self.calls == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        self.calls += 1
        return self.step(state, batch)


def test_sigterm_checkpoints_after_the_step_and_stops(tmp_path):
    model, step = _port()
    previous = signal.getsignal(signal.SIGTERM)
    tr = Trainer(_Signalling(step, 2), _pipe(), TrainerConfig(
        total_steps=10, ckpt_every=100, ckpt_dir=str(tmp_path),
        log_every=100))
    state = tr.run(init_state(model))
    assert [(e["kind"], e["step"]) for e in tr.events] == [
        ("metrics", 0), ("checkpoint", 3), ("preempted", 3)]
    assert int(state.step) == 3
    assert sorted(os.listdir(tmp_path)) == ["step_000000003"]
    assert signal.getsignal(signal.SIGTERM) is previous
    # run again: it resumes at 3 and finishes
    model, step = _port()
    tr = Trainer(step, _pipe(), TrainerConfig(
        total_steps=5, ckpt_every=100, ckpt_dir=str(tmp_path),
        log_every=100))
    assert int(tr.run(init_state(model)).step) == 5
    assert tr.events[0] == {**tr.events[0], "kind": "resume", "step": 3}


def test_slow_step_is_a_straggler(tmp_path):
    """The EWMA rule on a step whose time is set by the test (a sleep,
    not the model's arithmetic, whose time varies with the load on the
    host): 0.1 s a step, 3 s at step 5."""
    model, step = _port()

    def sleeping(state, batch):
        time.sleep(3.0 if int(state.step) == 5 else 0.1)
        return state._replace(step=state.step + 1), {
            "loss": torch.zeros(())}

    sleeping.model = model
    tr = Trainer(sleeping, _pipe(), TrainerConfig(
        total_steps=7, ckpt_every=100, ckpt_dir=str(tmp_path),
        log_every=100))
    tr.run(init_state(model))
    strag = [e for e in tr.events if e["kind"] == "straggler"]
    assert [e["step"] for e in strag] == [5]
    assert strag[0]["step_time"] > 3.0 * strag[0]["ewma"]
    assert set(strag[0]) == {"kind", "time", "step", "step_time", "ewma"}
    # never in the first three steps of a run
    model, _ = _port()
    tr = Trainer(sleeping, _pipe(), TrainerConfig(
        total_steps=7, ckpt_every=100, ckpt_dir=str(tmp_path / "b"),
        log_every=100))
    state = init_state(model)
    tr.run(state._replace(step=state.step + 3))  # step 5 is its third
    assert not [e for e in tr.events if e["kind"] == "straggler"]


def test_history_keeps_every_step(tmp_path):
    model, step = _port()
    tr = Trainer(step, _pipe(), TrainerConfig(
        total_steps=5, ckpt_every=100, ckpt_dir=str(tmp_path), log_every=2))
    tr.run(init_state(model))
    assert [h[0] for h in tr.history] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(h[1]) and h[2] > 0 for h in tr.history)
    logged = [(e["step"], e["loss"], e["step_time"]) for e in tr.events
              if e["kind"] == "metrics"]
    assert logged == [tr.history[i] for i in (0, 2, 4)]


def test_lm_training_reduces_loss():
    """Small LM on the structured synthetic stream: loss must drop well
    below the uniform baseline ln(V)."""
    cfg = ModelConfig(name="lm", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                      dtypes=("float32", "float32"))
    m = build_model(cfg, device="cpu")
    pipe = TokenPipeline(PipelineConfig(vocab_size=512, batch=16, seq_len=64))
    state = init_state(m)
    step = make_train_step(
        m, AdamWConfig(lr=3e-3),
        schedule=lambda s: warmup_cosine(s, warmup=10, total=200))
    losses = []
    for t in range(60):
        state, metrics = step(state, {"tokens": torch.as_tensor(
            pipe.batch_at(t))})
        losses.append(float(metrics["loss"]))
    assert losses[-1] < np.log(512) - 1.0, losses[-5:]
    assert losses[-1] < losses[0]
