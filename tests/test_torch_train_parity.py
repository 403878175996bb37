"""Shared harness of the port's train-step parity tests
(``tests/test_torch_train_step*.py``): the reference's and the port's
train steps from the same ``PRNGKey(0)`` weights on the same batch, and
the comparison with the stated tolerances:

- ``loss``, ``ce``, the MoE terms and ``grad_norm`` of every step within
  ``METRIC_RTOL`` (1e-5) relative, ``lr`` equal;
- after the first step, each first-moment leaf within ``MOMENT_TOL``
  (1e-5) of its largest magnitude, each second-moment leaf within
  ``NU_TOL`` (2e-5: ``nu`` is ``(1 - b2) g^2``, and a square doubles its
  gradient's relative error; jamba's ``ssm_D`` reaches 1.1e-5, where the
  reference itself is 8.7e-6 from a float64 run of the same step);
- after the last step, the parameters within ``PARAM_ATOL`` (1e-6)
  absolute, except where Adam's step is decided by rounding: an element
  whose first moment (the running mean of its gradient, which sets the
  step) is under ``SMALL_GRAD`` (1e-4) of its leaf's largest may move up
  to lr the other way each step, so it may differ by up to 2 x the sum
  of lr; such elements are counted and bounded.

It holds no tests of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro.train import init_state as jinit, make_train_step as jmake_step
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import (
    lm_params_from_reference, train_state_to_reference,
)
from repro_torch.models import build_model
from repro_torch.testing.lm_train_record import (
    MOMENT_TOL, NU_TOL, PARAM_ATOL, SMALL_GRAD, flatten,
)
from repro_torch.train import init_state, make_train_step

F32 = ("float32", "float32")
THREADS = 2
METRIC_RTOL = 1e-5
METRIC_KEYS = ("loss", "ce", "moe_lb_loss", "moe_z_loss", "grad_norm", "lr")


def smoke_batch(cfg, B=2, S=16, seed=0):
    """``tests/test_archs_smoke.py``'s batch, as numpy arrays."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.num_patches:
        b["image_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _state_np(state) -> dict:
    return {"params": dict(flatten(state.params)),
            "mu": dict(flatten(state.opt.mu)),
            "nu": dict(flatten(state.opt.nu)),
            "count": int(np.asarray(state.opt.count)),
            "step": int(np.asarray(state.step))}


def reference_run(arch, steps, *, microbatches=1, batch=None, **overrides):
    """The reference's ``steps`` train steps: (init params as numpy,
    per-step metrics, the state after each step in numpy)."""
    cfg = jsmoke(arch).scaled(dtypes=F32, **overrides)
    model = jbuild(cfg)
    state = jinit(model, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state.params)
    batch = smoke_batch(cfg) if batch is None else batch
    step = jax.jit(jmake_step(model, microbatches=microbatches))
    metrics, states = [], []
    for _ in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_state_np(jax.tree.map(np.asarray, state)))
    return init, metrics, states


def port_model(arch, init, **overrides):
    model = build_model(tsmoke(arch).scaled(dtypes=F32, **overrides),
                        device="cpu")
    return lm_params_from_reference(model, init)


def port_run(arch, init, steps, *, microbatches=1, batch=None, **overrides):
    model = port_model(arch, init, **overrides)
    batch = smoke_batch(model.cfg) if batch is None else batch
    state = init_state(model)
    step = make_train_step(model, microbatches=microbatches)
    metrics, states = [], []
    for _ in range(steps):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_state_np(train_state_to_reference(state)))
    return metrics, states


def metric_errors(got, want) -> dict:
    """Largest relative error of each metric over the steps."""
    out = {}
    for k in METRIC_KEYS:
        if k == "lr":
            assert [m[k] for m in got] == [m[k] for m in want]
            continue
        out[k] = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                     for g, w in zip(got, want))
    return out


def moment_errors(got, want) -> dict:
    return {kind: max(float(np.abs(got[kind][p] - a).max()
                            / max(np.abs(a).max(), 1e-30))
                      for p, a in want[kind].items())
            for kind in ("mu", "nu")}


def param_errors(got, want, lrs) -> dict:
    bound = 2.0 * sum(lrs)
    worst = worst_small = 0.0
    n_small = 0
    for p, a in want["params"].items():
        diff = np.abs(got["params"][p].astype(np.float64) - a)
        mu = np.abs(want["mu"][p])
        small = mu < SMALL_GRAD * mu.max()
        n_small += int(np.count_nonzero(small & (diff > PARAM_ATOL)))
        worst = max(worst, float(diff[~small].max(initial=0.0)))
        worst_small = max(worst_small, float(diff[small].max(initial=0.0)))
    return {"params_abs": worst, "small_grad_abs": worst_small,
            "small_grad_over_atol": n_small, "bound": bound}


def assert_parity(tm, ts, jm, js):
    """The port's (metrics, states) against the reference's."""
    errs = metric_errors(tm, jm)
    assert max(errs.values()) < METRIC_RTOL, errs
    mom = moment_errors(ts[0], js[0])
    assert mom["mu"] < MOMENT_TOL and mom["nu"] < NU_TOL, mom
    par = param_errors(ts[-1], js[-1], [m["lr"] for m in jm])
    assert par["params_abs"] < PARAM_ATOL, par
    assert par["small_grad_abs"] <= par["bound"], par
    assert [s["count"] for s in ts] == [s["count"] for s in js]
    assert [s["step"] for s in ts] == [s["step"] for s in js]
    return {**errs, **mom, **par}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """``THREADS`` intra-op threads for a module's torch work: the tests
    run in several worker processes at once, and a small model's many
    short operations slow down sharply when every worker's threads share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)
