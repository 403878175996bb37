"""The port's train step (``repro_torch.train.make_train_step``) against
the reference's, on the weights of the reference's ``PRNGKey(0)`` carried
across by `lm_params_from_reference` (harness and tolerances:
``tests/test_torch_train_parity.py``):

- one and three steps of five smoke configs in float32 (the other five:
  ``tests/test_torch_train_step_archs.py``);
- ``microbatches=2`` against the reference's ``microbatches=2`` (dense
  and MoE);
- activation checkpointing (``remat="full"``, every config's default)
  against ``remat="none"``: equal losses and gradients;
- ``seq_parallel`` (a sharding annotation in the reference) changes
  nothing;
- after an in-place train step, the model's serve step equals that of a
  fresh model loaded with the updated weights (the step drops the cached
  compute copy).

Each reference model is built and its train step jitted once per module.
"""
import numpy as np
import pytest
import torch

from test_torch_train_parity import (  # few_threads: an autouse fixture
    F32, assert_parity, few_threads, port_run, reference_run, smoke_batch,
)
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import (
    lm_params_from_reference, lm_params_to_reference,
)
from repro_torch.models import build_model
from repro_torch.train import init_state, make_serve_step, make_train_step

ARCHS = ("qwen2-0.5b", "mamba2-130m", "deepseek-moe-16b", "whisper-medium",
         "llava-next-34b")
STEPS = 3


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return request.param, reference_run(request.param, STEPS)


def test_train_steps_match_reference(ref):
    arch, (init, jm, js) = ref
    tm, ts = port_run(arch, init, STEPS)
    assert_parity(tm, ts, jm, js)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-moe-16b"])
def test_microbatches_match_reference(arch):
    cfg = tsmoke(arch).scaled(dtypes=F32)
    batch = smoke_batch(cfg, B=4)
    init, jm, js = reference_run(arch, 2, microbatches=2, batch=batch)
    tm, ts = port_run(arch, init, 2, microbatches=2, batch=batch)
    assert_parity(tm, ts, jm, js)


def _loss_and_grads(model, batch):
    leaves = [p for _, p in sorted(model.named_parameters())]
    with torch.enable_grad():
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "jamba-v0.1-52b"])
def test_remat_changes_no_value(arch, monkeypatch):
    from repro_torch.models import transformer

    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = tsmoke(arch).scaled(dtypes=F32)
    assert cfg.remat == "full"
    batch = {k: torch.from_numpy(v) for k, v in smoke_batch(cfg).items()}
    on = build_model(cfg, device="cpu")
    off = build_model(cfg.scaled(remat="none"), device="cpu")
    off.load_state_dict(on.state_dict())
    l_on, g_on = _loss_and_grads(on, batch)
    n_on = len(calls)
    l_off, g_off = _loss_and_grads(off, batch)
    assert n_on == sum(st.n_periods for st in on.stack_specs) \
        and len(calls) == n_on
    assert torch.equal(l_on, l_off)
    for a, b in zip(g_on, g_off):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():          # no autograd: no checkpointing
        on.loss(batch)
    assert len(calls) == n_on


def test_seq_parallel_changes_nothing():
    cfg = tsmoke("qwen2-0.5b").scaled(dtypes=F32)
    batch = {k: torch.from_numpy(v) for k, v in smoke_batch(cfg).items()}
    out = []
    for sp in (False, True):
        model = build_model(cfg.scaled(seq_parallel=sp), device="cpu")
        state = init_state(model)
        step = make_train_step(model)
        for _ in range(2):
            state, m = step(state, batch)
        out.append((m, [p.detach().clone() for p in model.parameters()]))
    (m0, p0), (m1, p1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def test_serve_step_after_training_uses_the_new_weights():
    cfg = tsmoke("qwen2-0.5b").scaled(dtypes=("float32", "bfloat16"))
    model = build_model(cfg, device="cpu")
    serve = make_serve_step(model)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    cache, _ = serve(model.init_cache(2, 4), tok)      # fills the cache
    assert model._compute is not None
    before = lm_params_to_reference(model)
    state = init_state(model)
    step = make_train_step(model, schedule=lambda s: torch.tensor(1.0))
    batch = {k: torch.from_numpy(v) for k, v in smoke_batch(cfg).items()}
    state, _ = step(state, batch)
    assert model._compute is None
    after = lm_params_to_reference(model)
    assert not np.array_equal(before["embed"], after["embed"])
    fresh = lm_params_from_reference(build_model(cfg, device="cpu"), after)
    got = model.decode_step(model.init_cache(2, 4), tok)[0]
    want = fresh.decode_step(fresh.init_cache(2, 4), tok)[0]
    assert torch.equal(got, want)
    stale = build_model(cfg, device="cpu").decode_step(
        model.init_cache(2, 4), tok)[0]
    assert not torch.equal(got, stale)
