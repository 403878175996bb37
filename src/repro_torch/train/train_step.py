"""Train / serve step factories (port of ``repro.train.train_step``).

`make_train_step(model, opt_cfg, microbatches=, schedule=)` builds
   (state, batch) -> (state, metrics)
with optional microbatch gradient accumulation: the reference's
``lax.scan`` over microbatches is a loop here that adds the gradients,
the loss and the metrics in the same order, from float32 zeros, then
scales them by ``1 / microbatches``.  The state's ``params`` is the
model's own parameter tree (`LM.params`): the AdamW step writes it in
place, then drops the model's compute-dtype copy (`refresh`), so a later
serve or eval step runs on the new weights.

`make_serve_step(model)` builds the one-token greedy decode step;
`make_prefill_step(model)` the forward-only prefill step.  The model owns
its parameters, so these steps take none.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..optim import adamw
from ..optim.adamw import AdamWConfig, OptState
from ..optim.schedule import warmup_cosine

F32 = torch.float32
_METRICS = ("ce", "moe_lb_loss", "moe_z_loss")


class TrainState(NamedTuple):
    params: object              # the model's parameter tree (LM.params())
    opt: OptState
    step: torch.Tensor          # 0-d int32, on the CPU


def init_state(model) -> TrainState:
    """The model's parameters (drawn when it was built), zero moments,
    step 0."""
    params = model.params()
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32))


def _split_microbatches(batch, k: int):
    return {name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))
            for name, x in batch.items()}


def _to_device(batch, device):
    """The batch's arrays as tensors on ``device``, tokens as int64."""
    out = {}
    for name, x in batch.items():
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        x = x.to(device)
        out[name] = x.long() if name == "tokens" else x
    return out


def make_train_step(model, opt_cfg: AdamWConfig = AdamWConfig(), *,
                    microbatches: int = 1, schedule=None):
    """The train step of ``model``; the returned function carries the
    model as ``.model`` (the trainer restores checkpoints into it)."""
    sched = schedule or (lambda s: warmup_cosine(s))

    def grads_of(leaves, batch):
        with torch.enable_grad():
            loss, metrics = model.loss(batch)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p, dtype=F32) if g is None else g
              for p, g in zip(leaves, gs)]
        return loss.detach(), {k: metrics[k].detach() for k in _METRICS}, gs

    def train_step(state: TrainState, batch):
        leaves = list(adamw._leaves(state.params))
        batch = _to_device(batch, model.device)
        if microbatches == 1:
            loss, metrics, grads = grads_of(leaves, batch)
        else:
            mbs = _split_microbatches(batch, microbatches)
            dev = model.device
            acc_g = [torch.zeros(p.shape, dtype=F32, device=dev)
                     for p in leaves]
            acc_l = torch.zeros((), dtype=F32, device=dev)
            acc_m = {k: torch.zeros((), dtype=F32, device=dev)
                     for k in _METRICS}
            for i in range(microbatches):
                l, m, g = grads_of(leaves, {k: v[i] for k, v in mbs.items()})
                acc_g = [a + gi for a, gi in zip(acc_g, g)]
                acc_l = acc_l + l
                acc_m = {k: acc_m[k] + m[k] for k in _METRICS}
            inv = 1.0 / microbatches
            grads = [g * inv for g in acc_g]
            loss = acc_l * inv
            metrics = {k: v * inv for k, v in acc_m.items()}

        _, new_opt, om = adamw.update(grads, state.opt, state.params,
                                      opt_cfg, lr_scale=sched(state.step))
        model.refresh()
        new_state = TrainState(params=state.params, opt=new_opt,
                               step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **om}

    train_step.model = model
    return train_step


def make_serve_step(model):
    @torch.no_grad()
    def serve_step(cache, last_tokens):
        """Greedy one-token decode. last_tokens: (B, 1) integers.  Returns
        (cache, next tokens (B, 1)); ties go to the first maximum."""
        logits, cache = model.decode_step(cache, last_tokens)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        return cache, nxt

    return serve_step


def make_prefill_step(model):
    """Forward pass only (inference prefill): the greedy next token after
    each sequence."""
    @torch.no_grad()
    def prefill_step(batch):
        logits, _ = model.forward(batch)
        return torch.argmax(logits[:, -1, :], dim=-1)

    return prefill_step
