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

Built under ``distributed.use_mesh(mesh)`` with a `launch.mesh.LaneMesh`
of more than one lane, `make_train_step` gives the *sharded* step, the
counterpart of the reference's ``jax.jit(make_train_step(m))`` under
``use_mesh``:

* at rest each lane holds exactly its shards of every parameter and of
  AdamW's ``mu`` and ``nu`` (`distributed.sharding.Sharded`, specs from
  ``param_pspecs`` under the divisibility guard: FSDP rows over ``data``,
  tensor-parallel dims over ``model``); a whole state given to the step
  (``init_state``, a restored checkpoint, a state of another mesh) is
  sharded onto the mesh first, as ``jit``'s ``in_shardings`` place it;
* the batch splits over the batch axes (``pod``, ``data``) in contiguous
  row blocks, one a data group; the rows must divide evenly;
* each data group's first lane gathers the full parameters into a model
  replica on that lane (the given model is group 0's) and runs the loss
  and gradient on its rows, queued on its lane's stream;
* gradients, loss and metrics are pooled over the data groups in lane
  order as the microbatch loop adds them (float32 zeros, add in order, x
  1/D); ``grad_norm`` and the clip scale come once from the pooled
  gradient, in the reference's leaf order;
* each lane runs ``adamw.update`` on its own shards.

So a ``(D, M)`` step equals a one-device step with ``microbatches=D``,
bit for bit.  What it does not do: split the products over ``model``.
XLA's partitioner does that for the reference, from its ``constrain``
hints; here the model lanes shard storage and the optimizer step, not
the forward pass, and each replica holds the whole model while it
computes.  Both are levers for the performance phase (ROADMAP queue 2).

`make_serve_step(model)` builds the one-token greedy decode step;
`make_prefill_step(model)` the forward-only prefill step.  The model owns
its parameters, so these steps take none.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from ..distributed import sharding
from ..launch.mesh import LaneMesh, lane_context, sync_lanes
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


def _grads_of(model, leaves, batch):
    with torch.enable_grad():
        loss, metrics = model.loss(batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(p, dtype=F32) if g is None else g
          for p, g in zip(leaves, gs)]
    return loss.detach(), {k: metrics[k].detach() for k in _METRICS}, gs


def _mean_of(parts, device):
    """Gradients, loss and metrics of ``parts`` (an iterable of ``(loss,
    metrics, grads)``, one a microbatch or a data group, taken one at a
    time) added in order from float32 zeros on ``device``, then scaled by
    ``1 / n``."""
    acc_g = acc_l = acc_m = None
    n = 0
    for l, m, g in parts:
        n += 1
        if acc_g is None:
            acc_g = [torch.zeros(x.shape, dtype=F32, device=device)
                     for x in g]
            acc_l = torch.zeros((), dtype=F32, device=device)
            acc_m = {k: torch.zeros((), dtype=F32, device=device)
                     for k in _METRICS}
        acc_g = [a + gi.to(device) for a, gi in zip(acc_g, g)]
        acc_l = acc_l + l.to(device)
        acc_m = {k: acc_m[k] + m[k].to(device) for k in _METRICS}
    inv = 1.0 / n
    return (acc_l * inv, {k: v * inv for k, v in acc_m.items()},
            [g * inv for g in acc_g])


def _loss_and_grads(model, leaves, batch, microbatches):
    batch = _to_device(batch, model.device)
    if microbatches == 1:
        return _grads_of(model, leaves, batch)
    mbs = _split_microbatches(batch, microbatches)
    return _mean_of((_grads_of(model, leaves, {k: v[i] for k, v in
                                               mbs.items()})
                     for i in range(microbatches)), model.device)


def make_train_step(model, opt_cfg: AdamWConfig = AdamWConfig(), *,
                    microbatches: int = 1, schedule=None):
    """The train step of ``model``; the returned function carries the
    model as ``.model`` (the trainer restores checkpoints into it).  Under
    an active `LaneMesh` of more than one lane it is the sharded step
    (see the module note), which also carries ``.mesh``."""
    sched = schedule or (lambda s: warmup_cosine(s))
    mesh = sharding._current_mesh()
    if isinstance(mesh, LaneMesh) and mesh.size > 1:
        return _make_sharded_step(model, opt_cfg, mesh, microbatches, sched)

    def train_step(state: TrainState, batch):
        leaves = list(adamw._leaves(state.params))
        loss, metrics, grads = _loss_and_grads(model, leaves, batch,
                                               microbatches)
        _, new_opt, om = adamw.update(grads, state.opt, state.params,
                                      opt_cfg, lr_scale=sched(state.step))
        model.refresh()
        new_state = TrainState(params=state.params, opt=new_opt,
                               step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **om}

    train_step.model = model
    return train_step


def batch_axes_of(mesh) -> tuple:
    """The mesh axes a batch splits over (the logical ``batch`` axis)."""
    return tuple(a for a in sharding.LOGICAL_TO_PHYSICAL["batch"]
                 if a in mesh.axis_names)


def shard_state(state: TrainState, mesh, specs) -> TrainState:
    """``state`` with its parameters and moments as `Sharded` leaves on
    ``mesh`` under ``specs`` (a tree of specs shaped like the parameters):
    a whole leaf is split, a leaf sharded otherwise is gathered and split
    again, a leaf already so sharded is kept."""
    def place(x, spec):
        if (isinstance(x, sharding.Sharded) and x.mesh is mesh
                and x.spec == spec):
            return x
        return sharding.shard(sharding.whole(x).detach(), mesh, spec)

    def tree(t):
        return sharding.tree_map(place, t, specs)

    return TrainState(params=tree(state.params),
                      opt=OptState(mu=tree(state.opt.mu),
                                   nu=tree(state.opt.nu),
                                   count=state.opt.count),
                      step=state.step)


def _make_sharded_step(model, opt_cfg, mesh, microbatches, sched):
    groups = mesh.group_lanes(batch_axes_of(mesh))
    D = len(groups)
    if model.device != groups[0].device:
        raise ValueError(f"the model is on {model.device}, the mesh's first "
                         f"lane on {groups[0].device}")
    with sharding.use_mesh(mesh):
        specs = sharding.param_pspecs(model.params())
    replicas = [model] + [None] * (D - 1)

    def replica(g):
        if replicas[g] is None:
            model.refresh()
            replicas[g] = copy.deepcopy(model).to(groups[g].device)
        return replicas[g]

    def train_step(state: TrainState, batch):
        state = shard_state(state, mesh, specs)
        B = next(iter(batch.values())).shape[0]
        if B % D:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"{D} data groups")
        rows = B // D
        parts = []
        for g, lane in enumerate(groups):
            with lane_context(lane):
                r = replica(g)
                leaves = list(adamw._leaves(r.params()))
                for p, s in zip(leaves, adamw._leaves(state.params)):
                    sharding.gather(s, out=p)
                r.refresh()
                part = {k: v[g * rows:(g + 1) * rows]
                        for k, v in batch.items()}
                parts.append(_loss_and_grads(r, leaves, part, microbatches))
        sync_lanes(mesh)
        loss, metrics, grads = _mean_of(parts, model.device)
        del parts
        gnorm = adamw.grad_norm(grads, model.params())
        lr_scale = sched(state.step)
        p_leaves = list(adamw._leaves(state.params))
        mu_leaves = list(adamw._leaves(state.opt.mu))
        nu_leaves = list(adamw._leaves(state.opt.nu))
        for i, lane in enumerate(mesh.lanes):
            with lane_context(lane):
                g_i = [g[sharding.shard_slices(s.shape, mesh, s.spec, i)]
                       .to(lane.device) for g, s in zip(grads, p_leaves)]
                _, new_opt, om = adamw.update(
                    g_i, OptState(mu=[s.shards[i] for s in mu_leaves],
                                  nu=[s.shards[i] for s in nu_leaves],
                                  count=state.opt.count),
                    [s.shards[i] for s in p_leaves], opt_cfg,
                    lr_scale=lr_scale, gnorm=gnorm.to(lane.device))
        sync_lanes(mesh)
        new_state = TrainState(
            params=state.params,
            opt=OptState(mu=state.opt.mu, nu=state.opt.nu,
                         count=new_opt.count),
            step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **om}

    train_step.model = model
    train_step.mesh = mesh
    train_step.specs = specs
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
