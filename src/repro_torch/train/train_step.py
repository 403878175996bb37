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
``use_mesh``, partitioned as the reference's specs and ``constrain``
hints partition it (`distributed.partition`):

* at rest each lane holds exactly its shards of every parameter and of
  AdamW's ``mu`` and ``nu`` (`distributed.sharding.Sharded`, specs from
  ``param_pspecs`` under the divisibility guard: FSDP rows over ``data``,
  tensor-parallel dims over ``model``); a whole state given to the step
  (``init_state``, a restored checkpoint, a state of another mesh) is
  sharded onto the mesh first, as ``jit``'s ``in_shardings`` place it,
  in place in the state's own trees (as a donated argument: the whole
  tensors are dropped as they are split), and the model's own parameters
  are released (`LM.release`), so no lane keeps a whole copy;
* the batch splits over the batch axes (``pod``, ``data``) in contiguous
  row blocks, one a data group; the rows must divide evenly;
* each data group's M model lanes compute its rows' loss and gradients,
  each its share of the products (heads, the ``ctx`` rows, the MLP's
  hidden dim, experts, the vocabulary over ``model``), gathering a
  period's weights at a time over ``data`` inside the checkpointed
  period function, so under remat they are gathered again in the
  recompute and no lane holds a replica; Mamba2 blocks run whole on the
  group's first lane;
* each group's gradient comes back a shard at a time, and gradients,
  loss and metrics are pooled over the data groups in lane order as the
  microbatch loop adds them (float32 zeros, add in order, x 1/D), each
  shard's on the first lane that holds it; ``grad_norm`` and the clip
  scale come once from the pooled gradient, in the reference's leaf
  order, one leaf put together at a time;
* each lane runs ``adamw.update`` on its own shards.

So a ``(D, 1)`` step equals a one-device step with ``microbatches=D``,
bit for bit, and a ``(D, M)`` step matches it to float32 rounding (the
lanes' partial sums added in float32).

`make_serve_step(model)` builds the one-token greedy decode step;
`make_prefill_step(model)` the forward-only prefill step.  The model owns
its parameters, so these steps take none.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..distributed import partition, sharding
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


def _grads_of(loss_fn, leaves, batch):
    with torch.enable_grad():
        loss, metrics = loss_fn(batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(p, dtype=F32) if g is None else g
          for p, g in zip(leaves, gs)]
    return loss.detach(), {k: metrics[k].detach() for k in _METRICS}, gs


class _Mean:
    """Gradients, loss and metrics of microbatches or data groups, added
    in place one at a time, in order, from float32 zeros (each gradient
    on its own device; loss and metrics on ``device``), then scaled by
    ``1 / n``: the reference's scan over microbatches."""

    def __init__(self, device):
        self.device = device
        self.n = 0
        self.grads = None

    def add(self, loss, metrics, grads, stream=None):
        if self.grads is None:
            self.grads = [torch.zeros(g.shape, dtype=F32, device=g.device)
                          for g in grads]
            self.loss = torch.zeros((), dtype=F32, device=self.device)
            self.metrics = {k: torch.zeros((), dtype=F32, device=self.device)
                            for k in _METRICS}
        for a, g in zip(self.grads, grads):
            a.add_(g.to(a.device))
            if stream is not None and g.is_cuda:
                g.record_stream(stream)
        self.loss.add_(loss.to(self.device))
        for k in _METRICS:
            self.metrics[k].add_(metrics[k].to(self.device))
        self.n += 1

    def mean(self):
        inv = 1.0 / self.n
        for t in (*self.grads, self.loss, *self.metrics.values()):
            t.mul_(inv)
        return self.loss, self.metrics, self.grads


def _loss_and_grads(loss_fn, leaves, batch, microbatches, device):
    """``loss_fn(batch)``'s loss and metrics and the gradient of each of
    ``leaves`` (zeros where unused), ``batch`` split into
    ``microbatches`` and averaged (`_Mean`, on ``device``)."""
    if microbatches == 1:
        return _grads_of(loss_fn, leaves, batch)
    acc = _Mean(device)
    mbs = _split_microbatches(batch, microbatches)
    for i in range(microbatches):
        acc.add(*_grads_of(loss_fn, leaves, {k: v[i] for k, v in
                                             mbs.items()}))
    return acc.mean()


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
        loss, metrics, grads = _loss_and_grads(
            model.loss, leaves, _to_device(batch, model.device),
            microbatches, model.device)
        _, new_opt, om = adamw.update(grads, state.opt, state.params,
                                      opt_cfg, lr_scale=sched(state.step))
        model.refresh()
        new_state = TrainState(params=state.params, opt=new_opt,
                               step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **om}

    train_step.model = model
    return train_step


def shard_state(state: TrainState, mesh, specs) -> TrainState:
    """``state`` with its parameters and moments as `Sharded` leaves on
    ``mesh`` under ``specs`` (a tree of specs shaped like the parameters):
    a whole leaf is split, a leaf sharded otherwise is gathered and split
    again, a leaf already so sharded is kept.  Each leaf is replaced in
    ``state``'s own trees as soon as it is split (as a jit with donated
    arguments takes its input), so a whole tensor nothing else holds is
    freed then, and the whole state and its shards are never on the
    lanes together."""
    def place(t, spec):
        for k in (t if isinstance(t, dict) else range(len(t))):
            x = t[k]
            if isinstance(x, (dict, list)):
                place(x, spec[k])
            elif not (isinstance(x, sharding.Sharded) and x.mesh is mesh
                      and x.spec == spec[k]):
                t[k] = sharding.shard(sharding.whole(x).detach(), mesh,
                                      spec[k])
        return t

    return TrainState(params=place(state.params, specs),
                      opt=OptState(mu=place(state.opt.mu, specs),
                                   nu=place(state.opt.nu, specs),
                                   count=state.opt.count),
                      step=state.step)


def _make_sharded_step(model, opt_cfg, mesh, microbatches, sched):
    groups = partition.group_lanes(mesh)
    D = len(groups)
    lane0 = mesh.lanes[0]
    if model.device != lane0.device:
        raise ValueError(f"the model is on {model.device}, the mesh's first "
                         f"lane on {lane0.device}")
    with sharding.use_mesh(mesh):
        specs = sharding.param_pspecs(model.params())

    def train_step(state: TrainState, batch):
        first = next(iter(adamw._leaves(state.params)))
        if not isinstance(first, sharding.Sharded) \
                and first.device.type == "meta" != lane0.device.type:
            raise ValueError("the state's parameters are on meta: the step "
                             "released its model's; pass the state it "
                             "returned")
        model.release()
        state = shard_state(state, mesh, specs)
        B = next(iter(batch.values())).shape[0]
        if B % D:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"{D} data groups")
        rows = B // D
        pool = _Mean(lane0.device)
        for g, lanes in enumerate(groups):
            home = mesh.lanes[lanes[0]]
            # fresh autograd leaves a group: each group's backward runs
            # on its own lanes' streams
            proxies = partition.Proxies(state.params)
            inputs = proxies.grad_inputs()
            plan = partition.GroupPlan(model, mesh, lanes, proxies)
            with lane_context(home):
                part = _to_device({k: v[g * rows:(g + 1) * rows]
                                   for k, v in batch.items()}, home.device)
                loss_fn = functools.partial(model.loss, layout=plan.layout)
                pool.add(*_loss_and_grads(loss_fn, inputs, part,
                                          microbatches, home.device),
                         stream=torch.cuda.current_stream(home.device)
                         if home.stream is not None else None)
            if home.stream is not None:
                torch.cuda.current_stream(home.device).wait_stream(
                    home.stream)
        sync_lanes(mesh)
        loss, metrics, pooled = pool.mean()
        del inputs, plan, loss_fn, proxies.proxy
        offsets, n = [], 0
        for src in proxies.sources:
            offsets.append(n)
            n += len(src)

        def whole_grad(k):
            src = proxies.sources[k]
            if len(src) == 1:
                return pooled[offsets[k]]
            t = torch.empty(proxies.leaves[k].shape, dtype=F32,
                            device=lane0.device)
            for j, (_, sl) in enumerate(src):
                t[sl].copy_(pooled[offsets[k] + j])
            return t

        index = {id(s): k for k, s in enumerate(proxies.leaves)}
        gnorm = adamw._sum_of_squares(
            [[index[id(s)] for s in group]
             for group in adamw.reference_order(state.params)],
            whole=whole_grad)
        lr_scale = sched(state.step)
        p_leaves = proxies.leaves
        mu_leaves = list(adamw._leaves(state.opt.mu))
        nu_leaves = list(adamw._leaves(state.opt.nu))
        for i, lane in enumerate(mesh.lanes):
            with lane_context(lane):
                g_i = [pooled[offsets[k] + proxies.source_of(k, i)]
                       .to(lane.device) for k in range(len(p_leaves))]
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
