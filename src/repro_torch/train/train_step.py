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
  recompute and no lane holds a replica (Mamba2 by head); under
  ``cfg.seq_parallel`` each model lane keeps its token rows between
  blocks instead and gathers a period's weights whole
  (`partition.RowBlocks`);
* each group's gradient comes back a shard at a time, and gradients,
  loss and metrics are pooled over the data groups in lane order as the
  microbatch loop adds them (float32 zeros, add in order, x 1/D), each
  shard's on the first lane that holds it; ``grad_norm`` and the clip
  scale come once from the pooled gradient, in the reference's leaf
  order, one leaf put together at a time;
* each lane runs ``adamw.update`` on its own shards.

So a ``(D, 1)`` step equals a one-device step with ``microbatches=D``,
bit for bit, and a ``(D, M)`` step matches it to float32 rounding (the
lanes' partial sums added in float32).  A MoE model is the exception: its
load-balancing loss is a product of two means over the tokens, so the
groups' router statistics are pooled before it
(`_pooled_router_groups`), and its ``(D, M)`` step matches the one-device
step on the whole batch instead (with ``microbatches=k``, microbatch
``j`` is the reference's rows ``[j B/k, (j+1) B/k)``, split over the
groups).

`make_serve_step(model)` builds the one-token greedy decode step;
`make_prefill_step(model)` the forward-only prefill step.  The model owns
its parameters, so these steps take none.  Given ``mesh=`` (a
`LaneMesh`), each is partitioned over it as the reference's dry-run lays
its serve cells out (parameters by ``PARAM_RULES``, the cache by
``CACHE_RULES``): `_sharded_serve_step`, `_sharded_prefill_step`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..distributed import partition, sharding
from ..launch.mesh import LaneMesh, lane_context, sync_lanes
from ..models import moe as moe_lib
from ..models.model import total_loss
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
    ``mesh`` under ``specs`` (a tree of specs shaped like the parameters),
    in place in the state's own trees (`sharding.shard_tree`)."""
    return TrainState(params=sharding.shard_tree(state.params, mesh, specs),
                      opt=OptState(
                          mu=sharding.shard_tree(state.opt.mu, mesh, specs),
                          nu=sharding.shard_tree(state.opt.nu, mesh, specs),
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
    pool_router = D > 1 and any(
        ffn == "moe" for st in model.stack_specs for _, ffn in st.period)

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
        if pool_router:
            proxies = _pooled_router_groups(model, mesh, groups, state,
                                            batch, microbatches, pool)
        else:
            for g, lanes in enumerate(groups):
                home = mesh.lanes[lanes[0]]
                # fresh autograd leaves a group: each group's backward
                # runs on its own lanes' streams
                proxies = partition.Proxies(state.params)
                inputs = proxies.grad_inputs()
                plan = partition.GroupPlan(model, mesh, lanes, proxies)
                with lane_context(home):
                    part = _to_device({k: v[g * rows:(g + 1) * rows]
                                       for k, v in batch.items()},
                                      home.device)
                    loss_fn = functools.partial(model.loss,
                                                layout=plan.layout)
                    pool.add(*_loss_and_grads(loss_fn, inputs, part,
                                              microbatches, home.device),
                             stream=_stream_of(home))
                _home_waits(home)
            del inputs, plan, loss_fn
        sync_lanes(mesh)
        loss, metrics, pooled = pool.mean()
        del proxies.proxy
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


def _stream_of(lane):
    return (torch.cuda.current_stream(lane.device)
            if lane.stream is not None else None)


def _home_waits(home):
    if home.stream is not None:
        torch.cuda.current_stream(home.device).wait_stream(home.stream)


def _pooled_router_groups(model, mesh, groups, state, batch, microbatches,
                          pool):
    """The data groups' loss and gradients of a MoE model, its
    load-balancing loss over the reference's rows rather than a group's.

    Microbatch ``j`` is the reference's rows ``[j B/k, (j+1) B/k)``, split
    over the ``D`` groups in contiguous blocks.  For each microbatch,
    every group's forward pass runs first, each MoE layer's ``(me, ce)``
    kept (`moe.router_stats`, so a recompute under remat records
    nothing); then each layer's ``ce`` is pooled over the groups (float32,
    added in group order, x 1/D) and every group's loss is formed with
    the pooled ``ce``, detached (it is a one-hot count: no gradient), and
    its own ``me``; then the backward passes run.  The mean of the groups'
    losses is the reference's loss of the whole microbatch.  Each (j, g)
    is added to ``pool`` in that order.  Returns the last group's
    `Proxies` (all share the sources and leaves)."""
    cfg = model.cfg
    D, k = len(groups), microbatches
    B = next(iter(batch.values())).shape[0]
    if B % (D * k):
        raise ValueError(f"a batch of {B} rows does not split into {k} "
                         f"microbatches over {D} data groups")
    rows = B // (D * k)
    plans = []
    for lanes in groups:
        proxies = partition.Proxies(state.params)
        plans.append((mesh.lanes[lanes[0]], proxies, proxies.grad_inputs(),
                      partition.GroupPlan(model, mesh, lanes, proxies)))
    for j in range(k):
        fwd = []
        for g, (home, _, _, plan) in enumerate(plans):
            lo = (j * D + g) * rows
            with lane_context(home), torch.enable_grad(), \
                    moe_lib.router_stats() as stats:
                part = _to_device({n: v[lo:lo + rows]
                                   for n, v in batch.items()}, home.device)
                _, metrics = model.loss(part, layout=plan.layout)
            fwd.append((metrics, stats))
        n_layers = len(fwd[0][1])
        ce = []
        for layer in range(n_layers):
            acc = torch.zeros((cfg.n_experts,), dtype=F32,
                              device=mesh.lanes[0].device)
            for _, stats in fwd:
                acc = acc + stats[layer][1].detach().to(acc.device)
            ce.append(acc * (1.0 / D))
        for (home, _, inputs, _), (metrics, stats) in zip(plans, fwd):
            with lane_context(home), torch.enable_grad():
                lb = torch.zeros((), dtype=F32, device=home.device)
                for (me, _), c in zip(stats, ce):
                    lb = lb + moe_lib.lb_loss(me, c.to(home.device), cfg)
                loss = total_loss(cfg, metrics["ce"],
                                  {**metrics, "moe_lb_loss": lb})
                gs = torch.autograd.grad(loss, inputs, allow_unused=True)
                gs = [torch.zeros_like(p, dtype=F32) if x is None else x
                      for p, x in zip(inputs, gs)]
                pool.add(loss.detach(),
                         {"ce": metrics["ce"].detach(), "moe_lb_loss":
                          lb.detach(), "moe_z_loss":
                          metrics["moe_z_loss"].detach()}, gs,
                         stream=_stream_of(home))
            _home_waits(home)
        del fwd
    return plans[-1][1]


def make_serve_step(model, mesh=None):
    """The greedy one-token decode step ``(cache, last_tokens (B, 1)) ->
    (cache, next tokens (B, 1))``; ties go to the first maximum.  With a
    `LaneMesh`, the partitioned step (`_sharded_serve_step`)."""
    if mesh is not None:
        return _sharded_serve_step(model, mesh)

    @torch.no_grad()
    def serve_step(cache, last_tokens):
        logits, cache = model.decode_step(cache, last_tokens)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        return cache, nxt

    return serve_step


def make_prefill_step(model, mesh=None):
    """Forward pass only (inference prefill): the greedy next token after
    each sequence.  With a `LaneMesh`, the partitioned step
    (`_sharded_prefill_step`)."""
    if mesh is not None:
        return _sharded_prefill_step(model, mesh)

    @torch.no_grad()
    def prefill_step(batch):
        logits, _ = model.forward(batch)
        return torch.argmax(logits[:, -1, :], dim=-1)

    return prefill_step


def serve_params(model, mesh):
    """The model's parameters sharded onto ``mesh`` by ``PARAM_RULES``
    under the guard, as the reference's serve cells place them: made once
    a mesh and kept with the model, whose own parameters are then
    released (`LM.release`), so no lane holds a whole replica at rest."""
    got = getattr(model, "_mesh_params", None)
    if got is not None and got[0] is mesh:
        return got[1]
    whole = model.params()
    with sharding.use_mesh(mesh):
        specs = sharding.param_pspecs(whole)
    params = sharding.tree_map(
        lambda x, sp: sharding.shard(x.detach(), mesh, sp), whole, specs)
    del whole
    model.release()
    model._mesh_params = (mesh, params)
    return params


def _sharded_serve_step(model, mesh):
    """The decode step partitioned over ``mesh`` (`partition.ServePlan`):
    the parameters at rest by ``PARAM_RULES`` (`serve_params`), the cache
    by ``CACHE_RULES`` (`launch.inputs.cache_shardings`; a whole cache is
    sharded in place on the first call, `sharding.shard_cache`), the rows
    split over the data groups (``B % D`` must be 0; at ``B == 1`` one
    group and the cache's positions over ``data``), a period's weights
    gathered at a time over ``data``, the products split over ``model``,
    the greedy head by vocabulary.

    ``logits=True`` also returns the step's logits (B, V), put together
    on the first lane, for checks.  ``model.decode_step(cache, tokens,
    layout=ServePlan(...).layout)`` gives the same logits but not the
    split head's tokens, and the step writes the cache in place, so a
    check cannot call both on one step: it takes both from this call."""
    from ..launch.inputs import cache_shardings

    @torch.no_grad()
    def serve_step(cache, last_tokens, *, logits=False):
        params = serve_params(model, mesh)
        B = last_tokens.shape[0]
        cache = sharding.shard_cache(
            cache, mesh, cache_shardings(cache, model.cfg, B, mesh))
        lay = partition.ServePlan(model, mesh, params, B).layout(model)
        xf, cache = model._decode(lay, cache, last_tokens)
        nxt = lay.greedy(xf)
        out = (cache, nxt, lay.logits(xf)[:, 0, :]) if logits \
            else (cache, nxt)
        sync_lanes(mesh)
        return out

    serve_step.mesh = mesh
    return serve_step


def _sharded_prefill_step(model, mesh):
    """The prefill partitioned over ``mesh``: each data group's rows
    through the partitioned forward (`LM._hidden` with
    `partition.GroupPlan.layout`: a period's weights gathered at a time,
    attention in ``heads`` or ``ctx`` mode, the MLP by columns, MoE by
    experts) and the greedy head split by vocabulary on the last
    position; the tokens put together on the first lane.  ``B == 1`` is
    one group, as in decode.  A MoE routing group must not span data
    groups (the forward routes a group's tokens alone)."""
    everyone = partition.group_lanes(mesh)
    cfg = model.cfg

    @torch.no_grad()
    def prefill_step(batch):
        params = serve_params(model, mesh)
        B = next(iter(batch.values())).shape[0]
        groups = everyone if B > 1 else everyone[:1]
        D = len(groups)
        if B % D:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"{D} data groups")
        rows = B // D
        if cfg.n_experts:
            S = batch["tokens"].shape[1] + cfg.num_patches
            g_size = moe_lib._group_size(B * S, cfg)
            if (rows * S) % g_size:
                raise ValueError(f"a MoE routing group of {g_size} tokens "
                                 f"spans data groups of {rows * S}")
        toks = []
        for g, lanes in enumerate(groups):
            home = mesh.lanes[lanes[0]]
            plan = partition.GroupPlan(model, mesh, lanes,
                                       partition.Resting(params))
            with lane_context(home):
                part = _to_device({k: v[g * rows:(g + 1) * rows]
                                   for k, v in batch.items()}, home.device)
                lay = plan.layout(model)
                xf, _ = model._hidden(part, lay)
                toks.append(lay.greedy(lay.last(xf))[:, 0])
            _home_waits(home)
        lane0 = mesh.lanes[0]
        out = torch.cat([t.to(lane0.device) for t in toks])
        sync_lanes(mesh)
        return out

    prefill_step.mesh = mesh
    return prefill_step
