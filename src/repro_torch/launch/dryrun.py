"""Dry-run of every (arch x shape) cell on the production meshes, without a
card (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step with XLA on 512 forced
host devices, reads ``memory_analysis()`` and ``cost_analysis()`` on
python-unrolled probes at ``n_periods`` 2 and 4, and parses collective
bytes out of the post-SPMD HLO.  Eager PyTorch has no compiler, no
partitioner and no HLO, so none of that exists here.  What this module
does instead, for each cell on ``make_production_mesh(device="meta")``,
single-pod ``(16, 16)`` and multi-pod ``(2, 16, 16)``:

1. **Shape proof, in place of the compile proof.**  Nothing is compiled.
   The cell's step (train, prefill or decode, as the reference's
   ``_lower_cell`` picks) runs once end to end on ``meta`` tensors, with
   the stand-ins and specs of `launch.inputs`, as the port runs it.
   Train: the partitioned sharded step (`distributed.partition`,
   `train.train_step`): the parameters sharded onto the mesh, the batch
   split over the batch axes, one data group's M lanes each gathering a
   period's weights at a time and computing its share of the products,
   then one lane's AdamW update on its shards.  Every data group has the
   same shapes, so one group's run proves them all; within the group
   every lane gathers its weights, and lanes 2 and up, whose shares have
   lane 1's shapes, take lane 1's outputs (`_SampledPlan`; under
   ``cfg.seq_parallel`` lanes 1 and up take the last lane's, whose key
   span and labelled rows are the longest).  Prefill:
   one group's rows through the partitioned forward and the greedy head
   split by vocabulary.  Decode: the partitioned decode step
   (`partition.ServePlan`) on the cache sharded by ``CACHE_RULES``, data
   groups 0 and 1 run in lockstep, the others taking group 1's outputs
   (`_SampledServe`).  Every serve cell's plan is ``partitioned``.  A
   shape or spec mismatch raises and fails the cell, as a sharding
   mismatch fails the reference's compile.
2. **Memory**: the bytes each lane holds of the step's arguments
   (parameters, optimizer state, batch, cache: each leaf's shard under
   its spec; the guard keeps shards equal, so every lane holds the
   same), the counterpart of ``argument_size_in_bytes``, exact
   arithmetic.  Then the plan's bytes a lane (``lane_gb``, the largest
   over a group's lanes, checked against the H100's 80 GB).  Train: the
   arguments; the float32 gradient it keeps (the pooled one and one
   group's, a tensor for each distinct shard it first holds); the
   gathered weights it holds at once, from the plan's counts (its
   top-level slices and two periods' slices: the one in use and the one
   before it, not yet freed; every period under ``remat == "none"``);
   the activations kept for the backward pass (the tensors saved outside
   the periods, the checkpointed periods' inputs among them, counted in
   the shape proof, and the most one period saves, counted in a run of
   each stack's first period without checkpointing, as its recompute
   runs it; the backward pass's own temporaries are not counted; a
   lane's are the tensors of its own shares, so of a Mamba2 block split
   by head its ``H/M`` heads of the ``(B, C, Q, Q, H)`` decay); and on
   the group's
   first lane the one whole gradient leaf the clip norm sums, once the
   backward pass is over.  Prefill and decode: the arguments (parameter
   and cache shards, tokens), one period's gathered shares and the
   top-level slices (the plan's counts), and for prefill the forward's
   working set besides its weights (`_Live`: the tensors made and alive
   at once on the lane); ``cache_bytes``, a lane's cache tensors.  XLA's
   ``temp``, ``output``, ``alias`` and ``code`` have no counterpart:
   ``null``, with the reason in the record.
3. **Cost**: FLOPs counted by ``torch.utils.flop_counter.FlopCounterMode``
   over the whole depth (there is no scan hiding a loop body), for the
   whole step (one group's count times the groups) and for one group
   (``flops_per_group``; a recompute runs its whole period here); and at
   the reference's probe depths (`_probe_cfg`, 2 and 4
   periods), to check that the three counts lie on the reference's line
   ``F(n) = A + n*B`` (``n = n_periods + n_remainder / period_len``, as
   ``benchmarks/roofline.py`` reads it).  The counter counts matrix
   products and attention (as XLA's flop count is dominated by them);
   elementwise work is not counted.  Bytes accessed have no
   counterpart: ``null``.
4. **Lane-to-lane bytes** of the port's plan, under the reference's
   collective keys; they describe the port's plan, not XLA's.  Train:
   ``all-gather`` the bytes every gather puts together (a lane's own
   shard included); ``all-reduce`` the lanes' inputs and partial outputs
   moved within a group (the backward pass counted as moving the
   forward's again) and the float32 gradients, loss and metrics pooled
   over the groups; ``reduce-scatter`` the pooled gradient copied to the
   lanes that hold a shard another lane pools.  Prefill and decode:
   ``all-gather`` the bytes every gather puts together, ``all-reduce``
   the lanes' inputs and partial outputs moved within a group and, in
   decode, the bytes that cross between data groups (each group's
   tokens handed out and put together, a MoE routing group's experts
   pooled and its slots handed back: `partition.ServePlan.moved`).
   ``all-to-all``
   and ``collective-permute`` 0; ``n_ops`` the gathers and pooled
   tensors; ``total`` their bytes; all summed over the mesh for one
   step.
   The HLO parser ``collective_bytes`` has no input here and is not
   ported.

The module sets no environment variable: meta lanes need none.  Results
append to a JSON file (default: ``repro_torch_dryrun.json`` in the temp
directory; ``benchmarks/`` is the reference's).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--jobs N] [--out FILE]
"""
from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.utils._python_dispatch
import torch.utils.checkpoint

from ..configs import SHAPES, cells, get_config
from ..optim import adamw
from ..optim.adamw import OptState
from ..distributed import partition
from ..distributed.sharding import (
    NamedSharding, shard, shard_shape, shard_slices, tree_map,
)
from ..models.transformer import StackSpec, run_stack
from . import analysis
from .inputs import cell_specs
from .mesh import make_production_mesh

CARD = "NVIDIA H100 80GB HBM3"
CARD_BYTES = 80e9
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
NULL_REASONS = {
    "temp_gb": "activations: eager PyTorch plans no buffers ahead of a run",
    "output_gb": "the port's train step updates its state in place",
    "alias_gb": "no buffer donation in eager PyTorch",
    "code_mb": "nothing is compiled",
    "bytes": "no cost model of memory traffic without XLA",
}
F32_BYTES = 4
INT_BYTES = 4           # an int leaf (a cache's pos) is the reference's 0-d int32


def _probe_cfg(cfg, n: int):
    """Same arch, n periods per stack, python-unrolled (cost probe)."""
    over = dict(unroll_stacks=True, remainder=(), n_periods=n,
                n_layers=len(cfg.period) * n)
    if cfg.is_encoder_decoder:
        over["n_encoder_layers"] = len(cfg.encoder_period) * n
    return cfg.scaled(**over)


# ------------------------------------------------------------- leaves ---
def _leaf_rows(tree, shardings):
    """``(shape, itemsize, spec)`` of every leaf of ``tree`` beside its
    sharding (an ``int`` leaf: shape (), the reference's int32)."""
    items, specs = [], []
    _walk_leaves(tree, items)
    _walk_leaves(shardings, specs,
                 is_leaf=lambda x: isinstance(x, NamedSharding))
    if len(items) != len(specs):
        raise ValueError(f"{len(items)} leaves for {len(specs)} shardings")
    rows = []
    for x, sh in zip(items, specs):
        if isinstance(x, torch.Tensor):
            rows.append((tuple(x.shape), x.element_size(), sh.spec))
        else:
            rows.append(((), INT_BYTES, sh.spec))
    return rows


def _walk_leaves(tree, out, is_leaf=lambda x: False):
    if is_leaf(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _walk_leaves(v, out, is_leaf)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _walk_leaves(v, out, is_leaf)
    else:
        out.append(tree)


def _lane_bytes(rows, mesh) -> int:
    """Bytes one lane holds of leaves ``rows`` (every lane holds the
    same: the guard keeps each shard an exact split)."""
    return sum(math.prod(shard_shape(shape, mesh, spec)) * size
               for shape, size, spec in rows)


def _full_bytes(rows) -> int:
    return sum(math.prod(shape) * size for shape, size, _ in rows)


def _groups(spec0, mesh) -> int:
    """How many ways the batch dim splits (its spec's axes' product)."""
    if spec0 is None:
        return 1
    axes = spec0 if isinstance(spec0, tuple) else (spec0,)
    return math.prod(mesh.shape[a] for a in axes)


# --------------------------------------------------------------- plan ---
def _rows_of(x, rows):
    return torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device="meta")


def _group_args(model, structs, groups):
    """One data group's rows of the train batch (meta)."""
    first = next(iter(structs[1].values()))
    B = first.shape[0]
    if B % groups:
        raise ValueError(f"{B} rows do not split over {groups} groups")
    rows = B // groups
    return rows, {k: _rows_of(v, rows) for k, v in structs[1].items()}


def _serve_group(model, kind, structs, shardings, mesh, params):
    """The partitioned prefill or decode on meta (the shape proof):
    decode, every group in lockstep (`partition.ServePlan`) on the
    sharded cache; prefill, one data group's rows (every group has its
    shapes) through `GroupPlan.layout`, its forward's live bytes a lane
    counted (`_Live`).  Both on `_SampledPlan` lanes, the greedy head
    split by vocabulary.  Returns the group plans, the live bytes and
    the bytes that cross between data groups (decode's `ServePlan.moved`;
    prefill's groups do not meet)."""
    from ..distributed.sharding import shard_cache

    if kind == "decode":
        B = structs[2].shape[0]
        plan = _SampledServe(model, mesh, params, B, plan_cls=_SampledPlan)
        cache = shard_cache(structs[1], mesh, shardings[1])
        lay = plan.layout(model)
        xf, _ = model._decode(lay, cache, structs[2])
        nxt = lay.greedy(xf)
        if tuple(nxt.shape) != (B, 1):
            raise ValueError(f"decode gave {tuple(nxt.shape)}")
        return plan.plans, None, plan.moved
    batch = structs[1]
    B = next(iter(batch.values())).shape[0]
    groups = partition.group_lanes(mesh)
    rows = B // len(groups)
    plan = _SampledPlan(model, mesh, groups[0], partition.Resting(params))
    part = {k: _rows_of(v, rows) for k, v in batch.items()}
    with _Live(plan) as live:
        lay = plan.layout(model)
        xf, _ = model._hidden(part, lay)
        out = lay.greedy(lay.last(xf))
    if tuple(out.shape) != (rows, 1):
        raise ValueError(f"prefill gave {tuple(out.shape)}")
    return [plan], live.high, 0


class _SampledServe(partition.ServePlan):
    """The decode plan on a production mesh's ``meta`` lanes with groups
    2 and up sampled: every data group has group 1's shapes, so only
    groups 0 and 1 run (gather and compute), and the hidden state's rows
    of groups 2.. are group 1's outputs again.  ``sampled`` is how many
    groups group 1 stands for."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.sampled = len(self.plans) - 1
        self.plans = self.plans[:2]

    def _count(self, parts):
        self.moved += self.sampled * sum(partition._nbytes(t)
                                         for t in parts[1:2])

    def _join(self, parts):
        self._count(parts)
        return torch.cat(list(parts[:1]) + list(parts[1:2]) * self.sampled)


class _Live(torch.utils._python_dispatch.TorchDispatchMode):
    """While entered, the bytes of the tensors made (not views, not
    written in place, not gathered weights) that are alive at once, by
    the lane computing (``plan.at``): ``high[m]``, a lane's forward
    working set besides its weights.  A tensor counts until it is
    dropped."""

    def __init__(self, plan):
        super().__init__()
        self.plan = plan
        self.now = [0] * plan.M
        self.high = [0] * plan.M
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import weakref

        out = func(*args, **(kwargs or {}))
        if self.plan.gathering or func.is_view or func._schema.is_mutable:
            return out
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage()._cdata
            if key in self.seen:
                continue
            m, n = self.plan.at, t.untyped_storage().nbytes()
            self.seen.add(key)
            self.now[m] += n
            self.high[m] = max(self.high[m], self.now[m])
            weakref.finalize(t, self._free, key, m, n)
        return out

    def _free(self, key, m, n):
        self.seen.discard(key)
        self.now[m] -= n


class _SampledPlan(partition.GroupPlan):
    """The partitioned plan on a production group's ``meta`` lanes (16
    of them, where an operation costs a fraction of a millisecond): every
    lane gathers its weights, but lanes 2 and up, whose shares have lane
    1's shapes, compute nothing and take lane 1's outputs.  Under
    ``cfg.seq_parallel`` the lane standing for the others (``rep``) is
    the last, which runs first after home: row blocks give lanes key
    spans and label windows of their own, the last lane's the longest
    (the whole sequence's keys, all its rows labelled but one), so its
    counts bound the others'.  Besides the plan's own counts it keeps
    ``lane_flops``, ``rep``'s FLOPs; ``at``, the lane computing now (0
    outside `run`); ``weights``, the storages of the weights gathered;
    ``seqs``, each stack's query length."""

    def __init__(self, *args):
        super().__init__(*args)
        self.rep = self.M - 1 if self.sp else 1
        self.at = 0
        self.lane_flops = 0
        self.weights = {}
        self.seqs = {}
        self.gathering = False
        self._one = None
        self.owner = {}

    def _take(self, *args, **kw):
        self.gathering = True
        try:
            out = super()._take(*args, **kw)
        finally:
            self.gathering = False
        st = out.untyped_storage()
        self.weights[st._cdata] = st
        return out

    def stack(self, name, seq):
        self.seqs[name] = seq
        return super().stack(name, seq)

    def _order(self, positions):
        return sorted(positions, key=lambda m: (m != 0, m != self.rep, m))

    def run(self, fn, *shared, lanes=None):
        if lanes is None:
            return super().run(fn, *shared)
        rep, self.rep = self.rep, 1     # a subset's positions: lane 1 stands
        try:
            return super().run(fn, *shared, lanes=lanes)
        finally:
            self.rep = rep

    def _lane_run(self, m, fn, shared, i, local=False):
        from torch.utils.flop_counter import FlopCounterMode

        if m not in (0, self.rep):
            out, moved = self._one
            self.moved += moved
            return out
        before, self.at = self.moved, m
        try:
            if m == 0:
                return super()._lane_run(m, fn, shared, i, local)
            with FlopCounterMode(display=False) as fc:
                out = super()._lane_run(m, fn, shared, i, local)
        finally:
            self.at = 0
        self.lane_flops += fc.get_total_flops()
        self._one = (out, self.moved - before)
        return out


class _Saved:
    """The bytes of the tensors autograd saves for the backward pass
    while this is entered, by lane: a hidden state the plan made on the
    lane that holds it (``plan.owner``: a period's input row blocks under
    ``cfg.seq_parallel``, which the checkpoint saves outside any lane's
    run), any other tensor on the lane computing (``plan.at``); a storage
    counted once, the gathered weights and the storages of ``skip`` left
    out.  ``high[m]`` is the most over the times it was entered, and
    ``inputs[m]`` the hidden states' part of it."""

    def __init__(self, plan, skip=()):
        self.plan = plan
        self.skip = {t.untyped_storage()._cdata for t in skip}
        self.high = [0] * plan.M
        self.inputs = [0] * plan.M

    def __enter__(self):
        self.now = [0] * self.plan.M
        self.now_in = [0] * self.plan.M
        self.seen = {}
        self.hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self.hooks.__exit__(*exc)
        self.high = [max(h, n) for h, n in zip(self.high, self.now)]
        self.inputs = [max(h, n) for h, n in zip(self.inputs, self.now_in)]
        self.seen = None

    def _pack(self, t):
        st = t.untyped_storage()
        k = st._cdata
        if k not in self.seen and k not in self.plan.weights \
                and k not in self.skip:
            self.seen[k] = st
            own = self.plan.owner.get(k)
            m = self.plan.at if own is None else own[0]
            self.now[m] += st.nbytes()
            if own is not None:
                self.now_in[m] += st.nbytes()
        return t


def _train_group(model, args, mesh, params, microbatches):
    """One data group's loss and gradients on meta (the shape proof), on
    the partitioned plan (`_SampledPlan`) of ``params`` (the parameters
    sharded onto ``mesh``).  Returns the plan, the forward passes' counts
    (``moved``, lane 1's ``flops``, each lane's most ``gathered`` in one
    pass) and the tensors saved outside the periods (`_Saved`)."""
    from ..train.train_step import _loss_and_grads

    proxies = partition.Proxies(params)
    plan = _SampledPlan(model, mesh, partition.group_lanes(mesh)[0],
                        proxies)
    outer = _Saved(plan)
    fwd = {"moved": 0, "flops": 0, "gathered": [0] * plan.M}

    def loss_fn(batch):
        moved, flops = plan.moved, plan.lane_flops
        gathered = list(plan.gathered)
        with outer:
            out = model.loss(batch, layout=plan.layout)
        fwd["moved"] += plan.moved - moved
        fwd["flops"] += plan.lane_flops - flops
        fwd["gathered"] = [max(f, a - b) for f, a, b in zip(
            fwd["gathered"], plan.gathered, gathered)]
        return out

    inputs = proxies.grad_inputs()
    # a recompute runs its whole period (no early stop), so lane 1's
    # count stands for every lane's
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        loss, _, grads = _loss_and_grads(loss_fn, inputs, args,
                                         microbatches, plan.home.device)
    if loss.shape != () or any(g.shape != p.shape
                               for g, p in zip(grads, inputs)):
        raise ValueError("train: a gradient's shape is not its shard's")
    return plan, fwd, outer


def train_saved(model, mesh, params, batch, microbatches=1) -> dict:
    """The activations one data group's lanes keep for the backward pass
    of the partitioned train step, counted on whatever device the mesh's
    lanes are (the card's, or ``meta`` as `plan_cell` counts them): the
    first group's rows ``batch`` through `_train_group` on ``params``
    (the parameters sharded onto ``mesh``), then each stack's first
    period alone (`_period_saved`).  Per lane of the group (lanes 1 and
    up count as the plan's ``rep``: lane 1, or under
    ``cfg.seq_parallel`` the last): ``saved``, the bytes saved outside the
    checkpointed periods, ``inputs``, the periods' input hidden states
    among them, and ``period``, the most one period saves."""
    plan, _, outer = _train_group(model, batch, mesh, params, microbatches)
    rows = next(iter(batch.values())).shape[0] // microbatches
    period = _period_saved(model, plan, rows)
    pick = lambda xs: [xs[plan.rep if m else 0]  # noqa: E731
                      for m in range(plan.M)]
    return {"saved": pick(outer.high), "inputs": pick(outer.inputs),
            "period": pick(period)}


def _stacks(model):
    enc = [("enc_stack", model.enc_spec)] \
        if model.cfg.is_encoder_decoder else []
    return enc + [(f"s{i}", st) for i, st in enumerate(model.stack_specs)]


def _period_saved(model, plan, rows) -> list:
    """The most bytes one period saves for its backward pass, a lane
    (`_Saved`): each stack's first period run alone on ``rows`` rows,
    without checkpointing, as the backward pass's recompute runs it."""
    cfg = model.cfg
    dev = plan.home.device
    flat = cfg.scaled(remat="none")
    enc = None
    if cfg.is_encoder_decoder:
        enc = torch.empty((rows, plan.seqs["enc_stack"], cfg.d_model),
                          dtype=cfg.compute_dtype, device=dev)
    best = [0] * plan.M
    for name, st in _stacks(model):
        S = plan.seqs[name]
        x = torch.empty((rows, S, cfg.d_model), dtype=cfg.compute_dtype,
                        device=dev, requires_grad=True)
        saved = _Saved(plan, skip=[t for t in (x, enc) if t is not None])
        with torch.enable_grad(), saved:
            run_stack(plan.stack(name, S)[:1], x,
                      StackSpec(st.period, 1, st.has_cross), flat,
                      positions=torch.arange(S, device=dev)[None, :],
                      enc_out=None if name == "enc_stack" else enc,
                      **plan.stack_kw())
        best = [max(b, h) for b, h in zip(best, saved.high)]
    return best


def _update_on_shards(params, specs, mesh):
    """AdamW's update on one lane's shards (meta): shapes only."""
    shards, sleaves = [], []
    _walk_leaves(specs, sleaves, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    for p, sh in zip(adamw._leaves(params), sleaves):
        shards.append(torch.empty(shard_shape(p.shape, mesh, sh.spec),
                                  dtype=p.dtype, device="meta"))
    zeros = [torch.empty(s.shape, dtype=torch.float32, device="meta")
             for s in shards]
    adamw.update(list(zeros), OptState(mu=list(zeros), nu=list(zeros),
                                       count=torch.zeros((), dtype=torch.int32)),
                 shards, adamw.AdamWConfig(),
                 gnorm=torch.empty((), device="meta"))


def _flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _owned_grad_bytes(p_rows, mesh) -> tuple:
    """Float32 bytes of the pooled gradient each lane keeps (one tensor
    for every distinct shard it is the first lane to hold) and the bytes
    of the shards it holds but does not own (the pooled gradient's copy
    it is sent)."""
    owned, copied = [0] * mesh.size, [0] * mesh.size
    for shape, _, spec in p_rows:
        shard = math.prod(shard_shape(shape, mesh, spec)) * F32_BYTES
        first = {}
        for i in range(mesh.size):
            key = tuple((x.start, x.stop)
                        for x in shard_slices(shape, mesh, spec, i))
            if key in first:
                copied[i] += shard
            else:
                first[key] = i
                owned[i] += shard
    return owned, copied


def _collectives(kind, mesh, p_rows, c_rows, groups, plan=None, fwd=None,
                 copied=0, between=0) -> dict:
    """Lane-to-lane bytes of the port's plan for one step (see the module
    note), summed over the mesh."""
    out = {k: 0 for k in COLLECTIVES}
    if kind == "train":
        out["all-gather"] = groups * sum(plan.gathered)
        n_ops = groups * sum(plan.gathers)
        grads = sum(math.prod(s) * F32_BYTES for s, _, _ in p_rows)
        # the backward pass moves the forward's inputs and outputs back
        out["all-reduce"] = (groups - 1) * (grads + 4 * F32_BYTES) \
            + groups * (plan.moved + fwd["moved"])
        n_ops += (groups - 1) * (len(p_rows) + 4)
        out["reduce-scatter"] = copied
    else:
        # a prefill's group stands for every group; decode's first group
        # for itself, its second for the rest
        w = [groups] if kind == "prefill" else [1, groups - 1]
        out["all-gather"] = sum(k * sum(p.gathered) for k, p in zip(w, plan))
        out["all-reduce"] = sum(k * p.moved for k, p in zip(w, plan)) \
            + between
        n_ops = sum(k * sum(p.gathers) for k, p in zip(w, plan))
    out["n_ops"] = n_ops
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def plan_cell(cfg, shape, mesh, *, microbatches=1, count_flops=False,
              prove=True):
    """One cell on one mesh: its shape proof (raises on a mismatch; left
    out with ``prove=False``), its per-lane memory, its lane-to-lane
    bytes and (``count_flops``) the FLOPs of the step.  Returns a
    dict."""
    model, kind, structs, shardings = cell_specs(cfg, shape, mesh)
    if kind == "decode":
        p_rows = _leaf_rows(structs[0], shardings[0])
        c_rows = _leaf_rows(structs[1], shardings[1])
        b_rows = _leaf_rows({"t": structs[2]}, {"t": shardings[2]})
        groups = _groups(shardings[2].spec[0], mesh)
        opt_rows = []
    else:
        b_rows = _leaf_rows(structs[1], shardings[1])
        first = next(iter(shardings[1].values()))
        groups = _groups(first.spec[0], mesh)
        c_rows = []
        if kind == "train":
            state, s_shard = structs[0], shardings[0]
            p_rows = _leaf_rows(state.params, s_shard.params)
            opt_rows = _leaf_rows((state.opt, state.step),
                                  (s_shard.opt, s_shard.step))
        else:
            p_rows = _leaf_rows(structs[0], shardings[0])
            opt_rows = []
    lane = {name: _lane_bytes(rows, mesh) for name, rows in (
        ("params", p_rows), ("opt", opt_rows), ("batch", b_rows),
        ("cache", c_rows))}
    arg = sum(lane.values())
    mu_nu = _lane_bytes([r for r in opt_rows if r[0]], mesh)
    # the cache's tensors (the reference's 0-d int32 ``pos`` counters left
    # out: the port's are Python ints)
    cache_bytes = _lane_bytes([r for r in c_rows if r[0]], mesh)
    gb = 1 / 2**30
    memory = {
        "argument_gb": arg * gb, "argument_bytes": arg,
        "params_gb": lane["params"] * gb, "opt_gb": lane["opt"] * gb,
        "batch_gb": lane["batch"] * gb, "cache_gb": lane["cache"] * gb,
        "state_bytes": lane["params"] + mu_nu, "cache_bytes": cache_bytes,
        "plan": ("partitioned, token rows over model (seq_parallel)"
                 if cfg.seq_parallel else "partitioned"),
        "fits_card_at_rest": arg <= CARD_BYTES,
        "card": CARD,
        "output_gb": None, "temp_gb": None, "alias_gb": None,
        "code_mb": None,
    }
    out = {"kind": kind, "groups": groups, "memory": memory}
    t0 = time.perf_counter()
    proved = prove or count_flops
    if proved and kind == "train":
        rows, args = _group_args(model, structs, groups)
    if kind != "train" and proved:
        params = tree_map(lambda x, sh: shard(x, mesh, sh.spec),
                          structs[0], shardings[0])
        got = {}
        run = lambda: got.setdefault("run", _serve_group(  # noqa: E731
            model, kind, structs, shardings, mesh, params))
        counted = _flops(run) if count_flops else run()
        plans, live, between = got["run"]
        if count_flops:
            # lanes 2.. ran as lane 1; decode ran groups 0 and 1 of all
            counted += sum(max(p.M - 2, 0) * p.lane_flops for p in plans)
            group_flops = counted / len(plans)
        out["collectives"] = _collectives(kind, mesh, p_rows, c_rows, groups,
                                          plans, between=between)
        gathered, per_lane, work = [], [], []
        for p in plans:
            for m in range(p.M):
                j = p.rep if m else 0   # lanes 1.. computed as rep
                gathered.append(p.top_bytes[m] + p.period_bytes[m])
                work.append(live[j] if live is not None else 0)
                per_lane.append(arg + gathered[-1] + work[-1])
        memory.update(gathered_gb=max(gathered) * gb,
                      working_set_gb=max(work) * gb, lane_bytes=max(per_lane))
    elif proved:
        params = tree_map(lambda x, sh: shard(x, mesh, sh.spec),
                          structs[0].params, shardings[0].params)
        got = {}
        run = lambda: got.setdefault("run", _train_group(  # noqa: E731
            model, args, mesh, params, microbatches))
        group_flops = _flops(run) if count_flops else run()
        plan, fwd, saved = got["run"]
        outer = saved.high
        if count_flops:
            # lanes 2.. ran as lane 1; their backward is twice the forward
            group_flops += max(plan.M - 2, 0) * (
                plan.lane_flops + 2 * fwd["flops"])
        owned, copied = _owned_grad_bytes(p_rows, mesh)
        out["collectives"] = _collectives(kind, mesh, p_rows, c_rows, groups,
                                          plan, fwd, sum(copied))
        rows_mb = rows // microbatches
        period = _period_saved(model, plan, rows_mb)
        _update_on_shards(structs[0].params, shardings[0].params, mesh)
        norm_leaf = max(math.prod(s) for s, _, _ in p_rows) * F32_BYTES
        full = cfg.remat == "full"
        gathered, act, per_lane = [], [], []
        for m, i in enumerate(plan.lanes):
            j = plan.rep if m else 0    # lanes 1.. computed as rep
            gathered.append(plan.top_bytes[m] + 2 * plan.period_bytes[m]
                            if full else fwd["gathered"][m])
            act.append(outer[j] + (period[j] if full else 0))
            per_lane.append(arg + max(
                2 * owned[i] + gathered[m] + act[m],
                owned[i] + (norm_leaf if m == 0 else 0)))
        memory.update(
            gathered_gb=max(gathered) * gb, activation_gb=max(act) * gb,
            grad_gb=2 * max(owned) * gb, norm_leaf_gb=norm_leaf * gb,
            lane_bytes=max(per_lane),
            saved_bytes=[outer[plan.rep if m else 0] for m in range(plan.M)],
            input_bytes=[saved.inputs[plan.rep if m else 0]
                         for m in range(plan.M)],
            period_saved_bytes=[period[plan.rep if m else 0]
                                for m in range(plan.M)])
    out["shape_proof_s"] = time.perf_counter() - t0 if proved else None
    if "lane_bytes" in memory:
        memory["lane_gb"] = memory["lane_bytes"] * gb
        memory["fits_card"] = memory["lane_bytes"] <= CARD_BYTES
    if count_flops:
        out["flops_per_group"] = group_flops
        out["flops"] = group_flops * groups
    return out


def run_cell(arch: str, shape_name: str, *, probes: bool = True,
             overrides: dict | None = None) -> dict:
    overrides = dict(overrides or {})
    microbatches = overrides.pop("microbatches", 1)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind, "ok": False,
           "null_reasons": NULL_REASONS}
    if overrides or microbatches > 1:
        rec["overrides"] = {**overrides, "microbatches": microbatches}
    try:
        # --- multi-pod shape proof (512 lanes) ---
        rec["multi_pod"] = plan_cell(
            cfg, shape, make_production_mesh(multi_pod=True, device="meta"),
            microbatches=microbatches)
        # --- single-pod shape proof, memory and FLOPs (256 lanes) ---
        mesh_sp = make_production_mesh(multi_pod=False, device="meta")
        sp = plan_cell(cfg, shape, mesh_sp, microbatches=microbatches,
                       count_flops=True)
        sp["cost_once"] = {"flops": sp["flops"], "bytes": None}
        model_flops = analysis.model_flops_for(cfg, shape)
        sp["model_flops"] = model_flops
        sp["flops_over_model_flops"] = sp["flops"] / model_flops
        rec["single_pod"] = sp
        if probes:
            probe = {}
            for n in (2, 4):
                p = plan_cell(_probe_cfg(cfg, n), shape, mesh_sp,
                              microbatches=microbatches, count_flops=True)
                probe[str(n)] = {"flops": p["flops"], "bytes": None,
                                 "collectives": p["collectives"]}
            rec["probes"] = probe
            rec["n_periods"] = cfg.periods
            rec["n_remainder"] = len(cfg.remainder)
            rec["period_len"] = len(cfg.period)
            rec["flop_line"] = flop_line(rec)
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def flop_line(rec: dict) -> dict:
    """The reference's line ``F(n) = A + n*B`` through the probes, at the
    cell's depth, beside the full-depth count."""
    f2 = rec["probes"]["2"]["flops"]
    f4 = rec["probes"]["4"]["flops"]
    B = (f4 - f2) / 2.0
    A = f2 - 2.0 * B
    n = rec["n_periods"] + rec["n_remainder"] / max(rec["period_len"], 1)
    full = rec["single_pod"]["flops"]
    pred = A + n * B
    return {"A": A, "B": B, "n": n, "predicted": pred, "counted": full,
            "relative_residual": (full - pred) / full if full else 0.0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (hillclimb variants), "
                         "e.g. --set attn_kv_block=512 --set microbatches=2")
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_dryrun.json"))
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                overrides[k] = float(v)

    if args.all and args.jobs > 1:
        # Fan out cells across subprocesses; merge results into --out.
        todo = cells()
        procs = []
        for arch, shape in todo:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", args.out,
                   *(f"--set={kv}" for kv in args.set)]
            if args.no_probes:
                cmd.append("--no-probes")
            procs.append((arch, shape, subprocess.Popen(cmd)))
            while len([p for *_, p in procs if p.poll() is None]) >= args.jobs:
                time.sleep(0.5)
        for arch, shape, p in procs:
            p.wait()
            print(f"[{arch} x {shape}] rc={p.returncode}")
        return 0

    todo = cells() if args.all else [(args.arch, args.shape)]
    recs = []
    for arch, shape in todo:
        t0 = time.time()
        rec = run_cell(arch, shape, probes=not args.no_probes,
                       overrides=overrides or None)
        rec["wall_s"] = round(time.time() - t0, 1)
        _append(args.out, rec)
        recs.append(rec)
        status = "OK" if rec["ok"] else f"FAIL: {rec.get('error')}"
        print(f"[{arch} x {shape}] {status} ({rec['wall_s']}s)", flush=True)
        if rec["ok"]:
            sp = rec["single_pod"]["memory"]
            print(f"    mem/lane: args {sp['argument_gb']:.2f} GB, "
                  f"the {sp['plan']} plan {sp['lane_gb']:.2f} GB "
                  f"(of {CARD}'s 80 GB)", flush=True)
    return 0 if all(r["ok"] for r in recs) else 1


def _append(path: str, rec: dict):
    import fcntl
    import json

    with open(path, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        try:
            data = json.load(f)
        except (json.JSONDecodeError, ValueError):
            data = []
        data = [r for r in data
                if not (r["arch"] == rec["arch"] and r["shape"] == rec["shape"])]
        data.append(rec)
        f.seek(0)
        f.truncate()
        json.dump(data, f, indent=1)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
