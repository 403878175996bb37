"""The partition of the sharded train and serve steps: what each lane of
a (data, model) `LaneMesh` computes, laid out as the reference's
parameter and cache specs and ``constrain`` hints lay out XLA's
partitioned steps.

**Weights, a period at a time over ``data``** (ZeRO-3, ``fsdp`` ->
``data``).  The step hands the model's leaves in as `Proxies`: each
`Sharded` leaf's shards as autograd leaves sharing the shards' storage.
A lane gathers a leaf (`sharding.gather` over the batch axes: its
``model`` slice, every ``data`` row) only inside the function of the
period that reads it (`run_stack`'s ``params`` callables), cast to the
compute dtype as `models.model.cast_params` casts it; under ``remat ==
"full"`` the gathered weights are not kept for the backward pass but
gathered again in the recompute.  The gather's backward gives each shard
its gradient as a tensor of its own (`_Gather`), so no lane builds the
gradient of a leaf it did not gather.  The top-level leaves (embedding,
head, final and encoder norms, ``pos_embed``) are gathered once a pass
(a data group's rows, or a microbatch of them) and kept until its
backward pass ends.

**Products split over ``model``** (`GroupPlan`), each model lane of a
data group computing its share of the group's rows.  The forward pass
is the model's own (`LM.loss` / `EncDec.loss`): the plan hands it a
`models.model.Layout` (`GroupPlan.layout`) whose periods, blocks,
embedding and loss are the lanes' shares:

* attention, self and cross: with ``K % M == 0`` (the reference's
  ``_heads_shardable``) lane ``m`` takes ``H/M`` query heads and the
  ``K/M`` KV heads they read, its columns of ``wq``/``wk``/``wv`` (and
  biases) and rows of ``wo``, and returns its partial output; otherwise
  the reference's ``ctx`` mode, ``S/M`` query rows a lane against the
  whole K/V on whole weights;
* the MLP: columns of ``wi_gate``/``wi_up``, rows of ``wo``;
* MoE: experts over ``model``; the router, dispatch and combine are
  computed whole on every lane, each runs its experts and its share of
  the shared MLP; the auxiliary losses are lane 0's alone;
* embedding and head: vocabulary over ``model``; the lookup is masked to
  the lane's rows and summed, the loss is a vocab-parallel cross entropy
  (max, then the sum of exponentials, then the label's logit, each
  across the lanes), so the ``(B, S, V)`` logits are never on one lane;
* Mamba2, with ``ssm_heads % M == 0``: lane ``m`` takes ``H/M`` heads.
  ``in_proj`` packs ``[z, x, B, C, dt]`` in one dim and ``conv`` ``[x,
  B, C]``, so a lane gathers several column ranges of each (its heads'
  ``z``, ``x`` and ``dt`` columns and all of ``B`` and ``C``: one B/C
  group; `mamba2.head_columns`), wherever the shards at rest cut them,
  and computes the B/C convolution and the ``C B^T`` scores in full; the
  per-head leaves and ``ssm_norm`` by head, ``out_proj``'s rows.
  ``ssm_norm`` is an RMS norm over all ``d_in`` channels: each lane
  sends its float32 sum of squares, home adds them in lane order and
  divides by ``d_in``, and each lane scales its channels by the result
  and returns its partial output (two rounds, `GroupPlan._mamba`).

**Row blocks** (``cfg.seq_parallel``, the reference's "activations stay
token-sharded over 'model' between blocks; weights all-gather instead").
Where the ``M`` model lanes divide a stack's sequence (`GroupPlan.
rows_for`, a stack at a time: whisper's encoder and decoder decide
apart; elsewhere the pass runs as without the setting, as ``constrain``
drops a ``ctx`` that does not divide), the group's hidden state between
blocks is `RowBlocks`: lane ``m`` holds rows ``[m S/M, (m+1) S/M)`` of
every sequence, so a checkpointed period keeps each lane's rows of its
input and no lane the whole.  Each lane gathers a period's leaves whole
(``rows`` mode):

* attention never splits by heads (the reference's ``heads_ok = ... and
  not sp``): each lane projects the K/V of its rows, receives every
  lane's K/V of the keys its rows can attend (causal and window spans in
  whole KV blocks, `GroupPlan._key_span`) and attends its query rows at
  their global positions; cross attention takes the encoder output's
  row blocks, or home's whole output where they do not split;
* the MLP runs on each lane's rows on whole weights (the reference's
  ``(batch, ctx, None)`` hidden state);
* Mamba2 and MoE, whose convolution, scan and routing group cross row
  boundaries, run on the rows joined on home in lane order (as above),
  their output handed back a row block a lane;
* the embedding is looked up on home with the whole table and split;
  each lane norms its rows and takes their logits over the whole
  vocabulary with the whole head (the tied table, gathered on every
  lane), its cross entropy summed in float32, the sums added on home in
  lane order (`GroupPlan.xent_rows`); prefill's last position is the
  last lane's.

Decode (``seq`` 1, whose ``ctx`` the reference drops) runs its MLP whole
on home under the setting and is otherwise unchanged.  The K/V exchange,
the joins and splits count in ``moved``.

Partial outputs are added on the group's first lane ("home") in lane
order, in float32, and cast once; ``ctx`` rows are put side by side.
Where the divisibility guard of `sharding.resolve` left a product's
leaves whole over ``model``, or its split would not give whole heads, the
product runs whole on home.  With ``M == 1`` every product
is the one-device model's own code, so a ``(D, 1)`` step equals the
one-device step with ``microbatches=D`` bit for bit.

**Serving** (`ServePlan`, `GroupPlan.layout`; under ``no_grad``, so
`_Gather` builds no graph and no gradient shard is made).  The
parameters at rest are the train step's shards (`Resting`); the decode
cache is sharded by the reference's ``CACHE_RULES`` (`launch.inputs.
cache_shardings`: rows over ``data``, KV heads over ``model``, the
sequence over ``model`` where the KV heads do not divide it, and over
``data`` at ``B == 1``).  Decode runs the data groups in lockstep, block
by block, each group's rows on its home throughout; the groups meet only
where a MoE routing group spans them, to assign its slots over the
pooled group (`ServePlan._moe`), and to put the tokens together:

* attention, ``heads`` form: each lane projects its heads and, where it
  holds its heads' whole cache, runs `attention` on its shard (written in
  place) and returns its partial output; the *sequence* form (the heads
  do not divide, or ``B == 1``): the query lane (home, or each lane's
  heads) projects q, K and V, the new K/V go to the lane owning ``pos``,
  every lane holding part of the positions returns its float32
  ``(max, sum of exp, acc)`` (`layers.decode_partial`; a lane with no
  valid key gives ``(-inf, 0, 0)``), home adds them by the log-sum-exp
  rule (`layers.combine_partials`), and the query lane applies ``wo``;
  cross attention by heads on the static encoder K/V;
* Mamba2 by head: a lane gathers its region of the conv state (its
  heads' ``x`` channels and all of B and C, across the shards) and its
  heads' SSM state, two rounds as in training, and each channel's new
  state is written back where it lies at rest (B and C's from home);
* the greedy head by vocabulary: each lane returns its slice's largest
  logit and its first index, home keeps the strictly larger lane by lane
  (``argmax``'s first-maximum rule).
Prefill runs each group's rows through the partitioned forward
(`GroupPlan.layout`), then the split greedy head on the last position.
With ``M == 1`` a group computes exactly what one device computes on its
rows (MoE routing aside).

**Lanes and streams.**  Each lane's share is queued on its stream
(`lane_context`, which orders it after home's work); home waits on a
lane's stream before it reads the lane's output (a lane on the lanes'
whose K/V it receives), and every tensor read on a stream other than its
maker's is marked ``record_stream`` for it.  Every period runs in
`GroupPlan.scope`: on home's stream, and at its end (under the setting
home first waits on every lane, whose row blocks it did not read) all
the group's lanes wait on home and the stream the period was entered
from waits on home, so the recompute of a checkpointed period, entered
from whichever lane's backward operation first needs it, is complete on
every stream before any of them reads it.  Autograd runs each backward
operation on its forward operation's stream and orders the streams
itself.  On the CPU and on ``meta`` lanes there are no streams.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from . import sharding
from ..launch.mesh import lane_context
from ..models.layers import (
    F32, attention, combine_partials, decode_partial, decode_qkv, embed, mlp,
    project_kv, rms_norm, unembed,
)
from ..models.model import _STACKED, softmax_xent
from ..models import mamba2, moe as moe_lib

BATCH_AXES = sharding.LOGICAL_TO_PHYSICAL["batch"]


# --------------------------------------------------------------- gathers ---
class Proxies:
    """A step's view of the sharded parameters as autograd leaves: for
    every `Sharded` leaf, a `Sharded` whose shards are ``detach()``-ed
    views of the leaf's shards that require grad (`sharding.gather`
    reads these, so the gradient reaches them).  ``sources[k]`` lists
    leaf ``k``'s distinct shards as ``(lane, slice)``, each from the first
    lane that holds it (`sharding.gather_sources`): the shards a gradient
    is kept for and pooled on."""

    def __init__(self, params):
        from ..optim.adamw import _leaves

        self.leaves = list(_leaves(params))
        self.proxy = [sharding.Sharded(
            [t.detach().requires_grad_() for t in s.shards], s.mesh, s.spec,
            s.shape, s.dtype) for s in self.leaves]
        self.of = {id(s): p for s, p in zip(self.leaves, self.proxy)}
        full = lambda s: tuple(slice(0, n) for n in s.shape)  # noqa: E731
        self.sources = [sharding.gather_sources(s, full(s))
                        for s in self.leaves]
        self.tree = sharding.tree_map(lambda s: self.of[id(s)], params)

    def grad_inputs(self):
        """The autograd leaves a gradient is taken for, leaf by leaf and
        source by source."""
        return [p.shards[i] for p, src in zip(self.proxy, self.sources)
                for i, _ in src]

    def source_of(self, k: int, lane: int) -> int:
        """The index among ``sources[k]`` of the slice lane ``lane`` holds
        of leaf ``k``."""
        s = self.leaves[k]
        want = tuple((x.start, x.stop) for x in sharding.shard_slices(
            s.shape, s.mesh, s.spec, lane))
        for j, (_, sl) in enumerate(self.sources[k]):
            if tuple((x.start, x.stop) for x in sl) == want:
                return j
        raise KeyError(f"lane {lane} holds no source of leaf {k}")


class _Gather(torch.autograd.Function):
    """A leaf's region for one lane, gathered from its proxies and cast;
    the backward gives each proxy (``sources``, one a distinct shard the
    plan reads, in `_distinct` order) its parts of the gradient in the
    leaf's dtype, copied into a tensor of its own."""

    @staticmethod
    def forward(ctx, s, lane, region, dtype, plan, *sources):
        ctx.plan, ctx.dtype = plan, s.dtype
        ctx.sources = [(i, t.shape, t.device)
                       for i, t in zip(_distinct(plan), sources)]
        return sharding.gather(s, lane=lane, region=region, dtype=dtype)

    @staticmethod
    def backward(ctx, grad):
        out = []
        for i, shape, dev in ctx.sources:
            parts = [(at, part) for j, at, part in ctx.plan if j == i]
            whole = len(parts) == 1 and parts[0][1] is None
            t = (torch.empty if whole or dev.type == "meta"
                 else torch.zeros)(shape, dtype=ctx.dtype, device=dev)
            if dev.type != "meta":
                for at, part in parts:
                    (t if part is None else t[part]).copy_(grad[at])
            out.append(t)
        return (None, None, None, None, None, *out)


def _distinct(plan) -> list:
    """The lanes whose shards a gather plan reads, each once, in plan
    order."""
    return list(dict.fromkeys(i for i, _, _ in plan))


# ----------------------------------------------------------------- plan ---
def group_lanes(mesh) -> list:
    """The lanes of each data group (lanes equal on the batch axes), in
    the order of their ``model`` coordinate; groups in row-major order of
    the batch axes."""
    axes = [a for a in BATCH_AXES if a in mesh.axis_names]
    groups: dict = {}
    for i in range(mesh.size):
        groups.setdefault(mesh.group_index(mesh.coords(i), axes),
                          []).append(i)
    return [groups[g] for g in sorted(groups)]


def heads_shardable(n_kv: int, M: int) -> bool:
    """The reference's ``_heads_shardable``: the KV heads split over the
    ``M`` model lanes (else attention splits its query rows, ``ctx``)."""
    return M <= 1 or n_kv % M == 0


def _names_model(spec, dim) -> bool:
    part = spec[dim] if -len(spec) <= dim < len(spec) else None
    return "model" in (part if isinstance(part, tuple) else (part,))


class BlockShare:
    """One block's leaves on each lane of a group (``trees[m]`` holds what
    lane ``m`` gathered) and the mode of each of its products."""

    def __init__(self, trees, modes):
        self.trees = trees
        self.modes = modes


class GroupPlan:
    """One data group's M lanes and how the model's products split over
    them (see the module note).  ``lanes`` are mesh lane indices, home
    first; ``proxies`` the step's `Proxies`.

    It counts what its lanes move: ``moved``, the bytes of lane inputs
    and outputs (`run`); for each lane ``m``, ``gathers[m]`` and
    ``gathered[m]``, the gathers it made and their bytes,
    ``top_bytes[m]``, the bytes of its top-level leaves (a pass), and
    ``period_bytes[m]``, the most bytes it gathered for one period."""

    def __init__(self, model, mesh, lanes, proxies: Proxies):
        self.model = model
        self.cfg = model.cfg
        self.mesh = mesh
        self.lanes = list(lanes)
        self.M = len(self.lanes)
        self.home = mesh.lanes[self.lanes[0]]
        self.proxies = proxies
        self.slice_axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
        self.whole_axes = self.slice_axes + (
            ("model",) if "model" in mesh.axis_names else ())
        self.moved = 0
        self.gathers = [0] * self.M
        self.gathered = [0] * self.M
        self.top_bytes = [0] * self.M
        self.period_bytes = [0] * self.M
        self.sp = bool(self.cfg.seq_parallel) and self.M > 1
        # storage -> (position, storage) of the hidden states the plan made
        # while a count of saved tensors is on (`launch.dryrun`), else None
        self.owner = None

    # -- leaves ---------------------------------------------------------
    def _dtype(self, proxy, stacked: bool):
        if proxy.dtype == F32 and (stacked or proxy.ndim >= 2):
            return self.cfg.compute_dtype
        return proxy.dtype

    def _on(self, m: int):
        """Lane ``m``'s stream; home's work is already on home's."""
        if m == 0:
            return contextlib.nullcontext()
        return lane_context(self.mesh.lanes[self.lanes[m]])

    def _take(self, proxy, m: int, whole: bool, stacked: bool,
              region=None):
        """Leaf ``proxy`` gathered for lane ``m`` through `_Gather`: over
        the batch axes (``whole``: and ``model``), or ``region`` (a slice
        a dim or a tuple of slices laid side by side, whatever shards they
        cut: `sharding.gather_plan`); cast as `cast_params` casts."""
        lane = self.lanes[m]
        if region is None:
            region = sharding.region_slices(
                proxy, lane, self.whole_axes if whole else self.slice_axes)
        plan = sharding.gather_plan(proxy, region)
        out = _Gather.apply(proxy, lane, region, self._dtype(proxy, stacked),
                            plan, *(proxy.shards[i] for i in _distinct(plan)))
        self.gathers[m] += 1
        self.gathered[m] += out.numel() * out.element_size()
        return out

    def _tree(self, tree, m, whole, stacked, rows=None):
        """``tree``'s leaves on lane ``m``: its slice over ``model``, the
        whole leaf, or (``rows``) rows ``start:stop`` of dim 0."""
        if isinstance(tree, dict):
            return {k: self._tree(v, m, whole, stacked, rows)
                    for k, v in tree.items()}
        region = None if rows is None else (slice(*rows),) + tuple(
            slice(0, n) for n in tree.shape[1:])
        return self._take(tree, m, whole, stacked, region)

    def _heads_tree(self, sub, m):
        """Lane ``m``'s Mamba2 mixer in ``heads`` mode: ``ln`` whole, and
        of every other leaf the columns (rows of ``out_proj``) of its
        heads (`mamba2.head_columns`: all of B and C)."""
        Hm = self.cfg.ssm_heads // self.M
        cols = mamba2.head_columns(self.cfg, (m * Hm, (m + 1) * Hm))
        tree = {}
        for k, p in sub.items():
            if k not in cols:
                tree[k] = self._take(p, m, True, True)
                continue
            pieces = tuple(slice(*c) for c in cols[k])
            full = [slice(0, n) for n in p.shape]
            full[0 if k == "out_proj" else -1] = pieces
            tree[k] = self._take(p, m, True, True, tuple(full))
        return tree

    def _vocab_split(self, name) -> bool:
        p = self.proxies.tree.get(name)
        return (self.M > 1 and p is not None
                and _names_model(p.spec, 0 if name == "embed" else 1))

    def top(self) -> list:
        """The top-level leaves on each lane: the vocabulary-split
        embedding and head on every lane, the rest on home only."""
        out = [{} for _ in range(self.M)]
        before = list(self.gathered)
        for m in range(self.M):
            with self._on(m):
                for name, p in self.proxies.tree.items():
                    if name in _STACKED:
                        continue
                    if name in ("embed", "lm_head") \
                            and self._vocab_split(name):
                        out[m][name] = self._take(p, m, False, False)
                    elif m == 0:
                        out[0][name] = self._take(p, 0, True, False)
        self.top_bytes = [a - b for a, b in zip(self.gathered, before)]
        return out

    def rows_for(self, S: int) -> bool:
        """Whether a stack of query length ``S`` holds its hidden state in
        row blocks (`RowBlocks`): under ``cfg.seq_parallel`` where the ``M``
        lanes divide ``S``, the counterpart of ``constrain`` dropping a
        ``ctx`` that does not divide.  It is decided a stack at a time, so
        an encoder and its decoder (whisper) may differ."""
        return self.sp and S % self.M == 0

    def _block_modes(self, block, seq) -> dict:
        """Each product's mode (in decode, with ``seq`` 1, attention that
        does not split by heads is ``home``: `attention_decode`'s sequence
        form).  A stack in row blocks (`rows_for`) runs attention and the
        MLP in ``rows`` mode, every lane on whole weights and its own
        rows; under ``cfg.seq_parallel`` the decode MLP (``seq`` 1, whose
        ``ctx`` the reference drops) is whole on home."""
        cfg, M = self.cfg, self.M
        rows = self.rows_for(seq)
        modes = {}
        for name, sub in block.items():
            if M == 1:
                modes[name] = "home"
            elif name == "mixer_ssm":
                modes[name] = "heads" if _ssm_split(sub, cfg, M) else "home"
            elif name in ("mixer_attn", "cross"):
                heads = heads_shardable(cfg.n_kv_heads, M) and all(
                    _names_model(sub[k].spec, -1) for k in sub
                    if k in ("wq", "wk", "wv", "bq", "bk", "bv")) \
                    and _names_model(sub["wo"].spec, 0)
                modes[name] = ("rows" if rows else "heads" if heads else
                               "ctx" if seq % M == 0 else "home")
            elif name == "ffn_mlp":
                modes[name] = ("rows" if rows else
                               "home" if self.sp and seq == 1 else
                               "split" if _mlp_split(sub) else "home")
            elif name == "ffn_moe":
                split = cfg.n_experts % M == 0
                modes[name] = "split" if split else "home"
                modes["shared"] = ("split" if split and "shared" in sub
                                   and _mlp_split(sub["shared"])
                                   else "home")
        return modes

    def _block_share(self, block, seq) -> BlockShare:
        modes = self._block_modes(block, seq)
        trees = [{} for _ in range(self.M)]
        for m in range(self.M):
            with self._on(m):
                self._lane_share(block, modes, m, trees[m])
        return BlockShare(trees, modes)

    def _lane_share(self, block, modes, m, tree):
        """What lane ``m`` gathers of ``block`` under ``modes``, into
        ``tree``."""
        for name, sub in block.items():
            mode = modes[name]
            if mode == "home":
                if m == 0:
                    tree[name] = self._tree(sub, 0, True, True)
            elif name == "mixer_ssm":
                tree[name] = self._heads_tree(sub, m)
            elif name == "ffn_moe":
                Em = self.cfg.n_experts // self.M
                t = {"ln": self._tree(sub["ln"], m, True, True),
                     "router": self._tree(sub["router"], m, True, True),
                     "experts": self._tree(sub["experts"], m, True, True,
                                           (m * Em, (m + 1) * Em))}
                if "shared" in sub and (modes["shared"] == "split" or m == 0):
                    t["shared"] = self._tree(
                        sub["shared"], m, modes["shared"] == "home", True)
                tree[name] = t
            else:
                tree[name] = self._tree(sub, m, mode in ("ctx", "rows"),
                                        True)

    def _period(self, ptree, seq, *, shares=False):
        """A period's leaves gathered on the lanes that use them: the
        one-device tree when ``M == 1`` (unless ``shares``), else a
        `BlockShare` a block (``seq``: the stack's query length, which
        picks ``ctx`` mode)."""
        before = list(self.gathered)
        if self.M == 1 and not shares:
            out = self._tree(ptree, 0, True, True)
        else:
            out = {b: self._block_share(block, seq)
                   for b, block in ptree.items()}
        self.period_bytes = [max(p, a - b) for p, a, b in zip(
            self.period_bytes, self.gathered, before)]
        return out

    def stack(self, name, seq) -> list:
        """Stack ``name``'s periods as `run_stack` callables."""
        tree = self.proxies.tree
        tree = tree[name] if name == "enc_stack" else tree["stacks"][name]
        return [functools.partial(self._period, p, seq) for p in tree]

    def stack_kw(self) -> dict:
        if self.M == 1:
            return {}
        return dict(block_fn=self.block, scope=self.scope)

    def layout(self, model):
        """A pass's `models.model.Layout` on the group's lanes (the
        ``layout`` of `LM.loss` / `EncDec.loss`, and of the partitioned
        prefill's `LM._hidden`): its top-level leaves gathered once."""
        return _Layout(self)

    # -- lanes ----------------------------------------------------------
    @contextlib.contextmanager
    def scope(self):
        """A period's run (see the module note): on home's stream, every
        lane of the group and the entering stream ordered after it."""
        if self.home.stream is None:
            yield
            return
        entry = torch.cuda.current_stream(self.home.device)
        with lane_context(self.home):
            yield
        if self.sp:
            # row blocks are made on the lanes' streams: home first
            # waits on them all
            for i in self.lanes[1:]:
                self.home.stream.wait_stream(self.mesh.lanes[i].stream)
        for i in self.lanes[1:]:
            self.mesh.lanes[i].stream.wait_stream(self.home.stream)
        entry.wait_stream(self.home.stream)

    def run(self, fn, *shared, lanes=None) -> list:
        """``fn(m, *shared)`` on every lane ``m`` of the group (or of
        ``lanes``, mesh lane indices, ``m`` their position), queued on its
        stream; each result (a tensor or a tuple of them) brought back to
        home."""
        home_stream = (torch.cuda.current_stream(self.home.device)
                       if self.home.stream is not None else None)
        group = self.lanes if lanes is None else lanes
        order = (self._order(range(len(group))) if lanes is None
                 else range(len(group)))
        outs = [None] * len(group)
        for m in order:
            lane = self.mesh.lanes[group[m]]
            outs[m] = self._lane_run(m, fn, shared, group[m])
            if lane.stream is not None and lane.stream != home_stream:
                home_stream.wait_stream(lane.stream)
        return [_back(o, self.home, home_stream) for o in outs]

    def _order(self, positions) -> list:
        """The group's positions in the order their shares run: as given
        (the dry-run's sampled plan runs first the lane that stands for
        the others)."""
        return list(positions)

    def _lane_run(self, m, fn, shared, i, local=False):
        """The share of `run` at position ``m``, on mesh lane ``i``'s
        stream (``local``: on inputs the lane holds, its output kept
        there: no bytes counted in ``moved``)."""
        lane = self.mesh.lanes[i]
        with lane_context(lane):
            out = fn(m, *(_share(t, lane) for t in shared))
        if i != self.lanes[0] and not local:
            self.moved += sum(_nbytes(t) for t in (*shared, out))
        return out

    # -- row blocks (cfg.seq_parallel) ------------------------------------
    def _own(self, parts, lanes):
        """Marks ``parts`` as hidden states of the lanes at ``lanes``
        (positions) while a count of saved tensors is on."""
        if self.owner is None:
            return
        at = dict(zip(lanes, parts))
        for m in self._order(lanes):
            st = at[m].untyped_storage()
            self.owner.setdefault(st._cdata, (m, st))

    def _each(self, fn, *args) -> list:
        """``fn(m, *parts)`` on each lane ``m`` of the row blocks ``args``
        (`RowBlocks` on the same lanes), queued on its stream; the results
        stay on the lanes."""
        lanes = args[0].lanes
        out = [None] * len(lanes)
        for m in self._order(lanes):
            j = lanes.index(m)
            out[j] = self._lane_run(m, fn, tuple(a.parts[j] for a in args),
                                    self.lanes[m], local=True)
        return out

    def _hand(self, t, rows=None):
        """Home's tensor ``t`` read on every lane: whole, or (``rows``)
        lane ``m``'s rows ``[m rows, (m+1) rows)`` of dim 1, as views."""
        parts = [t if rows is None else t[:, m * rows:(m + 1) * rows]
                 for m in range(self.M)]
        return RowBlocks(parts, tuple(range(self.M)), self.home.device)

    def split(self, x):
        """Home's hidden state ``x`` (B, S, d) as row blocks: lane ``m``
        copies rows ``[m S/M, (m+1) S/M)`` of every sequence on its
        stream into a tensor of its own."""
        def take(m, t):
            if m:
                self.moved += _nbytes(t)
            return t.clone(memory_format=torch.contiguous_format)

        r = x.shape[1] // self.M
        parts = [None] * self.M
        for m in self._order(range(self.M)):
            parts[m] = self._lane_run(m, take, (x[:, m * r:(m + 1) * r],),
                                      self.lanes[m], local=True)
        return RowBlocks(parts, tuple(range(self.M)), self.home.device)

    def _to_home(self, parts, lanes) -> list:
        """The lanes' ``parts`` (at positions ``lanes``) on home, home's
        stream ordered after theirs."""
        home_stream = (torch.cuda.current_stream(self.home.device)
                       if self.home.stream is not None else None)
        for t, m in zip(parts, lanes):
            lane = self.mesh.lanes[self.lanes[m]]
            if lane.stream is not None and lane.stream != home_stream:
                home_stream.wait_stream(lane.stream)
            if m:
                self.moved += _nbytes(t)
        return [_back(t, self.home, home_stream) for t in parts]

    def join(self, x):
        """Row blocks ``x`` put together on home in lane order (B, S,
        d)."""
        return torch.cat(self._to_home(x.parts, x.lanes), dim=1)

    def _exchange(self, parts, src, spans) -> list:
        """``parts`` (made on the group's lanes ``src``, positions) put
        side by side along dim 1 in lane order, cut to ``spans[m]`` (a
        range of the whole) on each lane ``m`` of the group: each lane
        receives the parts of its range, its stream ordered after
        theirs."""
        ends = [0]
        for t in parts:
            ends.append(ends[-1] + t.shape[1])
        out = [None] * self.M
        for m in self._order(range(self.M)):
            lo, hi = spans[m]
            take = [(j, max(lo, a) - a, min(hi, b) - a) for j, a, b in zip(
                src, ends, ends[1:]) if max(lo, a) < min(hi, b)]
            lane = self.mesh.lanes[self.lanes[m]]
            for j, _, _ in take:
                other = self.mesh.lanes[self.lanes[j]]
                if lane.stream is not None and other.stream != lane.stream:
                    lane.stream.wait_stream(other.stream)

            def cat(m, *ts, take=take):
                ts = [t[:, a:b] for t, (_, a, b) in zip(ts, take)]
                self.moved += sum(_nbytes(t) for (j, _, _), t in zip(take, ts)
                                  if j != m)
                return torch.cat(ts, dim=1)

            out[m] = self._lane_run(
                m, cat, tuple(parts[src.index(j)] for j, _, _ in take),
                self.lanes[m], local=True)
        return out

    def _residual(self, x, out):
        parts = self._each(lambda m, a, b: a + b, x, out)
        self._own(parts, x.lanes)
        return x.like(parts)

    @staticmethod
    def sum(outs):
        """Partial outputs added in lane order in float32, cast once."""
        acc = outs[0].to(F32)
        for o in outs[1:]:
            acc = acc + o.to(F32)
        return acc.to(outs[0].dtype)

    # -- blocks ---------------------------------------------------------
    def block(self, share, x, spec, cfg, *, positions, enc_out=None,
              cache=None, decode=False):
        """`transformer.apply_block` on a group's lanes (``M > 1``)."""
        if decode:
            raise NotImplementedError("the partitioned forward trains only")
        if isinstance(x, RowBlocks) or self.rows_for(x.shape[1]):
            if not isinstance(x, RowBlocks):
                x = self.split(x)
            return self._rows_block(share, x, spec, cfg, positions, enc_out)
        if isinstance(enc_out, RowBlocks):
            enc_out = self.join(enc_out)
        mixer, ffn = spec
        aux = None
        if mixer == "mamba":
            out = self._mamba(share, x)
        else:
            out = self._attention(
                share, "mixer_attn", x, positions, None, None,
                causal=mixer != "attn_enc",
                window=cfg.window if mixer == "attn_local" else None)
        x = x + out
        if "cross" in share.modes:
            S_kv = enc_out.shape[1]
            x = x + self._attention(
                share, "cross", x, positions, enc_out,
                torch.arange(S_kv, device=x.device)[None, :], causal=False,
                window=None)
        if ffn == "mlp":
            x = x + self._mlp(share, "ffn_mlp", x)
        elif ffn == "moe":
            out, aux = self._moe(share, x)
            x = x + out
        self._own([x], (0,))
        return x, aux, {}

    def _rows_block(self, share, x, spec, cfg, positions, enc_out):
        """`block` on row blocks ``x`` (`RowBlocks`): attention and the
        MLP on each lane's rows, Mamba2 and MoE on the rows put together
        on home (their convolution, scan and routing group cross row
        boundaries) and handed back; the residual adds on each lane."""
        mixer, ffn = spec
        aux = None
        if mixer == "mamba":
            out = self.split(self._mamba(share, self.join(x)))
        else:
            out = self._rows_attention(
                share, "mixer_attn", x, positions, None,
                causal=mixer != "attn_enc",
                window=cfg.window if mixer == "attn_local" else None)
        x = self._residual(x, out)
        if "cross" in share.modes:
            x = self._residual(x, self._rows_attention(
                share, "cross", x, positions, enc_out, causal=False,
                window=None))
        if ffn == "mlp":
            trees = [t.get("ffn_mlp") for t in share.trees]
            x = self._residual(x, x.like(self._each(
                lambda m, xm: mlp(trees[m], xm, cfg=cfg), x)))
        elif ffn == "moe":
            out, aux = self._moe(share, self.join(x))
            x = self._residual(x, self.split(out))
        return x, aux, {}

    def _rows_attention(self, share, name, x, positions, kv, *, causal,
                        window):
        """Attention in ``rows`` mode, the reference's ``ctx`` on row
        blocks: each lane projects the K/V of its rows (cross attention:
        of its rows of the source, or home of the whole source where they
        do not split), every lane receives them in lane order (of self
        attention, the keys its rows can attend: `_key_span`), and each
        attends its query rows, at their global positions, to them and
        keeps its output rows."""
        cfg = self.cfg
        trees = [t.get(name) for t in share.trees]
        r = x.parts[0].shape[1]
        pos = self._hand(positions, r)
        n_kv = cfg.n_kv_heads
        if kv is None:
            kvs = self._each(lambda m, xm, pm: project_kv(
                trees[m], rms_norm(trees[m]["ln"], xm, eps=cfg.norm_eps),
                cfg=cfg, n_kv=n_kv, positions=pm), x, pos)
            src, kpos = list(range(self.M)), positions
            spans = [self._key_span(m * r, (m + 1) * r, positions.shape[1],
                                    causal, window) for m in range(self.M)]
        else:
            S_kv = kv.shape[1]
            if not isinstance(kv, RowBlocks) and S_kv % self.M == 0:
                kv = self._hand(kv, S_kv // self.M)
            if isinstance(kv, RowBlocks):
                kvs = self._each(lambda m, s: project_kv(
                    trees[m], s, cfg=cfg, n_kv=n_kv), kv)
                src = list(kv.lanes)
            else:
                kvs, src = [project_kv(trees[0], kv, cfg=cfg, n_kv=n_kv)], [0]
            kpos = torch.arange(S_kv, device=self.home.device)[None, :]
            spans = [(0, S_kv)] * self.M
        lanes = tuple(range(self.M))
        k = RowBlocks(self._exchange([a for a, _ in kvs], src, spans),
                      lanes, x.device)
        v = RowBlocks(self._exchange([b for _, b in kvs], src, spans),
                      lanes, x.device)
        kp = RowBlocks([kpos[:, lo:hi] for lo, hi in spans], lanes, x.device)
        self_attn = kv is None
        return x.like(self._each(
            lambda m, xm, pm, km, vm, kpm: attention(
                trees[m], xm, cfg=cfg, positions=pm,
                kv=None if self_attn else km, kv_positions=kpm,
                kv_proj=(km, vm), causal=causal, window=window)[0],
            x, pos, k, v, kp))

    def _key_span(self, a, b, S, causal, window):
        """The keys query rows ``[a, b)`` of self attention can attend
        (causal: none after ``b``; a window: none ``window`` or more
        before ``a``), widened to whole blocks of ``cfg.attn_kv_block``
        (so a long span keeps the blockwise form): the other keys are
        masked for every row, so a lane neither receives nor scores them
        (the reference's window block skip, as row blocks give it)."""
        kb = self.cfg.attn_kv_block
        lo = max(0, a - window + 1) if window is not None else 0
        hi = b if causal else S
        return (lo // kb) * kb, min(S, -(-hi // kb) * kb)

    def _attention(self, share, name, x, positions, kv, kv_positions, *,
                   causal, window):
        cfg, M = self.cfg, self.M
        mode = share.modes[name]
        trees = [t.get(name) for t in share.trees]
        kw = dict(cfg=cfg, causal=causal, window=window)
        if mode == "home":
            return attention(trees[0], x, positions=positions, kv=kv,
                             kv_positions=kv_positions, **kw)[0]
        if mode == "heads":
            hk = (cfg.n_heads // M, cfg.n_kv_heads // M)
            return self.sum(self.run(
                lambda m, x, pos, kv, kpos: attention(
                    trees[m], x, positions=pos, kv=kv, kv_positions=kpos,
                    heads=hk, **kw)[0],
                x, positions, kv, kv_positions))
        # ctx: each lane projects the K/V of its rows (of the query rows,
        # or of the source's when they split), home puts them side by side
        rows = x.shape[1] // M
        src_rows = rows if kv is None else (
            kv.shape[1] // M if kv.shape[1] % M == 0 else None)

        def kv_share(m, x, pos, kv):
            if src_rows is None and m:
                return None
            r = (slice(None) if src_rows is None else
                 slice(m * src_rows, (m + 1) * src_rows))
            if kv is not None:
                return project_kv(trees[m], kv[:, r], cfg=cfg,
                                  n_kv=cfg.n_kv_heads)
            xn = rms_norm(trees[m]["ln"], x[:, r], eps=cfg.norm_eps)
            return project_kv(trees[m], xn, cfg=cfg, n_kv=cfg.n_kv_heads,
                              positions=pos[:, r])

        parts = [p for p in self.run(kv_share, x, positions, kv)
                 if p is not None]
        k = torch.cat([p[0] for p in parts], dim=1)
        v = torch.cat([p[1] for p in parts], dim=1)
        return torch.cat(self.run(
            lambda m, x, pos, kv, kpos, k, v: attention(
                trees[m], x, positions=pos, kv=kv, kv_positions=kpos,
                q_rows=(m * rows, (m + 1) * rows), kv_proj=(k, v),
                **kw)[0],
            x, positions, kv, kv_positions, k, v), dim=1)

    def _mamba(self, share, x):
        """The Mamba2 mixer; in ``heads`` mode in two rounds: each lane's
        gated SSD of its heads and its float32 sum of squares, added on
        home in lane order into ``ssm_norm``'s mean over all ``d_in``
        channels; then each lane's channels scaled by it times its rows
        of ``out_proj``, the partial outputs added."""
        cfg = self.cfg
        trees = [t.get("mixer_ssm") for t in share.trees]
        if share.modes["mixer_ssm"] == "home":
            return mamba2.mamba_mixer(trees[0], x, cfg=cfg)
        gated = [None] * self.M

        def lane_sumsq(m, x):
            gated[m] = mamba2.mamba_gated(trees[m], x, cfg=cfg)
            return mamba2.gated_sumsq(gated[m])

        d_in = cfg.ssm_expand * cfg.d_model
        ss = self.sum(self.run(lane_sumsq, x))
        inv = torch.rsqrt(ss / d_in + cfg.norm_eps)
        out = self.sum(self.run(lambda m, inv: mamba2.mamba_project(
            trees[m], gated[m], inv), inv))
        gated.clear()
        return out

    def _mlp(self, share, name, x):
        trees = [t.get(name) for t in share.trees]
        if share.modes[name] == "home":
            return mlp(trees[0], x, cfg=self.cfg)
        return self.sum(self.run(
            lambda m, x: mlp(trees[m], x, cfg=self.cfg), x))

    def _moe(self, share, x, group_size=None, assigned=None):
        """MoE over experts; ``group_size`` and ``assigned`` as in
        `moe.moe` (the partitioned decode's routing over the whole
        batch)."""
        cfg = self.cfg
        trees = [t.get("ffn_moe") for t in share.trees]
        kw = dict(cfg=cfg, group_size=group_size)
        if share.modes["ffn_moe"] == "home":
            return moe_lib.moe(trees[0], x, assigned=assigned, **kw)
        Em = cfg.n_experts // self.M
        outs = self.run(lambda m, x, a: moe_lib.moe(
            trees[m], x, experts=(m * Em, (m + 1) * Em), with_aux=m == 0,
            assigned=a, **kw), x, assigned)
        return self.sum([o for o, _ in outs]), outs[0][1]

    def route(self, share, x, group_size):
        """Each of ``x``'s tokens' experts (`moe.route`), on home."""
        tree = share.trees[0]["ffn_moe"]
        return moe_lib.route(tree, x, cfg=self.cfg, group_size=group_size)

    # -- decode ---------------------------------------------------------
    def _cache_view(self, s, lane, region):
        """Lane ``lane``'s shard of cache leaf ``s`` cut to ``region``
        (slices of the whole leaf, which the shard must hold): a view, so
        a write to it writes the shard."""
        own = sharding.shard_slices(s.shape, s.mesh, s.spec, lane)
        if any(r.start < o.start or r.stop > o.stop
               for r, o in zip(region, own)):
            raise ValueError(f"lane {lane} holds {own} of {s}, not {region}")
        return s.shards[lane][sharding.within(region, own)]

    def attention_decode(self, share, name, x, positions, cache, rows, *,
                         window):
        """One decode step of self attention ``name`` on the group's rows
        ``rows`` of the sharded cache ``cache`` (``k``, ``v``: `Sharded`
        (B, S, K, hd); ``pos``).  Each query lane (every lane's heads in
        ``heads`` mode, home's all heads otherwise) finds the lanes that
        hold its heads' cache: where that is itself, whole over the
        positions, it runs `attention` on its shard (written in place);
        else the new K/V go to the lane owning ``pos`` (and its replicas),
        each holder returns its `decode_partial`, home adds them by the
        log-sum-exp rule, and the query lane applies its rows of ``wo``.
        The query lanes' partial outputs are added on home."""
        cfg = self.cfg
        trees = [t.get(name) for t in share.trees]
        ks, vs, pos = cache["k"], cache["v"], cache["pos"]
        B, S, K, hd = ks.shape
        r = slice(*rows)
        heads = share.modes[name] == "heads"
        qlanes = self.lanes if heads else self.lanes[:1]
        Kq = K // len(qlanes)
        hk = (cfg.n_heads // len(qlanes), Kq)
        holders = []
        for m, lane in enumerate(qlanes):
            region = (r, slice(0, S), slice(m * Kq, (m + 1) * Kq),
                      slice(0, hd))
            src = sharding.gather_sources(ks, region)
            if any((x.start, x.stop) != (y.start, y.stop)
                   for _, sl in src for j, (x, y) in enumerate(
                       zip(sl, region)) if j != 1):
                raise ValueError(f"{ks}: a lane holds part of the rows or "
                                 "heads of a query lane's cache")
            holders.append([(i, (sl[1].start, sl[1].stop)) for i, sl in src])
        if all(h == [(lane, (0, S))] for h, lane in zip(holders, qlanes)):
            def local(m, x, pos_t):
                lane = qlanes[m]
                region = (r, slice(0, S), slice(m * Kq, (m + 1) * Kq),
                          slice(0, hd))
                c = {"k": self._cache_view(ks, lane, region),
                     "v": self._cache_view(vs, lane, region), "pos": pos}
                return attention(trees[m], x, cfg=cfg, positions=pos_t,
                                 window=window, cache=c,
                                 heads=hk if heads else None)[0]
            outs = self.run(local, x, positions, lanes=qlanes)
            return outs[0] if len(outs) == 1 else self.sum(outs)
        qkv = self.run(lambda m, x, pos_t: decode_qkv(
            trees[m], x, cfg=cfg, positions=pos_t,
            heads=hk if heads else None), x, positions, lanes=qlanes)
        combined = []
        for m, ((q, k, v), hold) in enumerate(zip(qkv, holders)):
            kh = slice(m * Kq, (m + 1) * Kq)
            at = (r, slice(pos, pos + 1), kh, slice(0, hd))
            sharding.scatter(ks, at, k)
            sharding.scatter(vs, at, v)

            def part(j, q, hold=hold, kh=kh):
                lane, (s0, s1) = hold[j]
                region = (r, slice(s0, s1), kh, slice(0, hd))
                return decode_partial(
                    q, self._cache_view(ks, lane, region),
                    self._cache_view(vs, lane, region), s0=s0, pos=pos,
                    window=window)
            parts = self.run(part, q, lanes=[i for i, _ in hold])
            combined.append(combine_partials(parts, v.dtype))
        outs = [self.run(lambda _, o, m=m: o.reshape(
            o.shape[0], o.shape[1], -1) @ trees[m]["wo"], o,
            lanes=[lane])[0] for m, (lane, o) in enumerate(zip(qlanes,
                                                            combined))]
        return outs[0] if len(outs) == 1 else self.sum(outs)

    def cross_decode(self, share, x, positions, cache, rows):
        """Cross attention on the static encoder K/V of the group's rows
        (``cache``: `Sharded` ``k``, ``v``, (B, S_enc, K, hd)), by heads
        where they split, else whole on home."""
        cfg = self.cfg
        trees = [t.get("cross") for t in share.trees]
        ks, vs = cache["k"], cache["v"]
        B, S, K, hd = ks.shape
        heads = share.modes["cross"] == "heads"
        qlanes = self.lanes if heads else self.lanes[:1]
        Kq = K // len(qlanes)

        def lane_cross(m, x, pos_t):
            region = (slice(*rows), slice(0, S),
                      slice(m * Kq, (m + 1) * Kq), slice(0, hd))
            kv = {"k": self._cache_view(ks, qlanes[m], region),
                  "v": self._cache_view(vs, qlanes[m], region)}
            return attention(trees[m], x, cfg=cfg, positions=pos_t,
                             causal=False, static_kv=kv,
                             heads=(cfg.n_heads // len(qlanes), Kq)
                             if heads else None)[0]
        outs = self.run(lane_cross, x, positions, lanes=qlanes)
        return outs[0] if len(outs) == 1 else self.sum(outs)

    def mamba_decode(self, share, x, cache, rows):
        """One decode step of the Mamba2 mixer on the group's rows of the
        sharded ``conv`` (B, W-1, conv_dim) and ``ssm`` (B, H, N, P)
        states.  In ``heads`` mode each lane gathers its region of the
        conv state (its heads' ``x`` channels and all of B and C, across
        whatever shards hold them) and its heads' SSM state, and the two
        rounds of `_mamba` (sums of squares, then ``ssm_norm`` and
        ``out_proj``) follow; else the mixer runs whole on home.  The new
        states are written back to every lane holding them: each channel's
        from the lane that computed it (B and C's from home)."""
        cfg = self.cfg
        trees = [t.get("mixer_ssm") for t in share.trees]
        conv, ssm = cache["conv"], cache["ssm"]
        d_in, H, P, N, conv_dim = mamba2._dims(cfg)
        r, W = slice(*rows), conv.shape[1]
        if share.modes["mixer_ssm"] == "home":
            c = {"conv": sharding.gather(conv, lane=self.lanes[0], region=(
                r, slice(0, W), slice(0, conv_dim))),
                 "ssm": sharding.gather(ssm, lane=self.lanes[0], region=(
                     r, slice(0, H), slice(0, N), slice(0, P)))}
            out, nc = mamba2.mamba_decode(trees[0], x, c, cfg=cfg)
            _widen(conv, nc["conv"].dtype)
            sharding.scatter(conv, (r, slice(0, W), slice(0, conv_dim)),
                             nc["conv"])
            sharding.scatter(ssm, (r, slice(0, H), slice(0, N),
                                   slice(0, P)), nc["ssm"])
            return out
        Hm = H // self.M
        gated = [None] * self.M

        def lane_sumsq(m, x):
            ch = (slice(m * Hm * P, (m + 1) * Hm * P), slice(d_in, conv_dim))
            lane = self.lanes[m]
            cw = sharding.gather(conv, lane=lane,
                                 region=(r, slice(0, W), ch))
            st = sharding.gather(ssm, lane=lane, region=(
                r, slice(m * Hm, (m + 1) * Hm), slice(0, N), slice(0, P)))
            gated[m], new_conv, new_ssm = mamba2.mamba_decode_gated(
                trees[m], x, cw, st, cfg=cfg)
            return mamba2.gated_sumsq(gated[m]), new_conv, new_ssm

        outs = self.run(lane_sumsq, x)
        ss = self.sum([o[0] for o in outs])
        inv = torch.rsqrt(ss / d_in + cfg.norm_eps)
        out = self.sum(self.run(lambda m, inv: mamba2.mamba_project(
            trees[m], gated[m], inv), inv))
        gated.clear()
        _widen(conv, outs[0][1].dtype)
        for m, (_, new_conv, new_ssm) in enumerate(outs):
            sharding.scatter(conv, (r, slice(0, W), slice(
                m * Hm * P, (m + 1) * Hm * P)), new_conv[..., :Hm * P])
            sharding.scatter(ssm, (r, slice(m * Hm, (m + 1) * Hm),
                                   slice(0, N), slice(0, P)), new_ssm)
        sharding.scatter(conv, (r, slice(0, W), slice(d_in, conv_dim)),
                         outs[0][1][..., Hm * P:])
        return out[:, None, :]

    # -- embedding and loss ---------------------------------------------
    def embed(self, top, tokens):
        """The embedding of ``tokens`` from lanes' top-level leaves
        ``top``: a lookup masked to a lane's vocabulary rows, summed over
        the lanes, where the table splits."""
        cfg = self.cfg
        if not self._vocab_split("embed"):
            return embed(top[0]["embed"], tokens, cfg)
        Vm = cfg.vocab_size // self.M

        def part(m, tok):
            local = tok - m * Vm
            ok = (local >= 0) & (local < Vm)
            rows = top[m]["embed"][torch.clamp(local, 0, Vm - 1)]
            rows = rows.to(cfg.compute_dtype)
            return torch.where(ok[..., None], rows, torch.zeros_like(rows))

        x = self.sum(self.run(part, tokens))
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)

    def xent(self, top, xf, window, labels):
        """Mean next-token cross entropy in float32 of the rows
        ``window`` of the head's logits against ``labels``
        (`models.model.softmax_xent`), vocab-parallel when the head
        splits over ``model``."""
        cfg = self.cfg
        tied = cfg.tie_embeddings and not cfg.is_encoder_decoder
        head = "embed" if tied else "lm_head"
        w0, w1 = window
        if not self._vocab_split(head):
            logits = unembed(top[0][head], xf, cfg, tied=tied)
            return softmax_xent(logits[:, w0:w1, :], labels)
        Vm = cfg.vocab_size // self.M
        lgs = [None] * self.M

        def lane_max(m, xf):
            lgs[m] = unembed(top[m][head], xf, cfg, tied=tied)[
                :, w0:w1, :].to(F32)
            return torch.amax(lgs[m].detach(), dim=-1)

        mx = torch.amax(torch.stack(self.run(lane_max, xf)), dim=0)

        def lane_sums(m, mx, lab):
            lg = lgs[m]
            se = torch.sum(torch.exp(lg - mx[..., None]), dim=-1)
            local = lab - m * Vm
            ok = (local >= 0) & (local < Vm)
            ll = torch.gather(lg, -1, torch.clamp(local, 0, Vm - 1)[
                ..., None])[..., 0]
            return se, torch.where(ok, ll, torch.zeros_like(ll))

        parts = self.run(lane_sums, mx, labels.long())
        lgs.clear()
        se = self.sum([s for s, _ in parts])
        ll = self.sum([x for _, x in parts])
        return torch.mean(torch.log(se) + mx - ll)


    def top_leaf(self, name, m, whole):
        """Top-level leaf ``name`` gathered for lane ``m``, whole or its
        slice over ``model``, on its stream, counted in ``top_bytes``."""
        before = self.gathered[m]
        with self._on(m):
            out = self._take(self.proxies.tree[name], m, whole, False)
        self.top_bytes[m] += self.gathered[m] - before
        return out

    def norm_rows(self, scales, x):
        """Each lane's rows of ``x`` (`RowBlocks`) RMS-normed by its copy
        of the scale (``scales[m]``)."""
        eps = self.cfg.norm_eps
        return x.like(self._each(
            lambda m, xm: rms_norm(scales[m], xm, eps=eps), x))

    def xent_rows(self, top, xf, window, labels):
        """`xent` on row blocks: each lane's logits of its rows over the
        whole vocabulary (the reference's ``(batch, ctx, None)``), the
        float32 sum of its rows' cross entropies within ``window``, the
        sums added on home in lane order and divided by the count."""
        cfg = self.cfg
        head, tied = self._head_name()
        heads = {m: top[m][head] for m in xf.lanes}
        w0, w1 = window
        r = xf.parts[0].shape[1]
        span = {m: (max(m * r, w0), max(min((m + 1) * r, w1), w0))
                for m in xf.lanes}
        labs = RowBlocks([labels[:, span[m][0] - w0:span[m][1] - w0]
                          for m in xf.lanes], xf.lanes, xf.device)

        def part(m, x, lab):
            lo, hi = span[m]
            if hi <= lo:
                return torch.zeros((), dtype=F32, device=x.device)
            lg = unembed(heads[m], x[:, lo - m * r:hi - m * r], cfg,
                         tied=tied).to(F32)
            ll = torch.gather(lg, -1, lab[..., None].long())[..., 0]
            return torch.sum(torch.logsumexp(lg, dim=-1) - ll)

        sums = self._to_home(self._each(part, xf, labs), xf.lanes)
        return self.sum(sums) / (labels.shape[0] * (w1 - w0))

    def greedy_rows(self, top, xf):
        """`greedy` on row blocks: each lane's rows' first largest logit
        over the whole vocabulary, the tokens put together on home."""
        head, tied = self._head_name()
        heads = {m: top[m][head] for m in xf.lanes}
        outs = self._each(lambda m, x: torch.argmax(
            unembed(heads[m], x, self.cfg, tied=tied), dim=-1), xf)
        return torch.cat(self._to_home(outs, xf.lanes), dim=1)

    def _head_name(self):
        cfg = self.cfg
        tied = cfg.tie_embeddings and not cfg.is_encoder_decoder
        return ("embed" if tied else "lm_head"), tied

    def logits(self, top, xf):
        """The head's logits of ``xf`` on home, put together from the
        lanes' vocabulary slices where the head splits (for checking a
        step: the serve steps return `greedy`'s tokens)."""
        head, tied = self._head_name()
        if not self._vocab_split(head):
            return unembed(top[0][head], xf, self.cfg, tied=tied)
        return torch.cat(self.run(lambda m, xf: unembed(
            top[m][head], xf, self.cfg, tied=tied), xf), dim=-1)

    def greedy(self, top, xf):
        """The first index of the largest logit of each row of ``xf``
        (``argmax``'s rule).  Where the head splits by vocabulary each
        lane returns its slice's largest logit and the first global index
        of it; home keeps, lane by lane, a strictly larger value, so a tie
        goes to the lower index and no lane holds the whole logits."""
        head, tied = self._head_name()
        cfg = self.cfg
        if not self._vocab_split(head):
            return torch.argmax(unembed(top[0][head], xf, cfg, tied=tied),
                                dim=-1)
        Vm = cfg.vocab_size // self.M

        def lane_best(m, xf):
            lg = unembed(top[m][head], xf, cfg, tied=tied)
            idx = torch.argmax(lg, dim=-1, keepdim=True)
            return torch.gather(lg, -1, idx)[..., 0], idx[..., 0] + m * Vm

        parts = self.run(lane_best, xf)
        val, idx = parts[0]
        for v, i in parts[1:]:
            take = v > val
            val, idx = torch.where(take, v, val), torch.where(take, i, idx)
        return idx


class Resting:
    """Sharded parameters as the serve steps read them: ``tree``, the
    parameter tree of `Sharded` leaves (no autograd leaves: the serve
    steps run under ``no_grad``, so `_Gather` builds no graph)."""

    def __init__(self, tree):
        self.tree = tree


class _Rows:
    """A decode step's hidden state on a `ServePlan`: each data group's
    rows on the group's home (``parts``, in group order); ``device`` is
    the first group's home's."""

    def __init__(self, parts, device):
        self.parts, self.device = parts, device


class ServePlan:
    """The partitioned decode step's plan on a mesh: one `GroupPlan` (of
    ``plan_cls``) a data group, ``rows`` rows each, run in lockstep, block
    by block, so a MoE routing group may span data groups as the
    reference routes the whole batch.  ``B == 1`` is one group (data row
    0's lanes; the cache's positions lie on every lane).  Each group's
    rows of the hidden state stay on its home from the embedding to the
    head (`_Rows`), so every group computes exactly what one device
    computes on its rows alone (but for MoE routing pooled over groups).
    The groups meet on the first group's home only to pool a MoE routing
    group's experts and to put the tokens (or logits) together; ``moved``
    counts the bytes that cross between groups there and in handing each
    group its tokens."""

    def __init__(self, model, mesh, params, B: int, plan_cls=None):
        groups = group_lanes(mesh)
        if B == 1:
            groups = groups[:1]
        elif B % len(groups):
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"{len(groups)} data groups")
        self.cfg, self.mesh, self.B = model.cfg, mesh, B
        self.rows = B // len(groups)
        self.params = params
        self.plans = [(plan_cls or GroupPlan)(model, mesh, lanes,
                                              Resting(params))
                      for lanes in groups]
        self.home = self.plans[0].home
        self.moved = 0

    def layout(self, model):
        return _ServeLayout(self)

    def _rows(self, g):
        return (g * self.rows, (g + 1) * self.rows)

    def _split(self, x):
        """``x``'s rows of each group, on the group's home."""
        parts = [_share(x[slice(*self._rows(g))], p.home)
                 for g, p in enumerate(self.plans)]
        self._count(parts)
        return parts

    def _join(self, parts):
        """The groups' ``parts`` put together on the first group's home."""
        home_stream = (torch.cuda.current_stream(self.home.device)
                       if self.home.stream is not None else None)
        self._count(parts)
        return torch.cat([_back(t, self.home, home_stream) for t in parts])

    def stack(self, name, seq):
        tree = self.params
        tree = tree[name] if name == "enc_stack" else tree["stacks"][name]
        return [functools.partial(self._period, p, seq) for p in tree]

    def _period(self, ptree, seq):
        shares = [p._period(ptree, seq, shares=True) for p in self.plans]
        return {b: [s[b] for s in shares] for b in ptree}

    def block(self, shares, x, spec, cfg, *, positions, enc_out=None,
              cache=None, decode=False):
        """`transformer.apply_block` of one decode step, each group on its
        rows of ``x`` (`_Rows`) and of the sharded ``cache``."""
        if not decode:
            raise ValueError("the serve plan decodes; prefill runs each "
                             "group's forward (`GroupPlan.layout`)")
        mixer, ffn = spec
        xs = list(x.parts)
        pos_t = [_share(positions, p.home) for p in self.plans]
        new_cache = {"mixer": None}
        for g, (plan, share) in enumerate(zip(self.plans, shares)):
            rows = self._rows(g)
            if mixer == "mamba":
                out = plan.mamba_decode(share, xs[g], cache["mixer"], rows)
            else:
                out = plan.attention_decode(
                    share, "mixer_attn", xs[g], pos_t[g], cache["mixer"],
                    rows, window=cfg.window if mixer == "attn_local"
                    else None)
            xs[g] = xs[g] + out
            if "cross" in share.modes:
                xs[g] = xs[g] + plan.cross_decode(share, xs[g], pos_t[g],
                                                  cache["cross"], rows)
            if ffn == "mlp":
                xs[g] = xs[g] + plan._mlp(share, "ffn_mlp", xs[g])
        if ffn == "moe":
            for g, out in enumerate(self._moe(shares, xs)):
                xs[g] = xs[g] + out
        c = cache["mixer"]
        new_cache["mixer"] = ({**c, "pos": c["pos"] + 1} if "pos" in c
                              else c)
        if "cross" in cache:
            new_cache["cross"] = cache["cross"]
        return _Rows(xs, x.device), None, new_cache

    def _moe(self, shares, xs):
        """Each group's MoE output, routed as the reference routes the
        whole batch: in its routing groups of ``_group_size(B S)`` tokens
        and their capacity.  Where a routing group spans data groups, each
        group's experts (`GroupPlan.route`) are pooled on the first lane,
        the slots assigned over the routing group in token order
        (`moe.slots`), and each group given its own."""
        cfg = self.cfg
        S = xs[0].shape[1]
        g_size = moe_lib._group_size(self.B * S, cfg)
        T = self.rows * S
        if T % g_size == 0:
            return [p._moe(sh, x, group_size=g_size)[0]
                    for p, sh, x in zip(self.plans, shares, xs)]
        if g_size % T:
            raise ValueError(f"a routing group of {g_size} tokens neither "
                             f"holds nor splits a group's {T}")
        idx = self._join([p.route(sh, x, g_size)
                          for p, sh, x in zip(self.plans, shares, xs)])
        slot, keep = moe_lib.slots(
            idx.reshape(-1, g_size, cfg.top_k), cfg,
            moe_lib._capacity(g_size, cfg))
        slot, keep = slot.reshape(-1, cfg.top_k), keep.reshape(-1, cfg.top_k)
        assigned = self._split_slots(slot, keep, T)
        return [p._moe(sh, x, group_size=g_size, assigned=a)[0]
                for p, sh, x, a in zip(self.plans, shares, xs, assigned)]

    def _split_slots(self, slot, keep, T):
        """Each group's ``T`` tokens' slots and keep flags, on its home."""
        out = []
        for g, p in enumerate(self.plans):
            part = slice(g * T, (g + 1) * T)
            out.append((_share(slot[part], p.home),
                        _share(keep[part], p.home)))
        self._count(out)
        return out

    def _count(self, parts):
        """Adds to ``moved`` the bytes of the groups' ``parts`` (group
        order) that cross between groups: all but the first group's."""
        self.moved += sum(_nbytes(t) for t in parts[1:])


class _ServeLayout:
    """One decode step's `models.model.Layout` on a `ServePlan`."""

    def __init__(self, plan):
        self.plan = plan
        self.device = plan.home.device
        self.stack_kw = dict(block_fn=plan.block)
        self.top = [p.top() for p in plan.plans]

    def stack(self, name, seq):
        return self.plan.stack(name, seq)

    def _each(self, fn, parts):
        return [fn(p, t, x) for p, t, x in zip(self.plan.plans, self.top,
                                              parts)]

    def embed(self, tokens):
        return _Rows(self._each(lambda p, t, x: p.embed(t, x),
                                self.plan._split(tokens)), self.device)

    def norm(self, name, x):
        eps = self.plan.cfg.norm_eps
        return _Rows(self._each(lambda p, t, x: rms_norm(
            t[0][name], x, eps=eps), x.parts), x.device)

    def logits(self, xf):
        return self.plan._join(self._each(lambda p, t, x: p.logits(t, x),
                                          xf.parts))

    def greedy(self, xf):
        return self.plan._join(self._each(lambda p, t, x: p.greedy(t, x),
                                          xf.parts))


class RowBlocks:
    """A hidden state held in row blocks on a data group's lanes (under
    ``cfg.seq_parallel``): ``parts[j]`` (B, S/M, d) is rows ``[m S/M,
    (m+1) S/M)`` of every sequence, on the group's lane ``m =
    lanes[j]`` (its position in the group); ``device`` is home's.
    `models.transformer.run_stack` checkpoints a period on ``parts``, so
    each lane keeps its own rows of the period's input."""

    def __init__(self, parts, lanes, device):
        self.parts, self.lanes, self.device = list(parts), tuple(lanes), device

    @property
    def shape(self):
        B, r, d = self.parts[0].shape
        return (B, r * len(self.parts), d)

    def like(self, parts):
        return RowBlocks(parts, self.lanes, self.device)


class _Leaves:
    """Lane ``m``'s top-level leaves, each gathered at its first use
    (`_Layout`, under ``cfg.seq_parallel``) and kept in ``got`` for the
    pass: whole (``rows``), or as the plan without the setting places
    them."""

    def __init__(self, plan, got, m, rows):
        self.plan, self.got, self.m, self.rows = plan, got, m, rows

    def __getitem__(self, name):
        plan, m = self.plan, self.m
        sliced = not self.rows and name in ("embed", "lm_head") \
            and plan._vocab_split(name)
        if not (self.rows or sliced) and m:
            raise KeyError(f"lane {m} holds no {name}")
        key = (name, m, sliced)
        if key not in self.got:
            self.got[key] = plan.top_leaf(name, m, not sliced)
        return self.got[key]


class _Layout:
    """One pass's `models.model.Layout` on a group's lanes
    (`GroupPlan.layout`).  Under ``cfg.seq_parallel`` (``M > 1``) a stack
    whose length the lanes divide holds its hidden state in `RowBlocks`
    (`GroupPlan.rows_for`): the embedding is looked up on home with the
    whole table and split, each lane norms its rows and takes their
    logits over the whole vocabulary with the whole head (gathered on
    every lane, as the tied embedding's head needs it anyway); the
    top-level leaves are gathered at their first use, each as the pass
    reads it (``rows_top``: whole on every lane; ``top``: as without the
    setting), so a pass that splits no stack runs as without it."""

    def __init__(self, plan):
        self.plan = plan
        self.cfg = plan.cfg
        self.device = plan.home.device
        self.stack_kw = plan.stack_kw()
        if plan.sp:
            plan.top_bytes = [0] * plan.M
            got = {}
            self.top = [_Leaves(plan, got, m, False) for m in range(plan.M)]
            self.rows_top = [_Leaves(plan, got, m, True)
                             for m in range(plan.M)]
        else:
            self.top = plan.top()

    def leaf(self, name):
        return self.top[0][name]

    def stack(self, name, seq):
        return self.plan.stack(name, seq)

    def embed(self, tokens):
        if self.plan.rows_for(tokens.shape[1] + self.cfg.num_patches):
            return embed(self.rows_top[0]["embed"], tokens, self.cfg)
        return self.plan.embed(self.top, tokens)

    def split(self, x):
        if self.plan.rows_for(x.shape[1]):
            x = self.plan.split(x)
            self.plan._own(x.parts, x.lanes)
            return x
        self.plan._own([x], (0,))
        return x

    def norm(self, name, x):
        if isinstance(x, RowBlocks):
            return self.plan.norm_rows(
                {m: self.rows_top[m][name] for m in x.lanes}, x)
        return rms_norm(self.top[0][name], x, eps=self.cfg.norm_eps)

    def xent(self, xf, window, labels):
        if isinstance(xf, RowBlocks):
            return self.plan.xent_rows(self.rows_top, xf, window, labels)
        return self.plan.xent(self.top, xf, window, labels)

    def last(self, xf):
        if isinstance(xf, RowBlocks):
            return RowBlocks([xf.parts[-1][:, -1:]], xf.lanes[-1:],
                             xf.device)
        return xf[:, -1:]

    def greedy(self, xf):
        if isinstance(xf, RowBlocks):
            return self.plan.greedy_rows(self.rows_top, xf)
        return self.plan.greedy(self.top, xf)


def _widen(s, dtype):
    """Cache leaf ``s`` (a `Sharded`) in ``dtype``, its shards replaced:
    a Mamba2 step's conv window takes the wider of the cache's dtype and
    the compute dtype (as the reference's, whose new cache is the step's
    output), so a narrower cache widens after its first step."""
    if s.dtype != dtype:
        s.shards = [t.to(dtype) for t in s.shards]
        s.dtype = dtype


def _ssm_split(sub, cfg, M) -> bool:
    """Mamba2 splits by head where the heads divide over ``M`` and every
    leaf but ``ln`` is split over ``model`` at rest on its head dim."""
    return cfg.ssm_heads % M == 0 and all(
        _names_model(sub[k].spec, 0 if k == "out_proj" else -1)
        for k in sub if k != "ln")


def _mlp_split(sub) -> bool:
    return (all(_names_model(sub[k].spec, -1) for k in ("wi_gate", "wi_up"))
            and _names_model(sub["wo"].spec, 0))


def _nbytes(t) -> int:
    if isinstance(t, dict):
        t = tuple(t.values())
    if isinstance(t, tuple):
        return sum(_nbytes(x) for x in t)
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


def _share(t, lane):
    """``t`` for reading on ``lane``: marked for its stream, on its
    device."""
    if not isinstance(t, torch.Tensor):
        return t
    if lane.stream is not None and t.is_cuda:
        t.record_stream(lane.stream)
    return t.to(lane.device)


def _back(o, home, home_stream):
    if isinstance(o, tuple):
        return tuple(_back(x, home, home_stream) for x in o)
    if isinstance(o, dict):
        return {k: _back(x, home, home_stream) for k, x in o.items()}
    if o is None:
        return None
    if home_stream is not None and o.is_cuda:
        o.record_stream(home_stream)
    return o.to(home.device)

