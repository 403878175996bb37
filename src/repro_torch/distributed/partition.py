"""The partition of the sharded train step: what each lane of a (data,
model) `LaneMesh` computes, laid out as the reference's parameter specs
and ``constrain`` hints lay out XLA's partitioned step.

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

Partial outputs are added on the group's first lane ("home") in lane
order, in float32, and cast once; ``ctx`` rows are put side by side.
Where the divisibility guard of `sharding.resolve` left a product's
leaves whole over ``model``, or its split would not give whole heads, the
product runs whole on home.  With ``M == 1`` every product
is the one-device model's own code, so a ``(D, 1)`` step equals the
one-device step with ``microbatches=D`` bit for bit.

**Lanes and streams.**  Each lane's share is queued on its stream
(`lane_context`, which orders it after home's work); home waits on a
lane's stream before it reads the lane's output, and every tensor read
on a stream other than its maker's is marked ``record_stream`` for it.
Every period runs in `GroupPlan.scope`: on home's stream, and at its end
all the group's lanes wait on home and the stream the period was entered
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
    F32, attention, embed, mlp, project_kv, rms_norm, unembed,
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

    def _block_modes(self, block, seq) -> dict:
        cfg, M = self.cfg, self.M
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
                modes[name] = ("heads" if heads else
                               "ctx" if seq % M == 0 else "home")
            elif name == "ffn_mlp":
                modes[name] = "split" if _mlp_split(sub) else "home"
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
                tree[name] = self._tree(sub, m, mode == "ctx", True)

    def _period(self, ptree, seq):
        """A period's leaves gathered on the lanes that use them: the
        one-device tree when ``M == 1``, else a `BlockShare` a block
        (``seq``: the stack's query length, which picks ``ctx`` mode)."""
        before = list(self.gathered)
        if self.M == 1:
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
        ``layout`` of `LM.loss` / `EncDec.loss`): its top-level leaves
        gathered once."""
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
        for i in self.lanes[1:]:
            self.mesh.lanes[i].stream.wait_stream(self.home.stream)
        entry.wait_stream(self.home.stream)

    def run(self, fn, *shared) -> list:
        """``fn(m, *shared)`` on every lane ``m`` of the group, queued on
        its stream; each result (a tensor or a tuple of them) brought back
        to home."""
        home_stream = (torch.cuda.current_stream(self.home.device)
                       if self.home.stream is not None else None)
        outs = []
        for m, i in enumerate(self.lanes):
            lane = self.mesh.lanes[i]
            outs.append(self._lane_run(m, fn, shared))
            if lane.stream is not None and lane.stream != home_stream:
                home_stream.wait_stream(lane.stream)
        return [_back(o, self.home, home_stream) for o in outs]

    def _lane_run(self, m, fn, shared):
        """Lane ``m``'s share of `run`, on its stream."""
        lane = self.mesh.lanes[self.lanes[m]]
        with lane_context(lane):
            out = fn(m, *(_share(t, lane) for t in shared))
        if m:
            self.moved += sum(_nbytes(t) for t in (*shared, out))
        return out

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
        return x, aux, {}

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

    def _moe(self, share, x):
        cfg = self.cfg
        trees = [t.get("ffn_moe") for t in share.trees]
        if share.modes["ffn_moe"] == "home":
            return moe_lib.moe(trees[0], x, cfg=cfg)
        Em = cfg.n_experts // self.M
        outs = self.run(lambda m, x: moe_lib.moe(
            trees[m], x, cfg=cfg, experts=(m * Em, (m + 1) * Em),
            with_aux=m == 0), x)
        return self.sum([o for o, _ in outs]), outs[0][1]

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



class _Layout:
    """One pass's `models.model.Layout` on a group's lanes
    (`GroupPlan.layout`)."""

    def __init__(self, plan):
        self.plan = plan
        self.device = plan.home.device
        self.stack_kw = plan.stack_kw()
        self.top = plan.top()

    def leaf(self, name):
        return self.top[0][name]

    def stack(self, name, seq):
        return self.plan.stack(name, seq)

    def embed(self, tokens):
        return self.plan.embed(self.top, tokens)

    def xent(self, xf, window, labels):
        return self.plan.xent(self.top, xf, window, labels)


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

