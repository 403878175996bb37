"""Logical-axis sharding: one place that decides how every tensor shards
(port of ``repro.distributed.sharding``).

Physical mesh axes:  ('pod', 'data', 'model')  — see launch/mesh.py.
Logical axes used by the rules:

  batch   -> ('pod', 'data')   activations' batch dim (DP across pods too)
  fsdp    -> 'data'            parameter rows (ZeRO-3-style weight sharding)
  model   -> 'model'           TP: heads / FFN hidden / vocab / experts
  expert  -> 'model'           EP shares the TP axis (MoE archs)
  seq     -> None              sequence stays unsharded

The mesh is a `launch.mesh.LaneMesh` (lanes in one process, see that
module's note); `use_mesh` makes one active for this thread, and
`resolve` / `param_pspecs` read its ``axis_names`` and ``shape`` as the
reference's read a jax ``Mesh``.  A spec is a `PartitionSpec`: a tuple
with one entry a tensor dim, each an axis name, a tuple of names, or
``None``.

What a spec means is what the reference gets from
``jax.device_put(x, NamedSharding(mesh, spec))``: `shard` splits a tensor
into a `Sharded` of one shard a lane (the slice of every sharded dim that
the lane's coordinates pick, a copy on every lane of an axis the spec
does not name), and `gather` puts the full tensor back together in lane
order, or one lane's part of it widened over some axes.  `constrain` is
the identity: eager PyTorch has no partitioner to take a layout hint;
the sharded train step's partition, which the reference's hints give
XLA, is `distributed.partition`'s own code.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import math
import re
import threading
from typing import Any, NamedTuple

import torch

LOGICAL_TO_PHYSICAL: dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "model": "model",
    "expert": "model",
    "seq": None,
    "seq_kv": None,      # KV-cache seq dim; long_500k remaps it to 'data'
    "ctx": "model",      # context parallelism: q-seq over 'model' when
                         # kv-heads don't divide the tensor axis
    None: None,
}


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis name, a tuple of names (the
    dim split over their product, major first), or ``None``
    (replicated).  As jax's does, it stores a one-name tuple as the name
    and an empty tuple as ``None``."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, tuple):
                return None if not p else p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """Where a tensor's shards lie: a spec on a lane mesh."""

    mesh: Any
    spec: PartitionSpec


_ctx = threading.local()


def _current_mesh():
    return getattr(_ctx, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a mesh for logical-axis resolution and for the train step
    built under it (`train.make_train_step`)."""
    prev = getattr(_ctx, "mesh", None)
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev


def axis_size(name: str) -> int:
    """Size of a *logical* axis on the active mesh (1 off-mesh)."""
    mesh = _current_mesh()
    if mesh is None:
        return 1
    phys = LOGICAL_TO_PHYSICAL.get(name, None)
    if phys is None:
        return 1
    if isinstance(phys, tuple):
        n = 1
        for a in phys:
            if a in mesh.axis_names:
                n *= mesh.shape[a]
        return n
    return mesh.shape[phys] if phys in mesh.axis_names else 1


def resolve(*logical_names, shape=None) -> PartitionSpec:
    """Logical names -> PartitionSpec against the active mesh's axes.

    With ``shape`` given, axes that don't divide the dim are dropped
    (divisibility guard — e.g. 2 kv heads never shard over a 16-way axis)."""
    mesh = _current_mesh()
    parts = []
    for i, name in enumerate(logical_names):
        phys = LOGICAL_TO_PHYSICAL.get(name, None)
        if phys is None or mesh is None:
            parts.append(None)
            continue
        if isinstance(phys, tuple):
            phys = tuple(a for a in phys if a in mesh.axis_names)
            if not phys:
                parts.append(None)
                continue
        elif phys not in mesh.axis_names:
            parts.append(None)
            continue
        if shape is not None:
            n = 1
            for a in (phys if isinstance(phys, tuple) else (phys,)):
                n *= mesh.shape[a]
            if n == 0 or shape[i] % n:
                parts.append(None)
                continue
        parts.append(phys)
    return PartitionSpec(*parts)


def constrain(x, *logical_names):
    """The identity.  The reference hints a layout to XLA's partitioner
    here (``with_sharding_constraint``); eager PyTorch has no partitioner
    to take the hint, so there is nothing to do."""
    return x


# ---------------------------------------------------------------------------
# Parameter sharding rules: leaf path regex -> logical axes (one per dim,
# matched from the TRAILING dims so stacked layers get leading None).
# First match wins.
# ---------------------------------------------------------------------------
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$",            ("model", "fsdp")),     # (V, d) big vocab tables
    (r"lm_head$",          ("fsdp", "model")),     # (d, V)
    (r"(wq|wk|wv)$",       ("fsdp", "model")),     # (d, heads*hd)
    (r"(bq|bk|bv)$",       ("model",)),            # qkv bias (qwen2)
    (r"wo$",               ("model", "fsdp")),     # (heads*hd, d)
    (r"experts/.*wi.*$",   ("expert", "fsdp", None)),  # (E, d, f)
    (r"experts/.*wo$",     ("expert", None, "fsdp")),  # (E, f, d)
    (r"router$",           ("fsdp", None)),        # (d, E)
    (r"(wi_gate|wi_up)$",  ("fsdp", "model")),     # (d, f)
    (r"mlp.*wo$",          ("model", "fsdp")),
    (r"in_proj$",          ("fsdp", "model")),     # mamba (d, inner-stuff)
    (r"out_proj$",         ("model", "fsdp")),     # mamba (inner, d)
    (r"conv$",             (None, "model")),       # (w, conv_dim)
    (r"(A_log|ssm_D|dt_bias)$", ("model",)),       # per-head ssm params
    (r"ssm_norm$",         ("model",)),            # (d_inner,)
    (r"pos_embed$",        (None, "fsdp")),        # (S, d) whisper encoder
    (r"(norm|ln\w*|scale)$", (None,)),             # rmsnorm scales
]


def logical_axes_for_path(path: str, ndim: int) -> tuple:
    for pat, axes in PARAM_RULES:
        if re.search(pat, path):
            pad = (None,) * (ndim - len(axes))
            return pad + tuple(axes)[-ndim:] if ndim < len(axes) else pad + axes
    return (None,) * ndim


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def map_reference_paths(fn, tree):
    """``fn(path, shape, periods)`` at every leaf of ``tree`` (nested dicts,
    lists, NamedTuples; a leaf is a tensor or a Python number), rebuilt in
    the tree's structure.  ``path`` is the leaf's reference path, joined
    by ``/`` as the reference joins jax's keys (a NamedTuple field is
    ``.name``); the first list on a path is the periods of a leaf the
    reference stacks along ``n_periods``, its index dropped from the path
    as `convert._by_reference_path` drops it and its length passed as
    ``periods`` (None for a leaf that is not stacked)."""
    def walk(node, path, periods):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),), periods)
                    for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, path + (f".{f}",), periods)
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            if periods is None and isinstance(node, list):
                return [walk(v, path, len(node)) for v in node]
            return type(node)(walk(v, path + (str(i),), periods)
                              for i, v in enumerate(node))
        shape = tuple(node.shape) if hasattr(node, "shape") else ()
        return fn("/".join(path), shape, periods)

    return walk(tree, (), None)


def stacked_spec(resolve_fn, axes_of, path, shape, periods) -> PartitionSpec:
    """The reference's spec for a leaf at ``path`` (stacked along
    ``periods`` when it is one period's leaf) with the period entry
    dropped: ``axes_of(path, ndim)`` gives the logical axes of the
    reference's leaf, ``resolve_fn(axes, shape)`` its spec."""
    full = shape if periods is None else (periods,) + shape
    spec = resolve_fn(axes_of(path, len(full)), full)
    if periods is None:
        return spec
    if spec[0] is not None:
        raise ValueError(f"{path}: the period dim would shard over {spec[0]}")
    return PartitionSpec(*spec[1:])


def param_pspecs(params) -> Any:
    """Tree of `PartitionSpec` matching a parameter tree in the port's
    layout (nested dicts, a list over periods where the reference stacks
    a leaf along ``n_periods``), derived from PARAM_RULES and the active
    mesh.  Each leaf's rule is matched on its reference path
    (`map_reference_paths`: ``stacks/s0/b0/mixer/wq``), and its spec is
    the reference's for the stacked leaf ``(n_periods, *shape)`` with the
    period entry (never sharded) dropped, so the divisibility guard sees
    the reference's dims."""
    return map_reference_paths(
        lambda path, shape, periods: stacked_spec(
            lambda axes, full: resolve(*axes, shape=full),
            logical_axes_for_path, path, shape, periods), params)


def param_shardings(params, mesh):
    """`NamedSharding` a leaf of ``params``, under ``mesh``'s rules."""
    with use_mesh(mesh):
        specs = param_pspecs(params)
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (a spec is a
    leaf, though it is a tuple)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Sharded storage: what ``jax.device_put(x, NamedSharding(mesh, spec))``
# means, as one tensor a lane.
# ---------------------------------------------------------------------------
def _spec_axes(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def shard_shape(shape, mesh, spec) -> tuple:
    """The shape of every lane's shard of a ``shape`` tensor under
    ``spec`` (each sharded dim divided by its axes' product; the guard of
    `resolve` keeps that exact)."""
    out = []
    for i, dim in enumerate(shape):
        part = spec[i] if i < len(spec) else None
        n = math.prod(mesh.shape[a] for a in _spec_axes(part))
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{n} ways under {spec}")
        out.append(dim // n)
    return tuple(out)


def shard_slices(shape, mesh, spec, lane: int) -> tuple:
    """The slice of a ``shape`` tensor that lane ``lane`` holds."""
    if not isinstance(spec, PartitionSpec):
        spec = PartitionSpec(*spec)
    return _slices(tuple(shape), mesh, spec, lane)


@functools.lru_cache(maxsize=1 << 20)
def _slices(shape, mesh, spec, lane):
    coords = mesh.coords(lane)
    local = shard_shape(shape, mesh, spec)
    out = []
    for i, n in enumerate(local):
        part = spec[i] if i < len(spec) else None
        g = mesh.group_index(coords, _spec_axes(part))
        out.append(slice(g * n, (g + 1) * n))
    return tuple(out)


class Sharded:
    """A tensor stored as one shard a lane of ``mesh`` under ``spec``:
    ``shards[i]`` lies on lane ``i``'s device.  ``shape`` and ``dtype``
    are the full tensor's; `gather` gives it back."""

    def __init__(self, shards, mesh, spec, shape, dtype):
        self.shards = list(shards)
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def lane_bytes(self, lane: int) -> int:
        """The bytes lane ``lane`` holds of this tensor."""
        t = self.shards[lane]
        return t.numel() * t.element_size()

    def __repr__(self):
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"{self.mesh})")


def shard(x: torch.Tensor, mesh, spec) -> Sharded:
    """``x`` split onto ``mesh``'s lanes under ``spec``: every lane gets a
    copy of its slice on its device (a lane of an axis the spec does not
    name gets the same slice as its neighbours, in a tensor of its own)."""
    shards = []
    with torch.no_grad():
        for i, lane in enumerate(mesh.lanes):
            part = x[shard_slices(x.shape, mesh, spec, i)]
            shards.append(part.to(lane.device, copy=True).contiguous())
    return Sharded(shards, mesh, spec, x.shape, x.dtype)


def whole(x):
    """``x`` as one tensor: a `Sharded` gathered (`gather`), anything else
    as it is."""
    return gather(x) if isinstance(x, Sharded) else x


def region_slices(s: Sharded, lane: int, axes) -> tuple:
    """The part of ``s`` that lane ``lane`` holds, widened to the whole
    dim wherever the dim's axes are all in ``axes`` (mesh axis names):
    what a gather over ``axes`` puts together on that lane."""
    return _region(tuple(s.shape), s.mesh, s.spec, lane, tuple(axes))


@functools.lru_cache(maxsize=65536)
def _region(shape, mesh, spec, lane, axes):
    axes = set(axes)
    own = shard_slices(shape, mesh, spec, lane)
    out = []
    for i, sl in enumerate(own):
        part = set(_spec_axes(spec[i] if i < len(spec) else None))
        if part <= axes:
            out.append(slice(0, shape[i]))
        elif part & axes:
            raise ValueError(f"dim {i} of {shape} under {spec} splits over "
                             f"{sorted(part)}, of which a gather over "
                             f"{sorted(axes)} would take only some")
        else:
            out.append(sl)
    return tuple(out)


def gather_sources(s: Sharded, region) -> list:
    """``(lane, slice of the full tensor)`` for every distinct shard of
    ``s`` that meets ``region`` (a tuple of slices), each from the first
    lane that holds it, in lane order; the slice is the part of the shard
    inside ``region`` (the whole shard where the region covers it)."""
    return _sources(tuple(s.shape), s.mesh, s.spec,
                    tuple((r.start, r.stop) for r in region))


@functools.lru_cache(maxsize=65536)
def _sources(shape, mesh, spec, region):
    seen, out = set(), []
    for i in range(mesh.size):
        sl = shard_slices(shape, mesh, spec, i)
        key = tuple((x.start, x.stop) for x in sl)
        if key in seen:
            continue
        seen.add(key)
        inter = tuple(slice(max(x.start, r0), min(x.stop, r1))
                      for x, (r0, r1) in zip(sl, region))
        if all(x.start < x.stop for x in inter):
            out.append((i, inter))
    return out


def within(inner, outer) -> tuple:
    """``inner`` (slices of the full tensor) as slices of the part
    ``outer`` covers."""
    return tuple(slice(x.start - o.start, x.stop - o.start)
                 for x, o in zip(inner, outer))


def _pieces(r) -> tuple:
    """A region's entry for one dim as ``((start, stop), ...)``: a slice,
    or a tuple of slices laid side by side in that order."""
    return tuple((x.start, x.stop) for x in (r if isinstance(r, tuple)
                                             else (r,)))


def region_shape(region) -> tuple:
    """The shape `gather` gives ``region``: each dim's pieces' lengths
    summed."""
    return tuple(sum(b - a for a, b in _pieces(r)) for r in region)


def gather_plan(s: Sharded, region) -> tuple:
    """How `gather` puts ``region`` of ``s`` together: ``(lane, where in
    the output, which part of the lane's shard or None for all of it)``
    for each source of `gather_sources` in each block of the region.  An
    entry of ``region`` is a slice of its dim, or a tuple of slices whose
    parts are laid side by side (several column ranges of one leaf: they
    need not follow the shards, and one shard may serve several)."""
    return _plan(tuple(s.shape), s.mesh, s.spec,
                 tuple(_pieces(r) for r in region))


@functools.lru_cache(maxsize=65536)
def _plan(shape, mesh, spec, region):
    out = []
    offsets = [[sum(b - a for a, b in pieces[:k]) for k in range(len(pieces))]
               for pieces in region]
    for block in itertools.product(*(range(len(p)) for p in region)):
        sub = tuple(pieces[k] for pieces, k in zip(region, block))
        reg = tuple(slice(*r) for r in sub)
        for i, sl in _sources(shape, mesh, spec, sub):
            own = shard_slices(shape, mesh, spec, i)
            at = tuple(slice(x.start + off[k], x.stop + off[k]) for x, off, k
                       in zip(within(sl, reg), offsets, block))
            out.append((i, at, None if sl == own else within(sl, own)))
    return tuple(out)


def gather(s: Sharded, device=None, out: torch.Tensor | None = None, *,
           lane: int | None = None, axes=(), dtype=None,
           region=None) -> torch.Tensor:
    """The full tensor of ``s``, put together in lane order from the first
    lane that holds each slice, on ``device`` (lane 0's by default), or
    written into ``out``.  With ``lane``, only the part lane ``lane``
    holds widened over the mesh axes ``axes`` (`region_slices`: a gather
    over ``data`` gives a lane its ``model`` slice of an FSDP leaf), or
    ``region`` (a slice a dim, or a tuple of slices laid side by side,
    whatever shards they cut: `gather_plan`), on that
    lane's device by default, in ``dtype`` (``s``'s by default: each
    shard is rounded as ``.to(dtype)`` rounds it)."""
    if region is None:
        region = (tuple(slice(0, n) for n in s.shape) if lane is None
                  else region_slices(s, lane, axes))
    if out is None:
        dev = device if device is not None else \
            s.mesh.lanes[0 if lane is None else lane].device
        out = torch.empty(region_shape(region), dtype=dtype or s.dtype,
                          device=dev)
    if out.device.type == "meta":
        return out          # nothing to copy: a meta tensor has no data
    with torch.no_grad():
        for i, at, part in gather_plan(s, region):
            out[at].copy_(s.shards[i] if part is None else s.shards[i][part])
    return out


def scatter(s: Sharded, region, value: torch.Tensor) -> None:
    """Write ``value`` (shaped `region_shape(region)`) into ``region`` of
    ``s`` in place: on every lane that holds part of it, replicas
    included, so every copy of a slice stays the same.  ``region`` as in
    `gather_plan`."""
    with torch.no_grad():
        for i, dst, src in _scatter_plan(tuple(s.shape), s.mesh, s.spec,
                                         tuple(_pieces(r) for r in region)):
            t = s.shards[i]
            t[dst].copy_(value[src].to(t.device))


@functools.lru_cache(maxsize=65536)
def _scatter_plan(shape, mesh, spec, region):
    out = []
    offsets = [[sum(b - a for a, b in pieces[:k]) for k in range(len(pieces))]
               for pieces in region]
    for block in itertools.product(*(range(len(p)) for p in region)):
        sub = tuple(pieces[k] for pieces, k in zip(region, block))
        for i in range(mesh.size):
            own = shard_slices(shape, mesh, spec, i)
            inter = tuple(slice(max(x.start, a), min(x.stop, b))
                          for x, (a, b) in zip(own, sub))
            if not all(x.start < x.stop for x in inter):
                continue
            src = tuple(slice(x.start - a + off[k], x.stop - a + off[k])
                        for x, (a, _), off, k in zip(inter, sub, offsets,
                                                     block))
            out.append((i, within(inter, own), src))
    return tuple(out)


def shard_tree(tree, mesh, specs):
    """``tree`` (dicts and lists) with each tensor a `Sharded` on ``mesh``
    under ``specs`` (a tree shaped like it of specs or `NamedSharding`
    leaves), in place in its own dicts and lists, as ``jit``'s
    ``in_shardings`` place a donated argument: each leaf is replaced as
    soon as it is split, so a whole tensor nothing else holds is freed
    then, and the whole tree and its shards are never on the lanes
    together.  A leaf already so sharded is kept, one sharded otherwise is
    gathered and split again; a leaf that is no tensor (a cache's ``pos``)
    is kept."""
    for k in (tree if isinstance(tree, dict) else range(len(tree))):
        x, sp = tree[k], specs[k]
        sp = getattr(sp, "spec", sp)
        if isinstance(x, (dict, list)):
            shard_tree(x, mesh, sp)
        elif isinstance(x, Sharded) and x.mesh is mesh and x.spec == sp:
            continue
        elif isinstance(x, (Sharded, torch.Tensor)):
            tree[k] = shard(whole(x), mesh, sp)
    return tree


def shard_cache(cache, mesh, specs):
    """A decode cache placed on ``mesh`` under ``specs`` (`shard_tree`;
    the serve counterpart of `train.train_step.shard_state`)."""
    return shard_tree(cache, mesh, specs)
