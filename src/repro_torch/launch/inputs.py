"""Shape-only stand-ins and shardings for every (arch x shape) cell (port
of ``repro.launch.inputs``).

The reference's stand-ins are ``jax.ShapeDtypeStruct``s; here they are
tensors on PyTorch's ``meta`` device, which have a shape and a dtype and
no storage: the model is built with ``build_model(cfg, device="meta")``,
tokens are ``int32`` and embeddings ``bfloat16``, as in the reference.
Sharding specs are built from the logical rules with a **divisibility
guard** — an axis only shards a dim it divides exactly (e.g. whisper's
odd 51,865 vocab falls back to replicated on 'model'; mamba2-130m's 24
ssm heads don't split 16 ways and stay replicated).

Trees are the port's: a list over periods where the reference stacks a
leaf along ``n_periods``, and a Python ``int`` where the reference's cache
keeps a 0-d ``pos``.  Each leaf's rule is matched on its reference path
(`distributed.sharding.map_reference_paths`: ``stacks/s0/b0/mixer/k``),
its spec is the reference's for the stacked leaf with the period entry
dropped, and an ``int`` leaf gets the reference's spec for its 0-d array
(``P()``).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..configs import ShapeSpec
from ..distributed.sharding import (
    LOGICAL_TO_PHYSICAL, NamedSharding, PartitionSpec, logical_axes_for_path,
    map_reference_paths, stacked_spec,
)
from ..models import build_model

P = PartitionSpec


def _axis_size(mesh, phys) -> int:
    if phys is None:
        return 1
    if isinstance(phys, tuple):
        n = 1
        for a in phys:
            if a in mesh.axis_names:
                n *= mesh.shape[a]
        return n
    return mesh.shape[phys] if phys in mesh.axis_names else 1


def _resolve_guarded(mesh, logical_axes, shape, overrides=None) -> P:
    """Logical axes -> PartitionSpec, dropping axes that don't divide."""
    parts = []
    for name, dim in zip(logical_axes, shape):
        phys = (overrides or {}).get(name, LOGICAL_TO_PHYSICAL.get(name))
        if phys is None:
            parts.append(None)
            continue
        if isinstance(phys, tuple):
            phys = tuple(a for a in phys if a in mesh.axis_names)
            if not phys:
                parts.append(None)
                continue
        if _axis_size(mesh, phys) == 0 or dim % max(_axis_size(mesh, phys), 1):
            parts.append(None)
        else:
            parts.append(phys)
    return P(*parts)


def _rule_axes(rules, path: str, ndim: int) -> tuple:
    for pat, ax in rules:
        if re.search(pat, path):
            pad = (None,) * max(ndim - len(ax), 0)
            return pad + tuple(ax)[-ndim:] if ndim < len(ax) \
                else pad + tuple(ax)
    return (None,) * ndim


def _guarded_tree(tree, mesh, axes_of, overrides=None):
    def leaf(path, shape, periods):
        return NamedSharding(mesh, stacked_spec(
            lambda axes, full: _resolve_guarded(mesh, axes, full, overrides),
            axes_of, path, shape, periods))

    return map_reference_paths(leaf, tree)


def tree_shardings(tree, mesh, rules, overrides=None):
    """Tree of `NamedSharding` from trailing-dim path rules."""
    return _guarded_tree(tree, mesh, lambda p, n: _rule_axes(rules, p, n),
                         overrides)


# Parameter rules reuse the central table.
def param_tree_shardings(params_struct, mesh):
    return _guarded_tree(params_struct, mesh, logical_axes_for_path)


CACHE_RULES = [
    (r"cross/(k|v)$", ("batch", None, "model", None)),
    (r"mixer/(k|v)$", ("batch", "seq_kv", "model", None)),
    (r"mixer/conv$",  ("batch", None, "model")),
    (r"mixer/ssm$",   ("batch", "model", None, None)),
    (r"pos$",         ()),
]

BATCH_RULES = [
    (r"tokens$",       ("batch", None)),
    (r"image_embeds$", ("batch", None, None)),
    (r"enc_frames$",   ("batch", None, None)),
]


def _struct(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_struct(cfg, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    if cfg.num_patches:
        return {
            "tokens": _struct((B, S - cfg.num_patches), torch.int32),
            "image_embeds": _struct((B, cfg.num_patches, cfg.d_model),
                                    torch.bfloat16),
        }
    if cfg.is_encoder_decoder:
        return {
            "tokens": _struct((B, S), torch.int32),
            "enc_frames": _struct((B, cfg.encoder_seq, cfg.d_model),
                                  torch.bfloat16),
        }
    return {"tokens": _struct((B, S), torch.int32)}


def make_train_batch(cfg, shape: ShapeSpec, seed: int = 0, *, device="cpu"):
    """Concrete batch matching `train_batch_struct` (on ``device``, the
    CPU by default): the reference's draws from
    ``np.random.default_rng(seed)`` in its order.  Tokens are the same
    integers; ``float64`` normals become ``bfloat16`` through ``float32``,
    which is how ``jnp.asarray(x, jnp.bfloat16)`` rounds them too (the
    same bits; rounding ``float64`` to ``bfloat16`` directly would differ
    in a few elements a million)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in train_batch_struct(cfg, shape).items():
        if v.dtype == torch.int32:
            a = rng.integers(0, cfg.vocab_size, size=tuple(v.shape))
            out[k] = torch.as_tensor(a).to(device=device, dtype=torch.int32)
        else:
            a = rng.normal(size=tuple(v.shape))
            out[k] = torch.from_numpy(a).to(device=device, dtype=v.dtype)
    return out


def serve_overrides(cfg, B: int, mesh):
    """The logical-axis overrides of a serve cell (``None``: none): at
    ``B == 1`` the batch is not split and the KV-cache sequence dim splits
    over ``data``; where the KV heads do not divide ``model`` the sequence
    dim splits over ``model`` (as well)."""
    msize = dict(mesh.shape).get("model", 1)
    heads_ok = msize <= 1 or (cfg.n_kv_heads % msize == 0)
    overrides = {}
    seq_axes = []
    if B == 1:
        # batch-1 long decode: shard the KV sequence dim over 'data' instead.
        overrides["batch"] = None
        seq_axes.append("data")
    if not heads_ok:
        # kv-heads don't divide the tensor axis (qwen2: 2, llava: 8 on 16):
        # the cache shards its sequence dim over 'model' instead (the K-dim
        # rule is dropped by the divisibility guard automatically).
        seq_axes.append("model")
    if seq_axes:
        overrides["seq_kv"] = tuple(seq_axes) if len(seq_axes) > 1 else seq_axes[0]
    return overrides or None


def cache_shardings(cache, cfg, B: int, mesh):
    """The `NamedSharding` of every leaf of a decode cache of ``B`` rows:
    `CACHE_RULES` under the guard and `serve_overrides` (``pos``:
    ``P()``)."""
    return tree_shardings(cache, mesh, CACHE_RULES,
                          serve_overrides(cfg, B, mesh))


def cell_specs(arch_cfg, shape: ShapeSpec, mesh):
    """Everything the dry-run needs for one cell:
    (model, fn_kind, arg_structs, in_shardings) where fn_kind is
    'train' | 'prefill' | 'decode'; the model is built on ``meta``."""
    from ..optim import adamw
    from ..train.train_step import TrainState

    model = build_model(arch_cfg, device="meta")
    params_struct = model.params()
    p_shard = param_tree_shardings(params_struct, mesh)
    B = shape.global_batch
    overrides = serve_overrides(arch_cfg, B, mesh)

    if shape.kind == "train":
        batch_struct = train_batch_struct(arch_cfg, shape)
        b_shard = tree_shardings(batch_struct, mesh, BATCH_RULES, overrides)
        kind = "train" if shape.name.startswith("train") else "prefill"
        if kind == "train":
            state_struct = TrainState(
                params=params_struct, opt=adamw.init(params_struct),
                step=_struct((), torch.int32))
            s_shard = param_tree_shardings(state_struct, mesh)
            return model, kind, (state_struct, batch_struct), (s_shard, b_shard)
        return model, kind, (params_struct, batch_struct), (p_shard, b_shard)

    # decode
    if arch_cfg.is_encoder_decoder:
        enc_batch = {"enc_frames": _struct(
            (B, arch_cfg.encoder_seq, arch_cfg.d_model), torch.bfloat16)}
        cache_struct = model.init_cache(enc_batch, shape.seq_len)
    else:
        cache_struct = model.init_cache(B, shape.seq_len)
    c_shard = cache_shardings(cache_struct, arch_cfg, B, mesh)
    tok_struct = _struct((B, 1), torch.int32)
    t_shard = NamedSharding(
        mesh, _resolve_guarded(mesh, ("batch", None), (B, 1), overrides))
    return model, "decode", (params_struct, cache_struct, tok_struct), (
        p_shard, c_shard, t_shard)
