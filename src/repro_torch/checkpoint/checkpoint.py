"""Checkpoints in the reference's on-disk format, without jax.

Port of ``repro.checkpoint.checkpoint``.  Format (one directory per step):

    step_000123/
      manifest.json       {"step", "complete", "leaves": {path: {shape, dtype}}}
      host_00000.npz      the leaves' data, one npz member per leaf

- Writes are atomic: data and manifest land in ``<dir>.tmp``, which is
  renamed only after both are written, so a killed writer never leaves a
  half-checkpoint that `restore` would pick up (``complete`` is checked
  again by `latest_step`).
- Leaf paths are the reference's: jax's ``tree_flatten_with_path`` order
  (dict keys sorted, list and tuple items by index, ``None`` an empty
  subtree) with the path parts joined by ``/``.  So the npz member order
  and the manifest's ``leaves`` order match the reference's, and a
  checkpoint written by either package restores in the other.  Trees are
  nested dicts, lists, tuples and NamedTuples (a training state is
  ``TrainState(params, opt=OptState(mu, nu, count), step)``); a
  NamedTuple's fields are keyed ``.<field>`` in field order, as jax keys
  them (``.params/embed``, ``.opt/.count``).  Leaves are tensors, numpy
  arrays or scalars.
- `save` gathers a sharded leaf (`distributed.sharding.Sharded`) into
  one array, so a tree sharded on any mesh writes what the unsharded
  tree of equal values writes.
- `restore` returns tensors on the CPU, or on ``device`` when one is
  given; with ``shardings`` (the reference's elastic placement: a
  matching tree of `distributed.sharding.NamedSharding`) a leaf that has
  one comes back split onto that mesh as a `Sharded` leaf, whatever mesh
  wrote it.
- `prune` keeps the ``keep`` newest complete steps.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch

from ..device import to_host

DATA_NAME = "host_00000.npz"


def _step_of(dirname: str) -> int | None:
    """Parse ``step_NNNNNNNNN`` -> step, or None for anything else a crash
    or a stray file may have left in the checkpoint root."""
    if not dirname.startswith("step_") or dirname.endswith(".tmp"):
        return None
    try:
        return int(dirname.split("_")[1])
    except (IndexError, ValueError):
        return None


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree, prefix: tuple = (), is_leaf=lambda x: False) -> dict:
    """``{path: leaf}`` in jax's flattening order (see the module note);
    a node for which ``is_leaf`` holds is a leaf."""
    if tree is None:
        return {}
    if is_leaf(tree):
        return {"/".join(prefix): tree}
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif _is_namedtuple(tree):
        items = ((f".{f}", v) for f, v in zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {"/".join(prefix): tree}
    out = {}
    for key, sub in items:
        out.update(_flatten(sub, prefix + (key,), is_leaf))
    return out


def _unflatten(tree, leaves: dict, prefix: tuple = ()):
    """``tree``'s structure with each leaf replaced from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves, prefix + (str(k),))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(v, leaves, prefix + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        out = [_unflatten(v, leaves, prefix + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return leaves["/".join(prefix)]


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write a checkpoint; returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    from ..distributed.sharding import whole

    arrays = {k: to_host(whole(v)) for k, v in _flatten(tree).items()}
    np.savez(os.path.join(tmp, DATA_NAME), **arrays)
    manifest = {
        "step": step,
        "complete": True,
        "leaves": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in arrays.items()
        },
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Newest RESTORABLE step: a checkpoint counts only when its name
    parses, its manifest is readable JSON marked ``complete``, and the
    data file exists — everything else (leftover ``.tmp`` dirs, torn
    manifests, a manifest whose npz never landed) is what a crashed
    writer leaves behind, and is skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        step = _step_of(d)
        if step is None:
            continue
        try:
            with open(os.path.join(ckpt_dir, d, "manifest.json")) as f:
                m = json.load(f)
        except (OSError, ValueError):
            continue
        if m.get("complete") and os.path.exists(
                os.path.join(ckpt_dir, d, DATA_NAME)):
            steps.append(step)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, shardings=None, *,
            device=None):
    """Restore into the structure of ``like_tree``, whose leaves give the
    expected shapes (tensors, numpy arrays, or anything with ``.shape``).
    Leaves come back as tensors of the stored dtype, on ``device`` (the
    CPU by default).  ``shardings``: a matching tree of
    `distributed.sharding.NamedSharding` (a leaf may be ``None``) for
    elastic placement onto the current mesh: such a leaf comes back as a
    `Sharded` of that mesh and spec.  A corrupt or missing step raises
    RuntimeError; a stored shape that differs from the expected one
    raises ValueError."""
    from ..distributed.sharding import NamedSharding, shard
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    try:
        data = np.load(os.path.join(d, DATA_NAME))
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise RuntimeError(
            f"checkpoint step {step} at {d} is corrupt or missing "
            f"({type(e).__name__}: {e}); pick a restorable step with "
            "latest_step()"
        ) from e
    is_sharding = lambda x: isinstance(x, NamedSharding)  # noqa: E731
    flat_shard = {} if shardings is None else {
        k: v for k, v in _flatten(shardings, is_leaf=is_sharding).items()
        if is_sharding(v)}
    leaves = {}
    with data:
        for key, like in _flatten(like_tree).items():
            arr = data[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"expected {tuple(like.shape)}")
            t = torch.from_numpy(arr)
            sh = flat_shard.get(key)
            if sh is not None:
                leaves[key] = shard(t, sh.mesh, sh.spec)
            else:
                leaves[key] = t if device is None else t.to(device)
    return _unflatten(like_tree, leaves)


def prune(ckpt_dir: str, keep: int = 3):
    """Retain the ``keep`` newest steps; unparsable directory names (crash
    debris) are left alone rather than crashing the retention sweep."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        s for s in (_step_of(d) for d in os.listdir(ckpt_dir))
        if s is not None
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
