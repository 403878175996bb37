"""Carry the reference package's state into the port.

Language models: the reference's parameter pytree, as nested dicts of
numpy arrays, is copied into a port `LM` or `EncDec`
(`lm_params_from_reference`): each leaf the reference stacks along
``n_periods`` is split into the port's per-period modules.
`lm_params_to_reference` is its inverse, and
`train_state_from_reference` / `train_state_to_reference` carry a whole
training state (parameters, AdamW moments, ``count`` and ``step``)
between the port's layout (lists over periods) and the reference's
(stacked), so either package's trainer resumes the other's checkpoint.

Sparse PCA has no learned weights: what makes the two packages compute
the same thing is the same configuration and the same numeric state (the
variance screen, the reduced covariance, a warm start, a fitted
component, a packed serving model).  These helpers take that state as
the reference produces it — its ``SPCAConfig`` as ``dataclasses.asdict``,
numpy arrays, a ``PCResult`` as a dict, a registry version's checkpoint
leaves — and return the port's objects, without importing the reference.
"""
from __future__ import annotations

from dataclasses import fields
from typing import NamedTuple

import numpy as np
import torch

from .core.spca import PCResult, SPCAConfig
from .device import as_tensor, to_host
from .serve.registry import ModelVersion, version_from_tree

_CFG_FIELDS = {f.name for f in fields(SPCAConfig)}
_PC_FIELDS = {f.name for f in fields(PCResult)}


class ReferenceState(NamedTuple):
    cfg: SPCAConfig
    variances: np.ndarray | None      # host array, as the driver takes it
    Sigma_hat: torch.Tensor | None
    X0: torch.Tensor | None


def config_from_reference(cfg_fields: dict) -> SPCAConfig:
    """The port's `SPCAConfig` from the reference's fields (every field
    name is shared; an unknown name raises)."""
    unknown = set(cfg_fields) - _CFG_FIELDS
    if unknown:
        raise TypeError(f"not SPCAConfig fields: {sorted(unknown)}")
    kw = dict(cfg_fields)
    if "support_buckets" in kw:
        kw["support_buckets"] = tuple(kw["support_buckets"])
    return SPCAConfig(**kw)


def from_reference(cfg_fields: dict, *, variances=None, Sigma_hat=None,
                   X0=None, device=None) -> ReferenceState:
    """The reference's config dict and numpy state as the port's
    `SPCAConfig` and tensors on ``device`` (the card by default; only
    resolved when there is an array to place)."""
    return ReferenceState(
        cfg=config_from_reference(cfg_fields),
        variances=None if variances is None else np.asarray(variances),
        Sigma_hat=None if Sigma_hat is None else as_tensor(
            np.asarray(Sigma_hat), device),
        X0=None if X0 is None else as_tensor(np.asarray(X0), device),
    )


def pc_result_from_reference(pc_fields: dict, *, device=None) -> PCResult:
    """A reference ``PCResult`` (``dataclasses.asdict`` or the fit
    checkpoint's packed dict) as the port's: host arrays stay numpy, the
    reduced solver state (``X_reduced``, ``Sigma_reduced``) becomes tensors
    on ``device``."""
    unknown = set(pc_fields) - _PC_FIELDS
    if unknown:
        raise TypeError(f"not PCResult fields: {sorted(unknown)}")
    d = dict(pc_fields)
    for name in ("X_reduced", "Sigma_reduced"):
        if d.get(name) is not None:
            d[name] = as_tensor(np.asarray(d[name]), device)
    if d.get("reduced_support") is not None:
        d["reduced_support"] = np.asarray(d["reduced_support"], np.int64)
    return PCResult(
        **{**d, "x": np.asarray(d["x"]),
           "support": np.asarray(d["support"], np.int64),
           "lam": float(d["lam"]), "variance": float(d["variance"]),
           "cardinality": int(d["cardinality"]),
           "reduced_n": int(d["reduced_n"]), "gap": float(d["gap"])})


_VERSION_KEYS = {"support_idx", "values", "n_features", "lam", "lams",
                 "screen_var", "screen_mean", "screen_count", "meta_json"}


def model_version_from_reference(fields: dict, *, device=None
                                 ) -> ModelVersion:
    """A reference registry version's leaves (numpy arrays under the
    reference's keys: ``support_idx``, ``values``, ``n_features``, ``lam``,
    ``lams``, ``screen_var``, ``screen_mean``, ``screen_count``,
    ``meta_json``) as the port's `serve.ModelVersion` (version 0), its
    projector and screen on ``device`` (the card by default).  An unknown
    key raises."""
    unknown = set(fields) - _VERSION_KEYS
    if unknown:
        raise TypeError(f"not registry leaves: {sorted(unknown)}")
    return version_from_tree({k: np.asarray(v) for k, v in fields.items()},
                             version=0, device=device)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _by_reference_path(tree) -> dict:
    """``{reference path: [(period or None, leaf), ...]}`` of a tree in the
    port's layout: a path's first list index is the period of a leaf the
    reference stacks along ``n_periods``."""
    out: dict[tuple, list] = {}
    for path, leaf in _leaves(tree):
        split = [i for i, k in enumerate(path) if isinstance(k, int)]
        if split:
            i = split[0]
            rpath, row = path[:i] + path[i + 1:], path[i]
        else:
            rpath, row = path, None
        out.setdefault(rpath, []).append((row, leaf))
    return out


def _copy_from_reference(dest, tree, what: str):
    """Copy the reference-layout ``tree`` (nested dicts of arrays) into the
    tensors of ``dest`` (the port's layout).  A leaf missing on either
    side, or of another shape or dtype, raises."""
    ref = {path: np.asarray(a) for path, a in _leaves(tree)}
    periods = _by_reference_path(dest)
    for rpath in periods:
        if rpath not in ref:
            raise KeyError(f"the reference {what} have no leaf "
                           + "/".join(map(str, rpath)))
    extra = set(ref) - set(periods)
    if extra:
        raise KeyError(f"{what} leaves the port's model does not have: "
                       + ", ".join("/".join(p) for p in sorted(extra)))
    with torch.no_grad():
        for rpath, dests in periods.items():
            arr = ref[rpath]
            name = "/".join(map(str, rpath))
            if dests[0][0] is not None:
                if arr.shape[0] != len(dests):
                    raise ValueError(f"{name}: {arr.shape[0]} periods in the "
                                     f"reference, {len(dests)} in the port")
            for row, t in dests:
                a = arr if row is None else arr[row]
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"{name}: shape {a.shape} in the "
                                     f"reference, {tuple(t.shape)} here")
                if a.dtype.name != str(t.dtype).removeprefix("torch."):
                    raise TypeError(f"{name}: {a.dtype.name} in the "
                                    f"reference, {t.dtype} here")
                t.copy_(torch.from_numpy(np.array(a)))


def _to_reference(tree, *, like: bool = False) -> dict:
    """The port-layout ``tree`` in the reference's layout: nested dicts of
    numpy arrays, each list over periods stacked along a leading axis
    (sharded leaves gathered first, so a state sharded on any mesh gives
    the same arrays as the one-device state of equal values).
    ``like=True`` gives shape-only ``meta`` tensors instead (what
    `checkpoint.restore` needs to read a step), copying nothing."""
    from .distributed.sharding import whole

    out: dict = {}
    for rpath, items in _by_reference_path(tree).items():
        stacked = items[0][0] is not None
        if like:
            t = items[0][1]
            shape = ((len(items),) if stacked else ()) + tuple(t.shape)
            a = torch.empty(shape, dtype=t.dtype, device="meta")
        else:
            arrs = [to_host(whole(t)) for _, t in items]
            a = np.stack(arrs) if stacked else arrs[0].copy()
        node = out
        for k in rpath[:-1]:
            node = node.setdefault(k, {})
        node[rpath[-1]] = a
    return out


def lm_params_from_reference(model, tree):
    """Copy the reference's LM/EncDec parameters into ``model`` (a port
    `LM` or `EncDec` of the same config) and return it.

    ``tree`` is the reference's parameter pytree as nested dicts of numpy
    arrays (``jax.tree.map(np.asarray, params)``).  A leaf under
    ``stacks/s{i}`` or ``enc_stack`` carries a leading ``n_periods`` axis;
    row ``n`` goes to period ``n`` of the port's stack
    (``stacks/s{i}/{n}/b{j}/...``).  Weights keep the reference's
    ``(d_in, d_out)`` layout, so every leaf is a copy, never a transpose.
    A leaf missing on either side, or of another shape or dtype, raises."""
    _copy_from_reference(model.params(), tree, "parameters")
    model.refresh()
    return model


def lm_params_to_reference(model) -> dict:
    """The inverse of `lm_params_from_reference`: ``model``'s parameters
    as the reference's pytree, nested dicts of numpy arrays with each
    per-period leaf of ``stacks`` and ``enc_stack`` stacked along a leading
    ``n_periods`` axis."""
    return _to_reference(model.params())


def train_state_to_reference(state, *, like: bool = False):
    """A port `TrainState` in the reference's layout: a `TrainState` of
    the same fields whose ``params``, ``opt.mu`` and ``opt.nu`` are
    stacked numpy trees (`lm_params_to_reference`'s layout) and whose
    ``opt.count`` and ``step`` are 0-d int32 arrays.  Saved by
    `checkpoint.save`, its leaf paths are the reference's
    (``.params/embed``, ``.opt/.mu/...``, ``.opt/.count``, ``.step``).
    ``like=True`` gives the shapes only (``meta`` tensors), for
    `checkpoint.restore`."""
    from .optim import OptState

    def scalar(x):
        if like:
            return torch.empty((), dtype=torch.int32, device="meta")
        return np.asarray(to_host(x), dtype=np.int32)

    return type(state)(
        params=_to_reference(state.params, like=like),
        opt=OptState(mu=_to_reference(state.opt.mu, like=like),
                     nu=_to_reference(state.opt.nu, like=like),
                     count=scalar(state.opt.count)),
        step=scalar(state.step))


def train_state_from_reference(model, tree):
    """The reference's training state (anything with the fields
    ``params``, ``opt.mu``, ``opt.nu``, ``opt.count`` and ``step``, its
    trees stacked as the reference's: a reference ``TrainState`` of numpy
    arrays, or what `checkpoint.restore` returns for
    `train_state_to_reference`'s tree) as a port `TrainState` of
    ``model``: the parameters are copied into the model (its
    compute-dtype copy dropped), the moments into float32 tensors on the
    model's device, ``count`` and ``step`` become 0-d int32 CPU tensors."""
    from .optim import OptState, adamw
    from .train.train_step import TrainState

    lm_params_from_reference(model, tree.params)
    params = model.params()
    opt = adamw.init(params)
    _copy_from_reference(opt.mu, tree.opt.mu, "first moments")
    _copy_from_reference(opt.nu, tree.opt.nu, "second moments")

    def scalar(x):
        return torch.tensor(int(to_host(x)), dtype=torch.int32)

    return TrainState(params=params,
                      opt=OptState(mu=opt.mu, nu=opt.nu,
                                   count=scalar(tree.opt.count)),
                      step=scalar(tree.step))
