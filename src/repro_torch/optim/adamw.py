"""AdamW over trees of tensors (port of ``repro.optim.adamw``).

The moments are trees shaped like the parameters, in float32.  `update`
follows the reference's order of operations: the clip scale
``min(1, clip / (gnorm + 1e-9))``, the bias corrections ``1 - b ** count``
in float32, then per leaf ``p32 - lr * (step + wd * p32)`` cast back to
the parameter's dtype.  It writes the parameters and moments in place
(the train step calls it under ``torch.no_grad()``), so a model's
parameters can be the tree it updates.

Trees are nested dicts (and lists, read as the port's periods of one
leaf that the reference stacks along ``n_periods``: see
`reference_order`).  The step counter ``count`` is a 0-d int32 tensor on
the CPU; the scalars made from it and from the schedule (bias
corrections, the learning rate) are float32 values computed on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def reference_order(tree) -> list[list[torch.Tensor]]:
    """The leaves in the reference's leaf order (sorted dict keys, which
    is `checkpoint._flatten`'s), a group a reference leaf: a list over
    periods is one stacked leaf there, so its periods' leaves of one
    path form one group, in period order."""
    if isinstance(tree, dict):
        return [g for k in sorted(tree) for g in reference_order(tree[k])]
    if isinstance(tree, list):
        per = [reference_order(t) for t in tree]
        return [[x for g in groups for x in g] for groups in zip(*per)]
    return [[tree]]


def init(params) -> OptState:
    zeros = lambda p: torch.zeros_like(p, dtype=F32).detach()  # noqa: E731
    return OptState(mu=_map(zeros, params), nu=_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32))


def _sum_of_squares(groups, whole=None) -> torch.Tensor:
    """sqrt of the sum of squares of the leaves of ``groups``, summed leaf
    by leaf in order; ``whole(x)``, when given, makes each leaf from what
    ``groups`` holds just before it is summed (the sharded train step
    puts one pooled gradient leaf together at a time)."""
    total = None
    for group in groups:
        s = None
        for leaf in group:
            if whole is not None:
                leaf = whole(leaf)
            part = torch.sum(torch.square(leaf.to(F32)))
            s = part if s is None else s + part
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=F32)
    return torch.sqrt(total)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, summed leaf by
    leaf in the reference's leaf order (`reference_order`)."""
    return _sum_of_squares(reference_order(tree))


def grad_norm(grads, params) -> torch.Tensor:
    """The global norm of ``grads`` (a tree shaped like ``params``, or its
    leaves in `_leaves` order), summed in ``params``' reference leaf order
    (`reference_order`)."""
    grad_of = {id(p): g for p, g in zip(_leaves(params), _leaves(grads))}
    return _sum_of_squares([[grad_of[id(p)] for p in group]
                            for group in reference_order(params)])


def update(grads, state: OptState, params, cfg: AdamWConfig, lr_scale=1.0,
           *, gnorm=None):
    """One AdamW step.  ``grads`` is a tree shaped like ``params``, or its
    leaves in `_leaves` order (what the train step holds).  Writes
    ``params`` and the moments in place and returns (params, new_state,
    metrics): metrics ``grad_norm`` (before clipping, a 0-d float32 tensor
    on the gradients' device, summed in the reference's leaf order) and
    ``lr`` (a 0-d float32 CPU tensor).  ``gnorm``, when given, is the
    global norm to clip by in place of ``grads``' own: a lane updating
    its shards of a sharded state clips by the norm of the whole
    gradient."""
    grads = list(_leaves(grads))
    if gnorm is None:
        gnorm = grad_norm(grads, params)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    # float32 values on the host, passed to the card's arithmetic exactly
    c32 = count.to(F32)
    b1c = float(1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32), c32))
    b2c = float(1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32), c32))
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=F32).cpu()
    lr_f = float(lr)

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * g
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * g * g
        step = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        p32 = p.to(F32)
        p32 = p32 - lr_f * (step + cfg.weight_decay * p32)
        p.copy_(p32.to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)

    with torch.no_grad():
        for p, g, m, v in zip(_leaves(params), grads,
                              _leaves(state.mu), _leaves(state.nu)):
            upd(p, g, m, v)
    return params, OptState(mu=state.mu, nu=state.nu, count=count), {
        "grad_norm": gnorm, "lr": lr.reshape(())}
