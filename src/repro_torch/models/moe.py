"""Mixture-of-Experts FFN: top-k routing with capacity-based one-hot
dispatch (the port of ``repro.models.moe``).

Tokens are bucketed into (expert, capacity) slots via one-hot einsums, per
routing group of ``moe_group_size`` tokens; each expert fills its capacity
in token order and drops the rest (Switch-style).  Shared experts
(DeepSeek-MoE style) are one fused dense MLP every token passes through.

``torch.topk`` (sorted) ranks the experts; on equal router probabilities
the order of the tied experts is the library's, which ``jax.lax.top_k``
need not share, so the parity tests use inputs without ties.

The load-balancing loss is ``E * sum_e me_e * ce_e`` (the mean router
probability and the top-1 token fraction of each expert): a product of two
means, so the loss of a batch is not the mean of its parts' losses.  The
sharded train step runs its data groups' rows apart and pools ``me`` and
``ce`` over them (`router_stats` hands it each layer's pair).
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from .layers import F32, Params, init_mlp, init_rms_norm, mlp, normal, rms_norm


def init_moe(gen, cfg, device=None) -> Params:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    dt = cfg.param_dtype
    p = {
        "ln": init_rms_norm(d, dt, device),
        "router": normal(gen, (d, E), d ** -0.5, dt, device),
        "experts": Params(
            wi_gate=normal(gen, (E, d, f), d ** -0.5, dt, device),
            wi_up=normal(gen, (E, d, f), d ** -0.5, dt, device),
            wo=normal(gen, (E, f, d), f ** -0.5, dt, device),
        ),
    }
    if cfg.n_shared_experts:
        # Shared experts fused into one dense MLP of width n_shared * f.
        p["shared"] = init_mlp(gen, cfg, d_ff=cfg.n_shared_experts * f,
                               device=device)
    return Params(**p)


_sink = threading.local()


@contextlib.contextmanager
def router_stats():
    """While entered, every `moe` call that computes the auxiliary losses
    appends its ``(me, ce)`` (float32, ``(E,)`` each; ``me`` carries the
    graph to the router) to the yielded list, in call order: one pair a
    MoE layer of a forward pass."""
    prev = getattr(_sink, "out", None)
    _sink.out = out = []
    try:
        yield out
    finally:
        _sink.out = prev


def lb_loss(me, ce, cfg):
    """The Switch load-balancing loss of one layer's ``me`` and ``ce``."""
    return cfg.n_experts * torch.sum(me * ce)


def _capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, ((c + 7) // 8) * 8)


def _group_size(T: int, cfg) -> int:
    g_size = min(cfg.moe_group_size, T)
    while T % g_size:
        g_size //= 2
    return g_size


def _route(params, x, cfg, g_size):
    """The router on ``x``'s tokens in routing groups of ``g_size`` (all
    of them where there are fewer): the normed groups ``xg``, the router
    logits and probabilities, and each token's top-k gates and experts."""
    B, S, d = x.shape
    xn = rms_norm(params["ln"], x, eps=cfg.norm_eps)
    T = B * S
    g_here = min(g_size, T)
    xg = xn.reshape(T // g_here, g_here, d)
    logits = xg.to(F32) @ params["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)                        # (G, t, E)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return xg, logits, probs, gate_vals, expert_idx


def route(params, x, *, cfg, group_size):
    """Each token's experts, (tokens, top_k): the first step of `moe`,
    for a routing group that spans several callers' tokens (`slots`)."""
    return _route(params, x, cfg, group_size)[4].reshape(-1, cfg.top_k)


def slots(expert_idx, cfg, C):
    """Where each token's choices land, ``(slot, keep)`` each shaped like
    ``expert_idx`` (G, t, top_k): the choices in priority order, each
    expert filling its ``C`` slots in token order within its group
    (Switch-style dropping)."""
    E = cfg.n_experts
    fill = torch.zeros((expert_idx.shape[0], E), dtype=torch.int64,
                       device=expert_idx.device)
    slot, keep = [], []
    for j in range(cfg.top_k):
        e_onehot = F.one_hot(expert_idx[..., j], E)                # (G,t,E)
        pos_in_e = fill[:, None, :] + torch.cumsum(e_onehot, dim=1) - e_onehot
        kept = (pos_in_e < C) & (e_onehot > 0)
        fill = fill + torch.sum(e_onehot * kept, dim=1)
        at = expert_idx[..., j:j + 1]
        slot.append(torch.gather(pos_in_e, -1, at)[..., 0])
        keep.append(torch.gather(kept, -1, at)[..., 0])
    return torch.stack(slot, -1), torch.stack(keep, -1)


def moe(params, x, *, cfg, experts=None, with_aux=True, group_size=None,
        assigned=None):
    """Returns (out, aux) where aux carries router losses for the train loss.

    A lane of the partitioned train step (`distributed.partition`) passes
    ``experts=(e0, e1)``, the experts its ``params["experts"]`` hold: the
    router, dispatch and combine are computed whole, the lane runs its
    experts (and its share of the shared MLP) and returns its partial
    output; ``with_aux=False`` leaves the losses (aux None) to one lane.

    The partitioned serve steps route as the reference routes the whole
    batch: ``group_size`` is its routing group (and sets the capacity);
    where a group spans several data groups' tokens, ``assigned`` is this
    call's ``(slot, keep)`` (`slots` of the group's pooled `route`)."""
    B, S, d = x.shape
    g_size = group_size or _group_size(B * S, cfg)
    xg, logits, probs, gate_vals, expert_idx = _route(params, x, cfg, g_size)
    G = xg.shape[0]

    E = cfg.n_experts
    C = _capacity(g_size, cfg)
    if assigned is None:
        assigned = slots(expert_idx, cfg, C)
    slot, keep = (t.reshape(expert_idx.shape) for t in assigned)
    combine = torch.zeros((G, xg.shape[1], E, C), dtype=F32, device=x.device)
    for j in range(cfg.top_k):
        e_onehot = F.one_hot(expert_idx[..., j], E)                # (G,t,E)
        sl_onehot = F.one_hot(torch.clamp(slot[..., j], 0, C - 1), C).to(
            F32) * keep[..., j, None]
        combine = combine + sl_onehot[:, :, None, :] * e_onehot[..., None] \
            * gate_vals[..., j][..., None, None]

    if experts is not None:
        combine = combine[:, :, experts[0]:experts[1]]
    dispatch = (combine > 0).to(xg.dtype)                         # (G, t, E, C)
    dispatched = torch.einsum("gtec,gtd->gecd", dispatch, xg)

    w = params["experts"]
    h = F.silu(torch.einsum("gecd,edf->gecf", dispatched, w["wi_gate"])) * \
        torch.einsum("gecd,edf->gecf", dispatched, w["wi_up"])
    eout = torch.einsum("gecf,efd->gecd", h, w["wo"])

    out = torch.einsum("gtec,gecd->gtd", combine.to(xg.dtype), eout)
    out = out.reshape(B, S, d)

    if cfg.n_shared_experts and "shared" in params:
        out = out + mlp(params["shared"], x, cfg=cfg)
    if not with_aux:
        return out, None

    # Router aux losses (Switch load-balance + z-loss), in f32.
    me = torch.mean(probs, dim=(0, 1))                             # mean prob/expert
    ce = torch.mean(
        torch.sum(F.one_hot(expert_idx[..., 0], E).to(F32), dim=-2)
        / xg.shape[1], dim=0,
    )                                                              # top-1 token frac
    sink = getattr(_sink, "out", None)
    if sink is not None:
        sink.append((me, ce))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = {"moe_lb_loss": lb_loss(me, ce, cfg), "moe_z_loss": z_loss}
    return out, aux
