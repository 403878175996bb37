"""Mixture-of-Experts FFN: top-k routing with capacity-based one-hot
dispatch (the port of ``repro.models.moe``).

Tokens are bucketed into (expert, capacity) slots via one-hot einsums, per
routing group of ``moe_group_size`` tokens; each expert fills its capacity
in token order and drops the rest (Switch-style).  Shared experts
(DeepSeek-MoE style) are one fused dense MLP every token passes through.

``torch.topk`` (sorted) ranks the experts; on equal router probabilities
the order of the tied experts is the library's, which ``jax.lax.top_k``
need not share, so the parity tests use inputs without ties.
"""
from __future__ import annotations

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


def _capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, ((c + 7) // 8) * 8)


def _group_size(T: int, cfg) -> int:
    g_size = min(cfg.moe_group_size, T)
    while T % g_size:
        g_size //= 2
    return g_size


def moe(params, x, *, cfg, experts=None, with_aux=True):
    """Returns (out, aux) where aux carries router losses for the train loss.

    A lane of the partitioned train step (`distributed.partition`) passes
    ``experts=(e0, e1)``, the experts its ``params["experts"]`` hold: the
    router, dispatch and combine are computed whole, the lane runs its
    experts (and its share of the shared MLP) and returns its partial
    output; ``with_aux=False`` leaves the losses (aux None) to one lane."""
    B, S, d = x.shape
    xn = rms_norm(params["ln"], x, eps=cfg.norm_eps)
    T = B * S
    g_size = _group_size(T, cfg)
    G = T // g_size
    xg = xn.reshape(G, g_size, d)

    logits = xg.to(F32) @ params["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)                        # (G, t, E)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    E = cfg.n_experts
    C = _capacity(g_size, cfg)
    # Slot assignment: process the k choices in priority order; each expert
    # fills its capacity in token order (Switch-style dropping).
    combine = torch.zeros((G, g_size, E, C), dtype=F32, device=x.device)
    fill = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    for j in range(cfg.top_k):
        e_onehot = F.one_hot(expert_idx[..., j], E)                # (G,t,E)
        pos_in_e = fill[:, None, :] + torch.cumsum(e_onehot, dim=1) - e_onehot
        keep = (pos_in_e < C) & (e_onehot > 0)
        slot = torch.clamp(pos_in_e, 0, C - 1)
        sl_onehot = F.one_hot(slot, C).to(F32) * keep[..., None]
        combine = combine + sl_onehot * e_onehot[..., None] \
            * gate_vals[..., j][..., None, None]
        fill = fill + torch.sum(e_onehot * keep, dim=1)

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
        torch.sum(F.one_hot(expert_idx[..., 0], E).to(F32), dim=-2) / g_size,
        dim=0,
    )                                                              # top-1 token frac
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}
    return out, aux
