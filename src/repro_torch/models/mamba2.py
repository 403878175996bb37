"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) sequence mixer (the
port of ``repro.models.mamba2``).

Training / prefill path: the chunked SSD algorithm — within-chunk terms
computed as masked attention-like products, across-chunk recurrence over
per-chunk states.  The reference runs that recurrence as an associative
scan; here it is a loop over chunks, which computes the same states (in
another order of float32 products).  O(L * Q) work for chunk size Q.

Decode path: the O(1)-per-token state recurrence
    S <- exp(dt*A) * S + B^T (x*dt),   y = C S + D x
carrying (conv_state, ssm_state).

Single B/C group (n_groups=1), multi-head x (H heads of dim P = d_inner/H).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import F32, Params, init_rms_norm, normal, rms_norm


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads
    P = d_in // H
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N  # x, B, C go through the causal conv
    return d_in, H, P, N, conv_dim


def init_mamba(gen, cfg, device=None) -> Params:
    d = cfg.d_model
    d_in, H, P, N, conv_dim = _dims(cfg)
    dt = cfg.param_dtype
    return Params(
        ln=init_rms_norm(d, dt, device),
        # order: [z (d_in), x (d_in), B (N), C (N), dt (H)]
        in_proj=normal(gen, (d, 2 * d_in + 2 * N + H), d ** -0.5, dt, device),
        conv=normal(gen, (cfg.ssm_conv, conv_dim), 0.1, dt, device),
        A_log=torch.zeros((H,), dtype=F32, device=device),   # A = -exp(A_log) = -1
        ssm_D=torch.ones((H,), dtype=F32, device=device),
        dt_bias=torch.zeros((H,), dtype=F32, device=device),
        ssm_norm=init_rms_norm(d_in, dt, device),
        out_proj=normal(gen, (d_in, d), d_in ** -0.5, dt, device),
    )


def _split_proj(proj, cfg):
    d_in, H, P, N, _ = _dims(cfg)
    return torch.split(proj, [d_in, d_in, N, N, H], dim=-1)


def _causal_conv(seq, weight):
    """Depthwise causal conv over (B, L, C) with (W, C) weights."""
    W = weight.shape[0]
    pad = F.pad(seq, (0, 0, W - 1, 0))
    L = seq.shape[1]
    out = pad[:, 0:L, :] * weight[0][None, None, :]
    for i in range(1, W):
        out = out + pad[:, i:i + L, :] * weight[i][None, None, :]
    return F.silu(out)


def mamba_mixer(params, x, *, cfg):
    """Training / prefill forward: (B, L, d) -> (B, L, d) via chunked SSD."""
    Bsz, L, d = x.shape
    d_in, H, P, N, conv_dim = _dims(cfg)
    Q = min(cfg.ssm_chunk, L)
    while L % Q:
        Q //= 2
    nC = L // Q

    xn = rms_norm(params["ln"], x, eps=cfg.norm_eps)
    proj = xn @ params["in_proj"]
    z, xs, B_, C_, dtr = _split_proj(proj, cfg)
    conv_out = _causal_conv(torch.cat([xs, B_, C_], -1), params["conv"])
    xs, B_, C_ = torch.split(conv_out, [d_in, N, N], dim=-1)

    dt = F.softplus(dtr.to(F32) + params["dt_bias"])                 # (B,L,H)
    A = -torch.exp(params["A_log"])                                  # (H,)
    log_a = dt * A                                                   # (B,L,H) <=0
    xh = xs.reshape(Bsz, L, H, P)
    xdt = xh.to(F32) * dt[..., None]                                 # (B,L,H,P)

    # --- chunk ---
    ca = log_a.reshape(Bsz, nC, Q, H)
    cum = torch.cumsum(ca, dim=2)                                    # (B,C,Q,H)
    Bc = B_.reshape(Bsz, nC, Q, N).to(F32)
    Cc = C_.reshape(Bsz, nC, Q, N).to(F32)
    xc = xdt.reshape(Bsz, nC, Q, H, P)

    # Intra-chunk: masked attention-like term.
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)                 # (B,C,Q,Q)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B,C,Q,Q,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    wts = torch.where(causal[None, None, :, :, None],
                      scores[..., None] * decay, 0.0)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", wts, xc)

    # Per-chunk terminal states.
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)                   # (B,C,Q,H)
    S_chunk = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc, decay_end, xc)

    # Across chunks: S_c = a_c * S_{c-1} + S_chunk_c; S_prev[c] is the
    # state entering chunk c (zero for the first).
    a_chunk = torch.exp(cum[:, :, -1, :])                            # (B,C,H)
    prev = torch.zeros_like(S_chunk[:, 0])
    S_prev = []
    for c in range(nC):
        S_prev.append(prev)
        prev = prev * a_chunk[:, c, :, None, None] + S_chunk[:, c]
    S_prev = torch.stack(S_prev, dim=1)                              # (B,C,H,N,P)
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cc, S_prev) \
        * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(Bsz, L, H, P)
    y = y + params["ssm_D"][None, None, :, None] * xh.to(F32)
    y = y.reshape(Bsz, L, d_in).to(x.dtype)
    y = rms_norm(params["ssm_norm"], y * F.silu(z), eps=cfg.norm_eps)
    return y @ params["out_proj"]


def init_mamba_cache(cfg, batch: int, dtype, device=None):
    d_in, H, P, N, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=F32, device=device),
    }


def mamba_decode(params, x, cache, *, cfg):
    """One-token decode: (B, 1, d) -> (B, 1, d), O(1) state update."""
    Bsz = x.shape[0]
    d_in, H, P, N, conv_dim = _dims(cfg)
    xn = rms_norm(params["ln"], x[:, 0, :], eps=cfg.norm_eps)
    proj = xn @ params["in_proj"]
    z, xs, B_, C_, dtr = _split_proj(proj, cfg)

    conv_in = torch.cat([xs, B_, C_], -1)                            # (B, conv_dim)
    conv_w = params["conv"]
    # the reference concatenates the cache (its dtype) with this step's
    # input under jax's promotion; the window takes the wider of the two
    wdt = torch.promote_types(cache["conv"].dtype, conv_in.dtype)
    window = torch.cat([cache["conv"].to(wdt), conv_in[:, None, :].to(wdt)], 1)
    cdt = torch.promote_types(wdt, conv_w.dtype)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window.to(cdt), conv_w.to(cdt)))
    new_conv = window[:, 1:, :]
    xs, B_, C_ = torch.split(conv_out, [d_in, N, N], dim=-1)

    dt = F.softplus(dtr.to(F32) + params["dt_bias"])                # (B,H)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)                                           # (B,H)
    xh = xs.reshape(Bsz, H, P).to(F32)
    S = cache["ssm"] * a[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", B_.to(F32), xh * dt[..., None]
    )
    y = torch.einsum("bn,bhnp->bhp", C_.to(F32), S)
    y = y + params["ssm_D"][None, :, None] * xh
    y = y.reshape(Bsz, d_in).to(x.dtype)
    y = rms_norm(params["ssm_norm"], y * F.silu(z), eps=cfg.norm_eps)
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"conv": new_conv, "ssm": S}
