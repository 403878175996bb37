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
The training forward and the decode step also run on a range of heads
(`mamba_gated`, `mamba_decode_gated`, `gated_sumsq`, `mamba_project`):
the partitioned steps split the heads over their ``model`` lanes.
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


def _split_proj(proj, d_in, N, H):
    """``in_proj``'s output as ``z, x, B, C, dt`` (of ``H`` heads whose
    channels are ``d_in``)."""
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


def mamba_gated(params, x, *, cfg):
    """The chunked SSD of the heads ``params`` hold, gated and not yet
    normalised: (B, L, d) -> (B, L, H' * P), in ``x``'s dtype.  ``params``
    may be cut to a range of H' heads (`head_columns` gives the cuts):
    ``in_proj``'s columns ``[z, x, B, C, dt]`` of those heads (all of B
    and C: one B/C group), ``conv``'s channels ``[x, B, C]`` likewise,
    ``A_log``, ``ssm_D`` and ``dt_bias`` by head."""
    Bsz, L, d = x.shape
    _, _, P, N, _ = _dims(cfg)
    H = params["A_log"].shape[0]
    d_in = H * P
    Q = min(cfg.ssm_chunk, L)
    while L % Q:
        Q //= 2
    nC = L // Q

    xn = rms_norm(params["ln"], x, eps=cfg.norm_eps)
    proj = xn @ params["in_proj"]
    z, xs, B_, C_, dtr = _split_proj(proj, d_in, N, H)
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

    # Intra-chunk: masked attention-like term.  The mask goes inside the
    # exp as well: above the diagonal cum_q - cum_k >= 0 overflows float32
    # once a chunk's decay passes ~88, and the where's gradient would then
    # meet 0 * inf (the reference's form, NaN gradients from chunk ~128 at
    # A = -1); below it both forms give the same values.
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)                 # (B,C,Q,Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    mask = causal[None, None, :, :, None]
    decay = torch.exp(torch.where(
        mask, cum[:, :, :, None, :] - cum[:, :, None, :, :], -torch.inf))
    wts = torch.where(mask, scores[..., None] * decay, 0.0)         # (B,C,Q,Q,H)
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
    return y * F.silu(z)


def mamba_mixer(params, x, *, cfg):
    """Training / prefill forward: (B, L, d) -> (B, L, d) via chunked SSD."""
    y = mamba_gated(params, x, cfg=cfg)
    y = rms_norm(params["ssm_norm"], y, eps=cfg.norm_eps)
    return y @ params["out_proj"]


def gated_sumsq(g):
    """A head range's share of ``ssm_norm``'s mean square: the float32 sum
    of squares of its gated channels, (B, L, 1).  The norm spans all
    ``d_in`` channels, so a split mixer adds the ranges' sums (in range
    order) and divides by ``d_in`` before any range is scaled."""
    g32 = g.to(F32)
    return torch.sum(g32 * g32, dim=-1, keepdim=True)


def mamba_project(params, g, inv_rms):
    """A head range's share of the mixer's output: its gated channels
    ``g`` scaled by ``inv_rms`` (``rsqrt(mean square + eps)`` over all
    ``d_in`` channels, float32) and ``ssm_norm``'s scales, times its rows
    of ``out_proj``; the ranges' shares add up to `mamba_mixer`'s."""
    y = g.to(F32) * inv_rms
    y = (y * (1.0 + params["ssm_norm"].to(F32))).to(g.dtype)
    return y @ params["out_proj"]


def head_columns(cfg, heads) -> dict:
    """Where heads ``[h0, h1)`` lie in the mixer's leaves: for each leaf
    split by head, the ``(start, stop)`` ranges of its last dim (rows of
    ``out_proj``) that `mamba_gated` / `mamba_project` read, in order."""
    d_in, H, P, N, _ = _dims(cfg)
    h0, h1 = heads
    ch = (h0 * P, h1 * P)
    return {
        "in_proj": [ch, (d_in + ch[0], d_in + ch[1]),
                    (2 * d_in, 2 * d_in + 2 * N),
                    (2 * d_in + 2 * N + h0, 2 * d_in + 2 * N + h1)],
        "conv": [ch, (d_in, d_in + 2 * N)],
        "A_log": [heads], "ssm_D": [heads], "dt_bias": [heads],
        "ssm_norm": [ch], "out_proj": [ch],
    }


def init_mamba_cache(cfg, batch: int, dtype, device=None):
    d_in, H, P, N, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=F32, device=device),
    }


def mamba_decode_gated(params, x, conv, ssm, *, cfg):
    """One-token decode of the heads ``params`` hold (cut as for
    `mamba_gated`), from their conv window ``conv`` (B, W-1, channels:
    their ``x`` channels, then all of B and C) and SSM state ``ssm`` (B,
    H', N, P): the gated channels (B, H' * P) in ``x``'s dtype, not yet
    normalised, and the new ``conv`` and ``ssm``."""
    Bsz = x.shape[0]
    _, _, P, N, _ = _dims(cfg)
    H = params["A_log"].shape[0]
    d_in = H * P
    xn = rms_norm(params["ln"], x[:, 0, :], eps=cfg.norm_eps)
    proj = xn @ params["in_proj"]
    z, xs, B_, C_, dtr = _split_proj(proj, d_in, N, H)

    conv_in = torch.cat([xs, B_, C_], -1)                            # (B, conv_dim)
    conv_w = params["conv"]
    # the reference concatenates the cache (its dtype) with this step's
    # input under jax's promotion; the window takes the wider of the two
    wdt = torch.promote_types(conv.dtype, conv_in.dtype)
    window = torch.cat([conv.to(wdt), conv_in[:, None, :].to(wdt)], 1)
    cdt = torch.promote_types(wdt, conv_w.dtype)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window.to(cdt), conv_w.to(cdt)))
    new_conv = window[:, 1:, :]
    xs, B_, C_ = torch.split(conv_out, [d_in, N, N], dim=-1)

    dt = F.softplus(dtr.to(F32) + params["dt_bias"])                # (B,H)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)                                           # (B,H)
    xh = xs.reshape(Bsz, H, P).to(F32)
    S = ssm * a[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", B_.to(F32), xh * dt[..., None]
    )
    y = torch.einsum("bn,bhnp->bhp", C_.to(F32), S)
    y = y + params["ssm_D"][None, :, None] * xh
    y = y.reshape(Bsz, d_in).to(x.dtype)
    return y * F.silu(z), new_conv, S


def mamba_decode(params, x, cache, *, cfg):
    """One-token decode: (B, 1, d) -> (B, 1, d), O(1) state update."""
    g, new_conv, S = mamba_decode_gated(params, x, cache["conv"],
                                        cache["ssm"], cfg=cfg)
    y = rms_norm(params["ssm_norm"], g, eps=cfg.norm_eps)
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"conv": new_conv, "ssm": S}
