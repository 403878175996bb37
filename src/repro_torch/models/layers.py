"""Shared transformer layers: RMSNorm, RoPE, GQA attention (full / sliding
window / cross), gated MLP (the port of ``repro.models.layers``).

Parameters live in `Params` modules whose names are the reference's dict
keys; every forward is a plain function ``fn(params, x, ...)`` on a dict of
tensors (`param_tree` of the module, in the compute dtype), as the
reference's are.  Weights keep the reference's ``(d_in, d_out)`` layout, so
every projection is ``x @ W``.

Norms, softmax and rope run in float32; the matrix products run in the
compute dtype, and where the reference asks for float32 accumulation
(``preferred_element_type``) the operands are widened to float32 first.
PyTorch does not promote mixed dtypes in ``@``: every product here has
operands of one dtype, as the reference's promotion would give.

Attention is plain tensor arithmetic (no fused kernel): the reference has
no attention kernel, so there is none to port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

F32 = torch.float32


# ------------------------------------------------------------ parameters ---
class Params(nn.Module):
    """A named set of parameters and sub-blocks (one dict of the
    reference's parameter tree)."""

    def __init__(self, **leaves):
        super().__init__()
        for name, v in leaves.items():
            if isinstance(v, nn.Module):
                self.add_module(name, v)
            else:
                self.register_parameter(name, nn.Parameter(v))


def param_tree(module):
    """The module's parameters as the reference's nested dict (a
    `nn.ModuleList` becomes a list of its members' trees)."""
    if isinstance(module, nn.ModuleList):
        return [param_tree(m) for m in module]
    out = {n: p for n, p in module.named_parameters(recurse=False)}
    out.update({n: param_tree(m) for n, m in module.named_children()})
    return out


def normal(gen, shape, scale, dtype, device):
    """Standard normal draws from ``gen`` times ``scale``.  A CPU generator
    (the default) draws on the CPU, so the same seed gives the same weights
    on every device; a CUDA generator draws on its card, copying nothing
    through the host.  On the ``meta`` device nothing is drawn: the
    tensor has a shape and a dtype and no storage."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, dtype=F32, device=gen.device) \
        * scale
    return w.to(device=device, dtype=dtype)


# ----------------------------------------------------------------- norms ---
def rms_norm(scale, x, *, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(dt)


def init_rms_norm(d: int, dtype, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)


# ------------------------------------------------------------------ rope ---
def rope(x, positions, *, theta: float = 1e4):
    """Rotary embedding on split halves. x: (..., seq, heads, head_dim),
    positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    expo = -torch.arange(0, half, dtype=F32, device=x.device) / half
    # a Python base: a tensor made from it on the card would be a host
    # copy that waits for the card, twice a layer
    freq = torch.pow(float(theta), expo)
    ang = positions[..., :, None].to(F32) * freq          # (..., seq, half)
    cos = torch.cos(ang)[..., :, None, :]                  # (..., seq, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention ---
def init_attention(gen, cfg, device=None) -> Params:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    scale = d ** -0.5
    p = {
        "ln": init_rms_norm(d, dt, device),
        "wq": normal(gen, (d, H * hd), scale, dt, device),
        "wk": normal(gen, (d, K * hd), scale, dt, device),
        "wv": normal(gen, (d, K * hd), scale, dt, device),
        "wo": normal(gen, (H * hd, d), (H * hd) ** -0.5, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((K * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((K * hd,), dtype=dt, device=device)
    return Params(**p)


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _attn_scores_mask(q_pos, k_pos, *, window: int | None, causal: bool):
    """(q, k) boolean mask: True = attend."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return ok


def _online_softmax_step(m, l, acc, s, vblk, pv_eq):
    """One KV block of the online softmax: fold scores ``s`` (masked with
    -inf) and values ``vblk`` into the running (max, denom, accum)."""
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    # Guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> nan.
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l = l * corr + torch.sum(p, dim=-1)
    pv = torch.einsum(pv_eq, p.to(vblk.dtype).to(F32), vblk.to(F32))
    acc = acc * corr[..., None] + pv
    return m_new, l, acc


def flash_attention(q, k, v, q_pos, k_pos, *, causal, window,
                    kv_block: int = 1024, block_skip: bool = False):
    """Blockwise (FlashAttention-style) softmax(QK^T)V with O(S*Bk) memory.

    q: (B, Sq, K, rep, hd) grouped GQA layout; k, v: (B, Skv, K, hd).  A
    loop over KV blocks carries the running (max, denom, accum), the
    online-softmax recursion the reference scans.

    ``block_skip=True`` (sliding-window layers, contiguous q == positions):
    each q block only sees ceil(window/kv_block)+1 KV blocks, so the loop
    runs over *relative* block offsets with gathered KV, O(S*window) work.
    """
    B, Sq, K, rep, hd = q.shape
    Skv = k.shape[1]
    if block_skip and window is not None and Sq == Skv and Sq % kv_block == 0:
        return _flash_window_skip(q, k, v, q_pos, k_pos, causal=causal,
                                  window=window, kv_block=kv_block)
    nb = Skv // kv_block
    kb = k.reshape(B, nb, kv_block, K, hd)
    vb = v.reshape(B, nb, kv_block, K, hd)
    pb = k_pos.reshape(k_pos.shape[0], nb, kv_block)

    scale = hd ** -0.5
    dev = q.device
    m = torch.full((B, K, rep, Sq), -torch.inf, dtype=F32, device=dev)
    l = torch.zeros((B, K, rep, Sq), dtype=F32, device=dev)
    acc = torch.zeros((B, K, rep, Sq, hd), dtype=F32, device=dev)
    q32 = q.to(F32)
    for i in range(nb):
        s = torch.einsum("bqkrd,bskd->bkrqs", q32, kb[:, i].to(F32)) * scale
        ok = _attn_scores_mask(q_pos[0], pb[0, i], window=window,
                               causal=causal)
        s = torch.where(ok[None, None, None, :, :], s, -torch.inf)
        m, l, acc = _online_softmax_step(m, l, acc, s, vb[:, i],
                                         "bkrqs,bskd->bkrqd")
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # (B, K, rep, Sq, hd) -> (B, Sq, K, rep, hd)
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)


def _flash_window_skip(q, k, v, q_pos, k_pos, *, causal, window, kv_block):
    """Sliding-window flash attention that never touches KV blocks outside
    the window: q block i attends only to kv blocks i-R+1..i, with
    R = ceil(window/kv_block)+1.  O(S*window) work."""
    B, Sq, K, rep, hd = q.shape
    Bk = kv_block
    nqb = Sq // Bk
    R = min((window + Bk - 1) // Bk + 1, nqb)
    qb = q.reshape(B, nqb, Bk, K, rep, hd).to(F32)
    kb = k.reshape(B, nqb, Bk, K, hd)
    vb = v.reshape(B, nqb, Bk, K, hd)
    qpos = q_pos[0].reshape(nqb, Bk)
    kpos = k_pos[0].reshape(nqb, Bk)
    scale = hd ** -0.5
    dev = q.device

    m = torch.full((B, K, rep, nqb, Bk), -torch.inf, dtype=F32, device=dev)
    l = torch.zeros((B, K, rep, nqb, Bk), dtype=F32, device=dev)
    acc = torch.zeros((B, K, rep, nqb, Bk, hd), dtype=F32, device=dev)
    for r in range(R):
        idx = torch.arange(nqb, device=dev) - r
        blk_ok = idx >= 0
        idxc = torch.clamp(idx, min=0)
        kr = torch.index_select(kb, 1, idxc)     # (B, nqb, Bk, K, hd)
        vr = torch.index_select(vb, 1, idxc)
        kp = torch.index_select(kpos, 0, idxc)   # (nqb, Bk)
        s = torch.einsum("bnqkrd,bnskd->bkrnqs", qb, kr.to(F32)) * scale
        ok = torch.ones((nqb, Bk, Bk), dtype=torch.bool, device=dev)
        if causal:
            ok &= qpos[:, :, None] >= kp[:, None, :]
        ok &= (qpos[:, :, None] - kp[:, None, :]) < window
        ok &= blk_ok[:, None, None]
        s = torch.where(ok[None, None, None], s, -torch.inf)
        m, l, acc = _online_softmax_step(m, l, acc, s, vr,
                                         "bkrnqs,bnskd->bkrnqd")
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # (B, K, rep, nqb, Bk, hd) -> (B, Sq, K, rep, hd)
    out = out.permute(0, 3, 4, 1, 2, 5).reshape(B, Sq, K, rep, hd)
    return out.to(v.dtype)


def _softmax_attend(qg, k, v, mask=None):
    """softmax(q k^T / sqrt(hd)) v in the grouped layout; scores in
    float32, masked with -1e30 where ``mask`` (q, k) is false."""
    hd = qg.shape[-1]
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg.to(F32), k.to(F32)) \
        * hd ** -0.5
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkrqs,bskd->bqkrd", probs, v)   # (B, Sq, K, rep, hd)


def project_kv(params, src, *, cfg, n_kv, positions=None):
    """K and V of ``src`` (B, S, d) in ``n_kv`` heads, ``k`` rotated at
    ``positions`` (self attention; None for cross attention)."""
    k = src @ params["wk"]
    v = src @ params["wv"]
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    k = _split_heads(k, n_kv, cfg.hd)
    v = _split_heads(v, n_kv, cfg.hd)
    if positions is not None:
        k = rope(k, positions, theta=cfg.rope_theta)
    return k, v


def attention(
    params,
    x,
    *,
    cfg,
    positions,
    kv=None,                 # cross-attention source (B, S_kv, d); None = self
    kv_positions=None,
    causal: bool = True,
    window: int | None = None,
    cache=None,              # {"k","v": (B, S_max, K, hd), "pos": int} decode cache
    static_kv=None,          # precomputed {"k","v"} (cross-attn decode)
    heads=None,              # (query heads, KV heads) of params' columns
    q_rows=None,             # (start, stop): only these query rows
    kv_proj=None,            # (k, v) already projected (`project_kv`)
):
    """GQA attention. Returns (out, new_cache).

    Query head h reads KV group h // (H // K).  A decode ``cache`` is
    written in place at ``pos`` and returned with ``pos`` advanced.  Long
    sequences without a cache use blockwise flash attention (O(S*block)
    memory instead of O(S^2)).

    A lane of the partitioned train step (`distributed.partition`) calls
    it on its share: ``heads`` gives the heads its columns of ``wq`` /
    ``wk`` / ``wv`` (and rows of ``wo``) hold, and the output is its
    partial sum; ``q_rows`` keeps query rows ``start:stop`` against the
    whole K/V (the reference's ``ctx`` mode), which ``kv_proj`` gives
    when the lanes projected it a share each.  Under ``cfg.seq_parallel``
    a lane's ``x`` is its rows alone: ``positions`` are theirs, and
    ``kv_positions`` those of the whole K/V of ``kv_proj`` (with ``kv``
    None: self attention; any tensor: cross)."""
    H, K = heads if heads is not None else (cfg.n_heads, cfg.n_kv_heads)
    hd = cfg.hd
    xn = rms_norm(params["ln"], x, eps=cfg.norm_eps)
    q_pos = positions
    if q_rows is not None:
        q_pos = positions[:, q_rows[0]:q_rows[1]]

    q = (xn if q_rows is None else xn[:, q_rows[0]:q_rows[1]]) @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = _split_heads(q, H, hd)
    B, Sq = q.shape[0], q.shape[1]
    rep = H // K

    if static_kv is not None:
        k = static_kv["k"].to(x.dtype)
        v = static_kv["v"].to(x.dtype)
        out = _softmax_attend(q.reshape(B, Sq, K, rep, hd), k, v)
        return out.reshape(B, Sq, H * hd) @ params["wo"], None

    if kv_proj is not None:
        k, v = kv_proj
    else:
        k, v = project_kv(params, xn if kv is None else kv, cfg=cfg,
                          n_kv=K, positions=positions if kv is None
                          else None)

    if kv is None:  # self-attention: rope on q (k is rotated above)
        q = rope(q, q_pos, theta=cfg.rope_theta)
        k_pos = positions if kv_positions is None else kv_positions
    else:
        k_pos = kv_positions

    qg = q.reshape(B, Sq, K, rep, hd)

    new_cache = None
    if cache is not None:
        # Decode: write this step's k/v at index pos, attend over the prefix.
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        if pos + Sq > ck.shape[1]:
            raise ValueError(f"decode cache of {ck.shape[1]} positions is "
                             f"full (pos {pos} + {Sq})")
        ck[:, pos:pos + Sq] = k.to(ck.dtype)
        cv[:, pos:pos + Sq] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "pos": pos + Sq}
        k, v = ck.to(v.dtype), cv.to(v.dtype)
        k_idx = torch.arange(ck.shape[1], device=x.device)[None, :]
        valid = k_idx <= pos
        if window is not None:
            valid &= k_idx > pos - window
        mask = valid[:, None, :]  # (1, q=1, S_max)
    else:
        Skv = k.shape[1]
        kv_block = cfg.attn_kv_block
        blocked_ok = Sq > 1 and Skv >= 2 * kv_block and Skv % kv_block == 0
        if blocked_ok:
            # Window layers skip provably-masked KV blocks.
            use_skip = window is not None and kv is None and Sq == Skv
            out = flash_attention(
                qg, k, v, q_pos, k_pos,
                causal=causal and kv is None, window=window,
                kv_block=kv_block, block_skip=use_skip,
            )
            return out.reshape(B, Sq, H * hd) @ params["wo"], None
        mask = _attn_scores_mask(
            q_pos[0], k_pos[0], window=window, causal=causal and kv is None
        )[None, :, :]

    out = _softmax_attend(qg, k, v, mask)
    return out.reshape(B, Sq, H * hd) @ params["wo"], new_cache


def decode_qkv(params, x, *, cfg, positions, heads=None):
    """One decode step's query, rotated and grouped (B, 1, K, rep, hd), and
    its K and V (B, 1, K, hd), for the heads ``params`` hold (``heads``,
    as in `attention`): the sequence form of the partitioned decode step
    projects them on one lane and sends them where the cache lies."""
    H, K = heads if heads is not None else (cfg.n_heads, cfg.n_kv_heads)
    hd = cfg.hd
    xn = rms_norm(params["ln"], x, eps=cfg.norm_eps)
    q = xn @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = rope(_split_heads(q, H, hd), positions, theta=cfg.rope_theta)
    k, v = project_kv(params, xn, cfg=cfg, n_kv=K, positions=positions)
    return q.reshape(q.shape[0], q.shape[1], K, H // K, hd), k, v


def decode_partial(q, ck, cv, *, s0: int, pos: int, window=None):
    """One lane's part of a decode step's attention: grouped ``q`` against
    cache positions ``[s0, s0 + S')`` (``ck``, ``cv``: (B, S', K, hd)),
    the keys at or before ``pos`` (and within ``window``).  Returns the
    float32 online-softmax state ``(max, sum of exp, acc)``; a lane with
    no valid key gives ``(-inf, 0, 0)``, which `combine_partials` weighs
    by zero."""
    B, Sq, K, rep, hd = q.shape
    k_idx = s0 + torch.arange(ck.shape[1], device=q.device)
    valid = k_idx <= pos
    if window is not None:
        valid &= k_idx > pos - window
    s = torch.einsum("bqkrd,bskd->bkrqs", q.to(F32),
                     ck.to(q.dtype).to(F32)) * hd ** -0.5
    s = torch.where(valid, s, -torch.inf)
    m = torch.full((B, K, rep, Sq), -torch.inf, dtype=F32, device=q.device)
    return _online_softmax_step(
        m, torch.zeros_like(m), torch.zeros(m.shape + (hd,), dtype=F32,
                                            device=q.device),
        s, cv.to(q.dtype), "bkrqs,bskd->bkrqd")


def combine_partials(parts, dtype):
    """Lanes' `decode_partial` states added in lane order by the
    log-sum-exp rule: the attention output (B, Sq, K, rep, hd) in
    ``dtype``."""
    top = parts[0][0]
    for m, _, _ in parts[1:]:
        top = torch.maximum(top, m)
    safe = torch.where(torch.isfinite(top), top, 0.0)
    l = acc = 0.0
    for m, lm, am in parts:
        w = torch.where(torch.isfinite(m), torch.exp(m - safe), 0.0)
        l = l + lm * w
        acc = acc + am * w[..., None]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(dtype)


def init_attn_cache(cfg, batch: int, max_len: int, dtype, device=None):
    K, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device),
        "pos": 0,
    }


# ------------------------------------------------------------------- mlp ---
def init_mlp(gen, cfg, d_ff: int | None = None, device=None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return Params(
        ln=init_rms_norm(d, dt, device),
        wi_gate=normal(gen, (d, f), d ** -0.5, dt, device),
        wi_up=normal(gen, (d, f), d ** -0.5, dt, device),
        wo=normal(gen, (f, d), f ** -0.5, dt, device),
    )


def mlp(params, x, *, cfg):
    xn = rms_norm(params["ln"], x, eps=cfg.norm_eps)
    h = F.silu(xn @ params["wi_gate"]) * (xn @ params["wi_up"])
    return h @ params["wo"]


# ------------------------------------------------------------- embedding ---
def init_embed(gen, cfg, device=None) -> torch.Tensor:
    # std d^-0.5: embed() rescales by sqrt(d) so activations are O(1), and
    # tied-unembedding logits stay O(1) too.
    return normal(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5,
                  cfg.param_dtype, device)


def embed(table, tokens, cfg):
    x = table[tokens].to(cfg.compute_dtype)
    # sqrt(d) in the activations' dtype first, as jax's weak-typed scalar
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


def unembed(table_or_head, x, cfg, *, tied: bool):
    if tied:
        return x @ table_or_head.T.to(cfg.compute_dtype)
    return x @ table_or_head.to(cfg.compute_dtype)
