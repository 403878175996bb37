"""Analytic model math for the roofline: parameter counts and MODEL_FLOPS
(port of ``repro.launch.analysis``).

MODEL_FLOPS is the *useful* work (the standard 6·N·D accounting, plus the
quadratic attention term, PaLM-appendix style).  For MoE models N uses
ACTIVE parameters only.

The reference counts from ``jax.eval_shape``, which allocates nothing;
here the model is built on PyTorch's ``meta`` device
(``build_model(cfg, device="meta")``), which draws no weight and holds no
storage, so counting deepseek-67b takes no memory.
"""
from __future__ import annotations

import math

from ..models import build_model


def count_params(cfg) -> dict:
    """Exact counts from the real init shapes (the ``meta`` device: no
    allocation)."""
    model = build_model(cfg, device="meta")
    total = routed = embed = 0
    for name, leaf in model.named_parameters():
        key = name.replace(".", "/")
        n = math.prod(leaf.shape)
        total += n
        if "experts/" in key:
            routed += n
        if key.endswith("embed") or key.endswith("lm_head"):
            embed += n
    active = total - routed
    if cfg.n_experts:
        active += routed * cfg.top_k / cfg.n_experts
    return {
        "total": int(total),
        "active": int(active),
        "routed": int(routed),
        "embed": int(embed),
        "body_active": int(active - embed),
    }


def _attn_layers(cfg):
    """(full_attn_layers, local_attn_layers, mamba_layers) of the decoder."""
    full = local = mamba = 0
    for mixer, _ in cfg.layer_list():
        if mixer == "attn":
            full += 1
        elif mixer == "attn_local":
            local += 1
        elif mixer == "mamba":
            mamba += 1
    return full, local, mamba


def train_model_flops(cfg, batch: int, seq: int) -> float:
    """6·N_active·tokens + attention quadratic term (+ encoder for enc-dec)."""
    p = count_params(cfg)
    tokens = batch * seq
    flops = 6.0 * p["active"] * tokens
    full, local, mamba = _attn_layers(cfg)
    H, hd = cfg.n_heads, cfg.hd
    # 12·H·hd·S_eff per token per attention layer (fwd+bwd, causal halved)
    flops += 6.0 * full * H * hd * seq * tokens
    if local:
        w = min(cfg.window or seq, seq)
        flops += 6.0 * local * H * hd * w * tokens
    if mamba and cfg.ssm_state:
        d_in = cfg.ssm_expand * cfg.d_model
        # SSD state update ~ 6·d_in·N per token per layer (fwd+bwd)
        flops += 18.0 * mamba * d_in * cfg.ssm_state * tokens
    if cfg.is_encoder_decoder:
        Se = cfg.encoder_seq
        flops += 6.0 * cfg.n_encoder_layers * H * hd * Se * batch * Se
    return flops


def prefill_model_flops(cfg, batch: int, seq: int) -> float:
    """Forward only: one third of the train accounting."""
    return train_model_flops(cfg, batch, seq) / 3.0


def decode_model_flops(cfg, batch: int, seq_cache: int) -> float:
    """One token per sequence against a seq_cache-long context."""
    p = count_params(cfg)
    flops = 2.0 * p["active"] * batch
    full, local, mamba = _attn_layers(cfg)
    H, hd = cfg.n_heads, cfg.hd
    flops += 4.0 * full * H * hd * seq_cache * batch
    if local:
        w = min(cfg.window or seq_cache, seq_cache)
        flops += 4.0 * local * H * hd * w * batch
    if mamba and cfg.ssm_state:
        d_in = cfg.ssm_expand * cfg.d_model
        flops += 6.0 * mamba * d_in * cfg.ssm_state * batch
    if cfg.is_encoder_decoder:
        flops += 4.0 * cfg.n_layers * H * hd * cfg.encoder_seq * batch  # cross
    return flops


def model_flops_for(cfg, shape) -> float:
    if shape.kind == "decode":
        return decode_model_flops(cfg, shape.global_batch, shape.seq_len)
    if shape.name.startswith("prefill"):
        return prefill_model_flops(cfg, shape.global_batch, shape.seq_len)
    return train_model_flops(cfg, shape.global_batch, shape.seq_len)
