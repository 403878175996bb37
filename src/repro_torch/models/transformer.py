"""Model composition: periods of blocks (the port of
``repro.models.transformer``).

Every architecture in the zoo is a `LM` (decoder-only; dense/MoE/SSM/hybrid/
VLM) or an `EncDec` (whisper).  A stack is a `nn.ModuleList` of periods,
each period a `Params` of blocks ``b0, b1, ...``; the reference scans the
same periods with parameters stacked along a leading ``n_periods`` axis,
and `repro_torch.convert.lm_params_from_reference` splits that axis into
these modules.

Decode carries a cache with the reference's per-block structure: a list
over periods of ``{"b{i}": {"mixer": ..., "cross": ...}}``.  Attention
caches are written in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import mamba2, moe as moe_lib
from .layers import (
    F32, Params, _split_heads, attention, init_attention, init_attn_cache,
    init_mlp, mlp,
)


def ZERO_AUX(device=None):
    return {"moe_lb_loss": torch.zeros((), dtype=F32, device=device),
            "moe_z_loss": torch.zeros((), dtype=F32, device=device)}


# ------------------------------------------------------------------ blocks ---
def init_block(gen, spec, cfg, *, has_cross: bool = False,
               device=None) -> Params:
    mixer, ffn = spec
    p: dict[str, Any] = {}
    if mixer == "mamba":
        p["mixer_ssm"] = mamba2.init_mamba(gen, cfg, device)
    else:
        p["mixer_attn"] = init_attention(gen, cfg, device)
    if has_cross:
        p["cross"] = init_attention(gen, cfg, device)
    if ffn == "mlp":
        p["ffn_mlp"] = init_mlp(gen, cfg, device=device)
    elif ffn == "moe":
        p["ffn_moe"] = moe_lib.init_moe(gen, cfg, device)
    return Params(**p)


def apply_block(
    params, x, spec, cfg, *, positions, enc_out=None, cache=None, decode=False
):
    """Returns (x, aux, new_cache).  ``aux`` is None for a block without
    MoE (the reference returns zeros); ``new_cache`` is {} when not
    decoding."""
    mixer, ffn = spec
    aux = None
    new_cache: dict[str, Any] = {}

    if mixer == "mamba":
        if decode:
            out, nc = mamba2.mamba_decode(params["mixer_ssm"], x,
                                          cache["mixer"], cfg=cfg)
            new_cache["mixer"] = nc
        else:
            out = mamba2.mamba_mixer(params["mixer_ssm"], x, cfg=cfg)
    else:
        window = cfg.window if mixer == "attn_local" else None
        causal = mixer != "attn_enc"
        out, nc = attention(
            params["mixer_attn"], x, cfg=cfg, positions=positions,
            causal=causal, window=window,
            cache=cache.get("mixer") if decode else None,
        )
        if decode:
            new_cache["mixer"] = nc
    x = x + out

    if "cross" in params:
        if decode:
            # Static cross cache: k/v precomputed from enc_out at cache init.
            cout, _ = attention(
                params["cross"], x, cfg=cfg, positions=positions,
                kv=None, causal=False, cache=None,
                static_kv=cache["cross"],
            )
            new_cache["cross"] = cache["cross"]
        else:
            S_kv = enc_out.shape[1]
            cout, _ = attention(
                params["cross"], x, cfg=cfg, positions=positions,
                kv=enc_out,
                kv_positions=torch.arange(S_kv, device=x.device)[None, :],
                causal=False,
            )
        x = x + cout

    if ffn == "mlp":
        x = x + mlp(params["ffn_mlp"], x, cfg=cfg)
    elif ffn == "moe":
        out, aux = moe_lib.moe(params["ffn_moe"], x, cfg=cfg)
        x = x + out
    return x, aux, new_cache


# ------------------------------------------------------------------ stacks ---
class StackSpec(NamedTuple):
    period: tuple          # block specs within one period
    n_periods: int
    has_cross: bool = False


def init_stack(gen, stack: StackSpec, cfg, device=None) -> nn.ModuleList:
    """``n_periods`` periods, each a `Params` of blocks ``b0, b1, ...``."""
    return nn.ModuleList(
        Params(**{
            f"b{i}": init_block(gen, spec, cfg, has_cross=stack.has_cross,
                                device=device)
            for i, spec in enumerate(stack.period)
        })
        for _ in range(stack.n_periods)
    )


def _acc_aux(a, b):
    return {k: a[k] + b[k] for k in a}


def run_stack(
    params, x, stack: StackSpec, cfg, *, positions, enc_out=None,
    caches=None, decode=False, block_fn=apply_block, scope=None,
):
    """Run the periods in order. ``params`` (and ``caches`` when decoding)
    are lists over periods.  Returns (x, aux, new_caches).

    Activation checkpointing as the reference's ``cfg.remat == "full"``
    (``jax.checkpoint`` of each period): while autograd is on and not
    decoding, each period runs under ``torch.utils.checkpoint``
    (non-reentrant), which keeps only its input and recomputes the rest
    in the backward pass.  It changes no value.

    The partitioned train step (`distributed.partition`) passes a
    callable a period in ``params`` (it gathers the period's weights, so
    under remat they are gathered again in the recompute rather than
    kept), its own ``block_fn`` and a ``scope`` (a context manager
    factory) that every period's run, recompute included, is held in;
    under ``cfg.seq_parallel`` its ``x`` may be a hidden state held in row
    blocks (`distributed.partition.RowBlocks`: ``parts``, ``like(parts)``,
    ``device``), whose blocks are each checkpointed period's inputs."""
    remat = cfg.remat == "full" and not decode and torch.is_grad_enabled()

    def period(p, x, aux, cache):
        if scope is None:
            return period_body(p, x, aux, cache)
        with scope():
            return period_body(p, x, aux, cache)

    def period_body(p, x, aux, cache):
        if callable(p):
            p = p()
        ncs = {}
        for i, spec in enumerate(stack.period):
            x, a, nc = block_fn(
                p[f"b{i}"], x, spec, cfg, positions=positions, enc_out=enc_out,
                cache=cache[f"b{i}"] if decode else None, decode=decode,
            )
            if a is not None:
                aux = _acc_aux(aux, a)
            ncs[f"b{i}"] = nc
        return x, aux, ncs

    aux = ZERO_AUX(x.device)
    new_caches = [] if decode else None
    for n in range(stack.n_periods):
        cache = caches[n] if decode else None
        if remat and not isinstance(x, torch.Tensor):
            # a hidden state held in parts (`distributed.partition.RowBlocks`):
            # its tensors are the checkpoint's inputs, each kept where it is
            x, aux, ncs = checkpoint(
                lambda p, aux, cache, *parts, x=x: period(
                    p, x.like(parts), aux, cache),
                params[n], aux, cache, *x.parts, use_reentrant=False,
                preserve_rng_state=False)
        elif remat:
            x, aux, ncs = checkpoint(period, params[n], x, aux, cache,
                                     use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            x, aux, ncs = period(params[n], x, aux, cache)
        if decode:
            new_caches.append(ncs)
    return x, aux, new_caches


def init_stack_cache(stack: StackSpec, cfg, batch: int, max_len: int, dtype,
                     enc_out=None, params=None, device=None):
    """Decode cache for a stack: a list over periods of per-block caches
    (each period its own tensors, since attention caches are written in
    place).  With cross attention, ``params`` (the stack's compute tree)
    and ``enc_out`` give the static encoder K/V."""
    if enc_out is not None:
        device = enc_out.device

    def block_cache(spec, block_params):
        mixer, _ = spec
        c: dict[str, Any] = {}
        if mixer == "mamba":
            c["mixer"] = mamba2.init_mamba_cache(cfg, batch, dtype, device)
        else:
            c["mixer"] = init_attn_cache(cfg, batch, max_len, dtype, device)
        if stack.has_cross:
            # Precompute the encoder K/V once (static across decode steps).
            k = enc_out @ block_params["cross"]["wk"]
            v = enc_out @ block_params["cross"]["wv"]
            c["cross"] = {
                "k": _split_heads(k, cfg.n_kv_heads, cfg.hd).to(dtype),
                "v": _split_heads(v, cfg.n_kv_heads, cfg.hd).to(dtype),
            }
        return c

    return [
        {f"b{i}": block_cache(spec, params[n][f"b{i}"] if params else None)
         for i, spec in enumerate(stack.period)}
        for n in range(stack.n_periods)
    ]
