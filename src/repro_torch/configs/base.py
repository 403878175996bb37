"""Model configuration schema (the port's copy of ``repro.configs.base``;
``param_dtype`` and ``compute_dtype`` are torch dtypes of the same names).

A model is a stack of *periods*: a period is a short tuple of block specs
``(mixer, ffn)`` that repeats ``n_periods`` times (scanned with stacked
params in the reference; one module a period here), plus an optional
``remainder`` tuple of blocks appended unrolled.  This expresses every
assigned layout:

  dense        period=(("attn","mlp"),)            n_periods=L
  moe          period=(("attn","moe"),)            n_periods=L
  gemma3 5:1   period=(5x local + 1x global)       n_periods=10, remainder=2x local
  jamba 1:7    period=(7x mamba + 1x attn, alternating mlp/moe)  n_periods=4
  mamba2       period=(("mamba",None),)            n_periods=L
  whisper      encoder periods (bidirectional) + decoder periods (causal+cross)

Mixer kinds: "attn" (causal full), "attn_local" (causal sliding window),
"attn_enc" (bidirectional), "mamba".  FFN kinds: "mlp", "moe", None.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

BlockSpec = tuple  # (mixer: str, ffn: str | None)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # Layout (decoder / decoder-only stack).
    period: tuple = (("attn", "mlp"),)
    n_periods: int = 0             # 0 -> n_layers // len(period)
    remainder: tuple = ()

    # Attention.
    window: int | None = None      # sliding window for "attn_local"
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    attn_kv_block: int = 1024      # flash-attention KV block size
    # Sequence-parallel activations (beyond-paper §Perf mode): activations
    # stay token-sharded over 'model' between blocks; weights all-gather
    # instead of activations (wins when B_loc*S*d >> params/layer).
    seq_parallel: bool = False

    # MoE.
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048

    # SSM (mamba2).
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # Encoder-decoder (whisper).
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500        # whisper: 30s of audio at 50 Hz
    encoder_period: tuple = (("attn_enc", "mlp"),)

    # VLM (llava): patch embeddings prepended to the text sequence (stub
    # frontend per the assignment: input_specs provides them precomputed).
    num_patches: int = 0

    # Long-context eligibility (DESIGN.md §Arch-applicability).
    sub_quadratic: bool = False

    # Numerics / training.
    unroll_stacks: bool = False    # dry-run cost probes only (see launch/dryrun)
    dtypes: tuple = ("float32", "bfloat16")   # (param, compute)
    tie_embeddings: bool = False
    remat: str = "full"            # "full" | "none"
    moe_aux_weight: float = 0.01
    moe_zloss_weight: float = 1e-3

    # ------------------------------------------------------------------
    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtypes[0])

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtypes[1])

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def periods(self) -> int:
        return self.n_periods or (self.n_layers // max(len(self.period), 1))

    def layer_list(self) -> list:
        """The fully unrolled decoder layout (for param counting / checks)."""
        return list(self.period) * self.periods + list(self.remainder)

    def validate(self) -> "ModelConfig":
        n = len(self.period) * self.periods + len(self.remainder)
        assert n == self.n_layers, (
            f"{self.name}: layout covers {n} layers, config says {self.n_layers}"
        )
        if any(f == "moe" for _, f in self.layer_list()):
            assert self.n_experts > 0 and self.top_k > 0 and self.moe_d_ff > 0
        if any(m == "mamba" for m, _ in self.layer_list()):
            assert self.ssm_state > 0 and self.ssm_heads > 0
        return self

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced same-family config (smoke tests)."""
        from dataclasses import replace

        return replace(self, **overrides)
