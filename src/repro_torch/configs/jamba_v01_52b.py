"""jamba-v0.1-52b [arXiv:2403.19887]: hybrid Mamba+attention 7:1 with MoE
16e top-2 on every other layer.  Period of 8: attention at slot 4, MoE on
odd slots.  Sub-quadratic (only 4 of 32 layers hold full KV)."""
from .base import ModelConfig

_PERIOD = (
    ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
    ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65_536,
    period=_PERIOD,
    n_periods=4,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_heads=128,          # d_inner 8192 / head_dim 64
    ssm_expand=2,
    ssm_chunk=256,
    sub_quadratic=True,
)

SMOKE = CONFIG.scaled(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, n_periods=1, n_experts=4, top_k=2, moe_d_ff=64,
    ssm_state=16, ssm_heads=4, ssm_chunk=8, moe_group_size=64,
)
