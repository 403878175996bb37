"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]: 16 experts top-2."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32_064,
    period=(("attn", "moe"),),
    n_experts=16,
    top_k=2,
    moe_d_ff=6400,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
    vocab_size=512, n_experts=4, top_k=2, moe_d_ff=64, moe_group_size=64,
    n_periods=2,
)
