"""deepseek-moe-16b [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64
routed top-6 experts of d_ff=1408 (active FFN width 8*1408 ~ a dense 11k)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MHA
    head_dim=128,
    d_ff=1408,
    vocab_size=102_400,
    period=(("attn", "moe"),),
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    moe_group_size=512,     # fine-grained experts -> small routing groups
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32,
    vocab_size=512, n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=32,
    moe_group_size=64, n_periods=2,
)
