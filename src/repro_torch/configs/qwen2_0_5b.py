"""qwen2-0.5b [arXiv:2407.10671]: GQA kv=2, QKV bias, tied embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=56, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, n_periods=2,
)
