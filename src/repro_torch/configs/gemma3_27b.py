"""gemma3-27b [hf:google/gemma-3]: 5:1 local:global attention, window 1024,
262k vocab.  62 = 10 x (5 local + 1 global) + 2 local remainder.
Mostly-local => eligible for long_500k decode (global layers' KV shards
over 'model'; local layers hold only O(window) KV)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    window=1024,
    period=(("attn_local", "mlp"),) * 5 + (("attn", "mlp"),),
    n_periods=10,
    remainder=(("attn_local", "mlp"),) * 2,
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE = CONFIG.scaled(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, window=8,
    period=(("attn_local", "mlp"),) * 2 + (("attn", "mlp"),), n_periods=2,
    remainder=(("attn_local", "mlp"),) * 2,
)
