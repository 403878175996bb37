"""whisper-medium [arXiv:2212.04356]: 24+24 enc-dec; conv frontend is a STUB
per the assignment — input_specs provides precomputed frame embeddings
(B, 1500, d_model)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,                 # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    is_encoder_decoder=True,
    n_encoder_layers=24,
    encoder_seq=1500,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512, n_encoder_layers=2, encoder_seq=16, n_periods=2,
)
