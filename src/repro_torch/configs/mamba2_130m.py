"""mamba2-130m [arXiv:2405.21060]: attention-free SSD. d_inner = 2*768,
24 heads of dim 64, state 128.  Sub-quadratic: runs the long_500k cell."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,                  # unused (attention-free)
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50_280,
    period=(("mamba", None),),
    ssm_state=128,
    ssm_heads=24,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, vocab_size=512, ssm_state=16, ssm_heads=4,
    ssm_chunk=8, n_periods=2,
)
