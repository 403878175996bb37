"""llava-next-34b [hf:llava-hf/llava-v1.6]: VLM backbone; anyres patch
frontend is a STUB — input_specs provides (B, num_patches, d_model)
precomputed patch embeddings prepended to the text sequence."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    num_patches=1152,            # anyres tiling budget (stubbed frontend)
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, num_patches=8, n_periods=2,
)
