"""Model zoo (the port of ``repro.models``): composable blocks
(attention/MoE/Mamba2) + LM/EncDec wrappers."""
from . import layers, mamba2, moe, transformer
from .model import EncDec, LM, build_model, cast_params, param_count, softmax_xent

__all__ = [
    "layers", "mamba2", "moe", "transformer", "EncDec", "LM", "build_model",
    "cast_params", "param_count", "softmax_xent",
]
