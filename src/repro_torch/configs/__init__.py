"""Config registry of the port: 10 assigned architectures + the paper's own
experiments (a copy of ``repro.configs``).

`get_config(name)` / `get_smoke_config(name)` select by the assignment id;
`SHAPES` defines the 4 input-shape cells; `cells()` enumerates the runnable
(arch x shape) grid applying the long_500k sub-quadratic skip rule
(DESIGN.md §Arch-applicability).  The configs of 8 B parameters and more
do not fit one 80 GB card in float32 with a compute copy; there they run
at their ``SMOKE`` size only.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import (
    deepseek_67b, deepseek_moe_16b, gemma3_27b, jamba_v01_52b, llava_next_34b,
    mamba2_130m, minitron_8b, phi35_moe_42b, qwen2_0_5b, whisper_medium,
)
from .base import BlockSpec, ModelConfig
from .spca_experiments import NYTIMES, PUBMED, SPCAExperiment

_MODULES = {
    "deepseek-moe-16b": deepseek_moe_16b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "whisper-medium": whisper_medium,
    "llava-next-34b": llava_next_34b,
    "mamba2-130m": mamba2_130m,
    "minitron-8b": minitron_8b,
    "qwen2-0.5b": qwen2_0_5b,
    "deepseek-67b": deepseek_67b,
    "gemma3-27b": gemma3_27b,
    "jamba-v0.1-52b": jamba_v01_52b,
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG.validate()


def get_smoke_config(name: str) -> ModelConfig:
    return _MODULES[name].SMOKE.validate()


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "train"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
# prefill_32k lowers the forward pass only (inference prefill), but shares
# the train-batch input signature; launch/dryrun.py special-cases it.


def cells(include_skipped: bool = False):
    """All (arch, shape) pairs; long_500k only for sub-quadratic archs."""
    out = []
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and not cfg.sub_quadratic
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name) if not include_skipped
                       else (arch, shape.name, skipped))
    return out


__all__ = [
    "ARCH_NAMES", "SHAPES", "BlockSpec", "ShapeSpec", "ModelConfig", "SPCAExperiment",
    "NYTIMES", "PUBMED", "cells", "get_config", "get_smoke_config",
]
