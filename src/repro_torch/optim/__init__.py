"""Optimizer substrate of the port (``repro.optim``): AdamW, the LR
schedule, and the local half of the gradient compression."""
from . import adamw, compression, schedule
from .adamw import AdamWConfig, OptState, global_norm
from .schedule import warmup_cosine

__all__ = ["adamw", "compression", "schedule", "AdamWConfig", "OptState",
           "global_norm", "warmup_cosine"]
