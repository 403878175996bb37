"""Atomic checkpoints in the reference's on-disk format."""
from . import checkpoint
from .checkpoint import latest_step, prune, restore, save

__all__ = ["checkpoint", "latest_step", "prune", "restore", "save"]
