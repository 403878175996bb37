"""Serve step factories of the port (``repro.train``'s serving half)."""
from .train_step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
