"""Serve step factories (the serving half of ``repro.train.train_step``).

`make_serve_step(model)` builds the one-token greedy decode step;
`make_prefill_step(model)` the forward-only prefill step.  The model owns
its parameters, so the steps take none.

The training half (``TrainState``, ``init_state``, ``make_train_step``)
needs the optimizer (``optim/``) and is ROADMAP queue 1 item 14b.
"""
from __future__ import annotations

import torch


def make_serve_step(model):
    @torch.no_grad()
    def serve_step(cache, last_tokens):
        """Greedy one-token decode. last_tokens: (B, 1) integers.  Returns
        (cache, next tokens (B, 1)); ties go to the first maximum."""
        logits, cache = model.decode_step(cache, last_tokens)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        return cache, nxt

    return serve_step


def make_prefill_step(model):
    """Forward pass only (inference prefill): the greedy next token after
    each sequence."""
    @torch.no_grad()
    def prefill_step(batch):
        logits, _ = model.forward(batch)
        return torch.argmax(logits[:, -1, :], dim=-1)

    return prefill_step
