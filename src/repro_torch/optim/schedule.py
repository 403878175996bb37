"""LR schedule: linear warmup + cosine decay, a pure function of the step
(so restarts resume the schedule exactly).  Port of
``repro.optim.schedule``: computed in float32 on the host, as the
reference computes it; 0 at step 0."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> torch.Tensor:
    """The schedule's value at ``step`` (an int or a tensor of steps) as a
    float32 tensor on the CPU."""
    step = torch.as_tensor(step).detach().to("cpu", torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return warm * cos
