"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  There is no quiet CPU path: asking
for CUDA on a machine without it raises.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve(device=None) -> torch.device:
    """``device`` (default ``'cuda'``) as a `torch.device`, checked."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "CUDA was requested but torch.cuda.is_available() is false; "
            "pass device='cpu' (launcher: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise DeviceUnavailable(f"unsupported device {dev}")
    return dev


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor.  A tensor stays on its own device unless
    ``device`` names another; anything else (numpy, lists) goes to
    `resolve(device)`, the card by default."""
    if isinstance(x, torch.Tensor) and device is None:
        return x if dtype is None else x.to(dtype)
    dev = resolve(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    x = np.asarray(x)
    if not x.flags.writeable:          # e.g. a view of a jax array
        x = x.copy()
    return torch.as_tensor(x, dtype=dtype, device=dev)


def to_host(x) -> np.ndarray:
    """``x`` as a numpy array; a tensor is copied to the host (for a CUDA
    tensor that copy waits for the work that produces it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
