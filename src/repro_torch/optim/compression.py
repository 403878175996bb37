"""Gradient compression for the slow reduction axis: the local half.

Port of ``repro.optim.compression``'s ``quantize``, ``dequantize`` and
``wire_bytes``: symmetric int8 block quantisation with one float32 scale a
block, and the bytes a tensor puts on the wire (the int8 payload plus the
scales).  ``torch.round`` rounds half to even, as ``jnp.round`` does, so
the int8 payload and the scales equal the reference's exactly.

The exchange itself, ``compressed_pmean`` (error-feedback all-gather of
the payload over a reduction axis), needs that axis: it comes with the
port's 2-D meshes (ROADMAP queue 1 item 14c) and is not in this module.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def quantize(x: torch.Tensor, *, block: int = 256):
    """Symmetric int8 per-block quantisation. Returns (q, scales, shape):
    q (blocks, block) int8, scales (blocks, 1) float32."""
    flat = x.to(torch.float32).reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, tuple(x.shape)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def wire_bytes(x, *, block: int = 256) -> int:
    """Bytes this tensor puts on the compression axis per exchange."""
    n = x.numel() if isinstance(x, torch.Tensor) else int(x.size)
    blocks = -(-n // block)
    return n * 1 + blocks * 4          # int8 payload + f32 scales
