"""Gradient compression for the slow reduction axis (port of
``repro.optim.compression``).

Symmetric int8 block quantisation with one float32 scale a block
(`quantize`, `dequantize`), the bytes a tensor puts on the wire (the int8
payload plus the scales, `wire_bytes`), and the exchange,
`compressed_pmean`: error-feedback mean over the lanes of a mesh axis,
each lane's int8 payload and scales gathered in lane order and
dequantised as they are summed.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 payload and the scales equal the
reference's exactly.

The reference runs `compressed_pmean` inside ``shard_map`` over a named
axis; here it takes one tensor and one residual a lane of that axis, as
`core.distributed.psum_partials` takes partials.  No train step calls it,
in the port as in the reference.
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


def compressed_pmean(xs, residuals, mesh=None, *, block: int = 256):
    """Error-feedback compressed mean of ``xs`` over the lanes of an axis.

    ``xs`` and ``residuals`` hold one tensor a lane of the axis (n of
    them, in lane order): a sequence of tensors (each on its lane's
    device) or a stacked ``(n, ...)`` tensor.  ``mesh``, when given, is
    the axis's lanes (a `launch.mesh.DataMesh`); their queued work is
    waited for before the exchange.  Each lane quantises ``x +
    residual`` (float32); the int8 payloads and float32 scales are
    gathered in lane order and summed as ``q.float() * scale``, then
    divided by n and cast to ``x``'s dtype.  Returns ``(means,
    new_residuals)``: the mean a lane (each on its lane's device, equal on
    every lane) and each lane's new residual, ``v - dequantize(q)``."""
    from ..launch.mesh import sync_lanes

    xs, residuals = list(xs), list(residuals)
    if len(xs) != len(residuals):
        raise ValueError(f"compressed_pmean: {len(xs)} tensors for "
                         f"{len(residuals)} residuals")
    n = len(xs)
    if mesh is not None:
        sync_lanes(mesh)
    payloads, new_res = [], []
    for x, r in zip(xs, residuals):
        v = x.to(torch.float32) + r
        q, scale, shape = quantize(v, block=block)
        new_res.append(v - dequantize(q, scale, shape))
        payloads.append((q, scale))
    root = xs[0].device
    summed = None
    for q, scale in payloads:              # the gather, in lane order
        part = q.to(root).to(torch.float32) * scale.to(root)
        summed = part if summed is None else summed + part
    flat = summed.reshape(-1)
    shape = tuple(xs[0].shape)
    mean = (flat[:math.prod(shape)].reshape(shape) / n).to(xs[0].dtype)
    means = [mean if x.device == root else mean.to(x.device) for x in xs]
    if mesh is not None:
        sync_lanes(mesh)
    return means, new_res
