"""A plain-torch emulation of the tensor-core Gram's arithmetic (kernels K3
and K6, ``kernels/csrc/gram_tc.cuh``), for tests only: it shows on the
CPU what the 3xTF32 split does to a Gram, where no card is at hand.

Each float32 x is split as ``hi = rna_tf32(x)``, ``lo = rna_tf32(x -
hi)``; each 8-row step sums ``lo*hi``, ``hi*lo`` and ``hi*hi`` in that
order from zero, then adds the step's sum to the float32 accumulator.
The emulation takes each term's 8 products and their sum in float64 and
rounds to float32 once per term, to nearest; the card's tensor cores
round their sums toward zero, so the card's tests hold the kernels
themselves.
Row slabs (`kernels.gram.plan_gram`) are accumulated apart and added in
slab order, as the kernel's last CTA of a tile does, and the upper
triangle is mirrored.
"""
from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: finite float32 values rounded to 10 mantissa
    bits, ties away from zero, kept in float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    # the low 13 bits hold the magnitude's dropped bits in either sign:
    # add half their range, then clear them (a carry rounds the exponent up)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)`` of the 3xTF32 split; ``x - hi`` is exact in float32."""
    x = x.to(torch.float32)
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def gram_3xtf32(A: torch.Tensor, slab_rows: int | None = None) -> torch.Tensor:
    """``A^T A``, (n, n) float32, of an (m, n) block as the tensor-core
    contraction computes it, with the rows in slabs of ``slab_rows`` (all
    in one slab by default)."""
    A = A.to(torch.float32)
    m, n = A.shape
    hi, lo = split_tf32(A)
    slab_rows = max(m, 1) if slab_rows is None else slab_rows
    out = torch.zeros((n, n), dtype=torch.float32)
    for r0 in range(0, max(m, 1), slab_rows):
        acc = torch.zeros((n, n), dtype=torch.float32)
        for k0 in range(r0, min(m, r0 + slab_rows), 8):
            h = hi[k0:min(m, k0 + 8)].double()
            l_ = lo[k0:min(m, k0 + 8)].double()
            step = torch.zeros((n, n), dtype=torch.float32)
            for a, b in ((l_, h), (h, l_), (h, h)):
                step = (step.double() + a.T @ b).to(torch.float32)
            acc = acc + step
        out = out + acc
    # the kernel computes the upper triangle and mirrors it
    return torch.triu(out) + torch.triu(out, 1).T
