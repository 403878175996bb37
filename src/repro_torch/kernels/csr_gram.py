"""CSR gather-Gram on Hopper (kernel K3): the CUDA kernel's wrapper and its
launch plan.

Port of ``repro.kernels.csr_gram`` (TPU kernels `_batched_kernel` and
`_kernel`).  ONE launch computes ``G = sum_c B_c^T B_c`` over a megabatch
of C padded CSR chunks (C = 1 is the single-chunk op); see
``csrc/csr_gram.cu`` for the design (one CTA per 32 x 32 output tile of
the upper triangle, the chunk densified per tile into two shared-memory
panels) and what bounds it.  Its plain versions are
`kernels.ref.csr_gram_batched_ref` / `csr_gram_ref`.

The TPU's VMEM budget (``batched_gram_fits``) and its per-chunk fallback
do not carry over: the output is tiled, so any ``n_hat`` takes one launch
per megabatch; the only limit is the two (R, 32) float32 panels in a
block's 227 KB of shared memory, R <= 908 rows (`plan_csr_gram`).

Only this module touches the library; every launch adds one to
`launches`, and nothing else does.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build

SMEM_LIMIT_BYTES = 232_448        # dynamic shared memory one H100 block may use
TILE = 32                         # output tile edge (kT in the source)

launches = 0                      # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


@dataclass(frozen=True)
class GramPlan:
    """How one launch computes a megabatch's Gram on the card."""

    n_tiles: int        # output tiles per edge, ceil(n_hat / TILE)
    blocks: int         # CTAs: the upper triangle's tiles
    smem_bytes: int     # dynamic shared memory of one CTA


def plan_csr_gram(n_hat: int, n_rows: int) -> GramPlan:
    """The launch plan for support size ``n_hat`` and chunks of
    ``n_rows`` rows; raises when the two (n_rows, TILE) panels do not fit
    a block's shared memory."""
    if n_hat < 1 or n_rows < 1:
        raise ValueError(f"csr_gram: n_hat and n_rows must be >= 1, got "
                         f"{n_hat} and {n_rows}")
    smem = 2 * n_rows * TILE * 4
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"csr_gram: chunks of {n_rows} rows need {smem} B of shared "
            f"memory per block, over the {SMEM_LIMIT_BYTES} B a block may "
            f"use (n_rows <= {SMEM_LIMIT_BYTES // (8 * TILE)})")
    n_tiles = -(-n_hat // TILE)
    return GramPlan(n_tiles, n_tiles * (n_tiles + 1) // 2, smem)


def _library():
    lib = _build.load("csr_gram")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.csr_gram_launch.argtypes = [p, p, p, i, i, i, i, p, p]
        lib.csr_gram_launch.restype = i
        lib.csr_gram_error_string.argtypes = [i]
        lib.csr_gram_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def csr_gram_cuda(values: torch.Tensor, local_cols: torch.Tensor,
                  seg_ids: torch.Tensor, n_rows: int, n_hat: int):
    """``G = sum_c B_c^T B_c``, (n_hat, n_hat) float32, in ONE launch.

    ``values`` (float32), ``local_cols`` and ``seg_ids`` (int32) are CUDA
    tensors of one shape, (E,) for one chunk or (C, E) for a megabatch;
    ``seg_ids`` are chunk-local rows in [0, n_rows), and a local column
    ``>= n_hat`` (the off-support sentinel) or a row outside [0, n_rows)
    is dropped."""
    ts = {"values": values, "local_cols": local_cols, "seg_ids": seg_ids}
    for name, t in ts.items():
        if not t.is_cuda:
            raise ValueError(f"csr_gram: {name} must be a CUDA tensor")
        if t.device != values.device:
            raise ValueError(f"csr_gram: {name} on {t.device}, values on "
                             f"{values.device}")
        if t.shape != values.shape or t.dim() not in (1, 2):
            raise ValueError("csr_gram: values, local_cols and seg_ids must "
                             "share one (E,) or (C, E) shape, got "
                             f"{[tuple(x.shape) for x in ts.values()]}")
    if values.dtype != torch.float32 or local_cols.dtype != torch.int32 \
            or seg_ids.dtype != torch.int32:
        raise TypeError("csr_gram: needs float32 values and int32 "
                        f"local_cols/seg_ids, got {values.dtype}, "
                        f"{local_cols.dtype}, {seg_ids.dtype}")
    plan = plan_csr_gram(n_hat, n_rows)
    C, E = (1, values.shape[0]) if values.dim() == 1 else values.shape
    values, local_cols, seg_ids = (t.contiguous() for t in ts.values())
    G = torch.empty((n_hat, n_hat), dtype=torch.float32, device=values.device)
    lib = _library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.csr_gram_launch(values.data_ptr(), local_cols.data_ptr(),
                                 seg_ids.data_ptr(), C, E, n_rows, n_hat,
                                 G.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"csr_gram launch failed: "
                           f"{lib.csr_gram_error_string(rc).decode()} "
                           f"(C={C}, E={E}, n_rows={n_rows}, n_hat={n_hat}, "
                           f"blocks={plan.blocks})")
    global launches
    launches += 1
    return G
