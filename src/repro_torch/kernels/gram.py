"""Dense Gram on Hopper (kernel K6): the CUDA kernel's wrapper and its
launch plan.

Port of ``repro.kernels.gram`` (TPU kernel `_kernel`, launched by
``gram_pallas``).  ONE launch computes ``C = A^T A``, (n, n) float32, of
a dense (m, n) float32 block, contracting over rows; see
``csrc/gram.cu`` for the design (one CTA per 64 x 64 output tile of the
upper triangle and row slab, row panels staged by ``cp.async``, the
contraction on the tensor cores in 3xTF32 through ``csrc/gram_tc.cuh``,
a split tile's slabs one thread-block cluster whose partials are added
in slab order through distributed shared memory) and what bounds it: the
CUDA-core operations of the upper triangle (67 TFLOP/s), the bytes, and
the tensor-core bound of its own three TF32 products a term (495
TFLOP/s).  Ragged m and n are masked in the kernel, so there is no
padding.  Its plain version is `kernels.ref.gram_ref`.

Only this module touches the library; every launch adds one to
`launches`, and nothing else does.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build

TILE = 64                 # output tile edge (kT in gram.cu)
PANEL_ROWS = 32           # rows of a staged panel (kBK in gram.cu)
STAGES = 3                # panels in flight (kStages)
SMS = 132                 # the H100's streaming multiprocessors
MAX_CLUSTER = 8           # CTAs a thread-block cluster may hold on any Hopper part

launches = 0                      # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


@dataclass(frozen=True)
class GramPlan:
    """How one launch computes a block's Gram on the card."""

    tile: int           # output tile edge
    n_tiles: int        # output tiles per edge, ceil(n / tile)
    tiles: int          # the upper triangle's tiles
    split: int          # row slabs per tile: the CTAs of one cluster
    slab_rows: int      # rows of a slab, a multiple of PANEL_ROWS
    blocks: int         # CTAs: tiles x split
    smem_bytes: int     # dynamic shared memory of one CTA


@functools.lru_cache(maxsize=256)
def plan_gram(m: int, n: int) -> GramPlan:
    """The launch plan for an (m, n) block: the rows are split into slabs
    only when the triangle's tiles alone leave SMs idle, then into as many
    as a cluster holds (MAX_CLUSTER), at least a panel of rows each."""
    if m < 0 or n < 1:
        raise ValueError(f"gram: need m >= 0 and n >= 1, got {(m, n)}")
    n_tiles = -(-n // TILE)
    tiles = n_tiles * (n_tiles + 1) // 2
    panels = max(1, -(-m // PANEL_ROWS))
    split = 1 if tiles >= SMS else min(panels, MAX_CLUSTER)
    per = -(-panels // split)
    split = -(-panels // per)
    return GramPlan(TILE, n_tiles, tiles, split, per * PANEL_ROWS,
                    tiles * split, STAGES * 2 * PANEL_ROWS * TILE * 4)


def _library():
    lib = _build.load("gram")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gram_launch.argtypes = [p, i, i, i, i, p, p]
        lib.gram_launch.restype = i
        lib.gram_error_string.argtypes = [i]
        lib.gram_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def gram_cuda(A: torch.Tensor) -> torch.Tensor:
    """``A^T A``, (n, n) float32, of a (m, n) float32 CUDA tensor, in ONE
    launch (an (m, 0) block launches nothing)."""
    if not A.is_cuda:
        raise ValueError(f"gram: A must be a CUDA tensor, got {A.device}")
    if A.dim() != 2:
        raise ValueError(f"gram: A must be (m, n), got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"gram: A must be float32, got {A.dtype}")
    m, n = A.shape
    if m >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"gram: (m, n) = {(m, n)} exceeds the kernel's "
                         "int32 extents")
    C = torch.empty((n, n), dtype=torch.float32, device=A.device)
    if n == 0:
        return C
    plan = plan_gram(m, n)
    A = A.contiguous()
    lib = _library()
    context, stream = _build.launch_on(A.device)
    with context:
        rc = lib.gram_launch(A.data_ptr(), m, n, plan.split, plan.slab_rows,
                             C.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gram launch failed: "
                           f"{lib.gram_error_string(rc).decode()} "
                           f"(m={m}, n={n}, plan={plan})")
    global launches
    launches += 1
    return C
