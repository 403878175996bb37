"""CSR gather-Gram on Hopper (kernel K3): the CUDA kernel's wrapper and its
launch plan.

Port of ``repro.kernels.csr_gram`` (TPU kernels `_batched_kernel` and
`_kernel`).  ONE launch computes ``G = sum_c B_c^T B_c`` over a megabatch
of C padded CSR chunks (C = 1 is the single-chunk op); see
``csrc/csr_gram.cu`` for the design (one CTA per 128 x 128 output tile
of the upper triangle, group of chunks and interleaved row slab; each
streams its own chunks' entries by ``cp.async``, densifies the tile's
columns into two shared-memory panels and contracts their occupied rows
on the tensor cores in 3xTF32 through ``csrc/gram_tc.cuh``; a tile's
chunk groups are one thread-block cluster, their partials added in
group order through distributed shared memory, then the slabs' in slab
order) and what bounds it: the entries' bytes, the sparse product's
CUDA-core operations, and the tensor-core bound of its own dense 3xTF32
contraction.  Its plain versions are `kernels.ref.csr_gram_batched_ref`
/ `csr_gram_ref`.

The TPU's VMEM budget (``batched_gram_fits``) and its per-chunk fallback
do not carry over: the output is tiled, so any ``n_hat`` takes one launch
per megabatch; the only limit is the two (R / slabs, 128) float32 panels
and the entry staging in a block's 227 KB of shared memory, with at most
8 slabs: R <= 1,216 rows (`plan_csr_gram`).

Only this module touches the library; every launch adds one to
`launches`, and nothing else does.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from .gram import MAX_CLUSTER, SMS

TILE = 128                        # output tile edge (kT in csr_gram.cu)
SMEM_LIMIT_BYTES = 232_448        # shared memory one H100 block may use
STATIC_RESERVE = 1024             # of it, kept for the kernel's static shared memory
STAGING_BYTES = 3 * 2048 * 12     # 3 staged pieces of 2,048 (value, col, seg) slots
MAX_SLABS = 8

launches = 0                      # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


@dataclass(frozen=True)
class CsrGramPlan:
    """How one launch computes a megabatch's Gram on the card."""

    tile: int               # output tile edge
    n_tiles: int            # output tiles per edge, ceil(n_hat / tile)
    tiles: int              # the upper triangle's tiles
    slabs: int              # interleaved row slabs (a power of two)
    panel_rows: int         # rows of a panel: ceil(R / slabs), rounded up to 8
    groups: int             # chunk groups: the CTAs of one cluster
    chunks_per_group: int   # chunks a CTA densifies and contracts in turn
    parts: int              # partials of a tile: groups x slabs
    blocks: int             # CTAs: tiles x parts
    smem_bytes: int         # dynamic shared memory of one CTA


@functools.lru_cache(maxsize=256)
def plan_csr_gram(n_hat: int, n_rows: int, n_chunks: int = 1) -> CsrGramPlan:
    """The launch plan for support size ``n_hat`` and ``n_chunks`` chunks
    of ``n_rows`` rows: the fewest row slabs whose panels fit a block's
    shared memory, a CTA per chunk up to a cluster's MAX_CLUSTER (chunks
    grouped in order beyond that), then twice the slabs while twice the
    CTAs still fit the SMs in one wave.  Raises when even MAX_SLABS slabs
    do not fit."""
    if n_hat < 1 or n_rows < 1 or n_chunks < 1:
        raise ValueError(f"csr_gram: n_hat, n_rows and the chunk count must "
                         f"be >= 1, got {n_hat}, {n_rows} and {n_chunks}")
    def panels(slabs):          # (rows of a panel, dynamic shared memory)
        rows = -(-(-(-n_rows // slabs)) // 8) * 8
        return rows, 2 * rows * TILE * 4 + STAGING_BYTES

    budget = SMEM_LIMIT_BYTES - STATIC_RESERVE
    slabs = 1
    while panels(slabs)[1] > budget:
        if slabs == MAX_SLABS:
            raise ValueError(
                f"csr_gram: chunks of {n_rows} rows need {panels(slabs)[1]} B "
                f"of shared memory per block even in {MAX_SLABS} row slabs, "
                f"over the {budget} B a block may use")
        slabs *= 2
    n_tiles = -(-n_hat // TILE)
    tiles = n_tiles * (n_tiles + 1) // 2
    per = -(-n_chunks // min(n_chunks, MAX_CLUSTER))
    groups = -(-n_chunks // per)
    while slabs < MAX_SLABS and 2 * tiles * groups * slabs <= SMS:
        slabs *= 2                  # more slabs while the card has SMs to spare
    panel_rows, smem = panels(slabs)
    parts = groups * slabs
    return CsrGramPlan(TILE, n_tiles, tiles, slabs, panel_rows, groups, per,
                       parts, tiles * parts, smem)


# (device index, raw stream) -> (work, counters), kept for the process.
# Invariant: every counter is zero whenever no launch on that stream is in
# flight.  The buffers start zeroed, and each launch that runs to its end
# leaves them so (the last CTA to arrive at a strip resets its counter).
# A launch that fails to start runs no CTA; one that faults on the card
# leaves its counters dirty, but a fault is sticky: the CUDA context then
# runs no later launch, so none can read them.  No lock: a buffer that
# two threads replace at once is used only by the launch that made it,
# and the caching allocator reuses a dropped one in that stream's order.
_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(device: torch.device, stream: int, plan: CsrGramPlan):
    """``(work, counters)`` for a launch on ``stream`` (a raw handle on
    ``device``) whose tiles are split into row slabs, ``(None, None)``
    with one slab: room for the slabs' partial tiles (tiles x slabs x
    TILE x TILE float32) and zeroed int32 arrival counters, MAX_CLUSTER a
    tile.  A kernel leaves its counters zero again and needs its partials
    only while it runs, so one pair of buffers per (device, stream),
    grown when a plan needs more, serves every launch on that stream:
    launches on one stream never overlap (see ``_scratch``)."""
    if plan.slabs == 1:
        return None, None
    key = (device.index, stream)
    work, counters = _scratch.get(key, (None, None))
    need_work = plan.tiles * plan.slabs * TILE * TILE
    need_counters = plan.tiles * MAX_CLUSTER
    if work is None or work.numel() < need_work \
            or counters.numel() < need_counters:
        work = torch.empty(max(need_work, 1 << 18), dtype=torch.float32,
                           device=device)
        counters = torch.zeros(max(need_counters, 4096), dtype=torch.int32,
                               device=device)
        _scratch[key] = (work, counters)
    return work, counters


def _library():
    lib = _build.load("csr_gram")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.csr_gram_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                        p, p, p, p]
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
    outside [0, n_hat) (the off-support sentinel), a row outside
    [0, n_rows) or a zero value is dropped; duplicate (row, col) entries
    are summed."""
    shape, device = values.shape, values.device
    if not (values.is_cuda and local_cols.device == device
            and seg_ids.device == device):
        devices = [t.device for t in (values, local_cols, seg_ids)]
        raise ValueError("csr_gram: values, local_cols and seg_ids must be "
                         f"CUDA tensors on one device, got {devices}")
    if local_cols.shape != shape or seg_ids.shape != shape \
            or len(shape) not in (1, 2):
        shapes = [tuple(t.shape) for t in (values, local_cols, seg_ids)]
        raise ValueError("csr_gram: values, local_cols and seg_ids must "
                         f"share one (E,) or (C, E) shape, got {shapes}")
    if values.dtype != torch.float32 or local_cols.dtype != torch.int32 \
            or seg_ids.dtype != torch.int32:
        raise TypeError("csr_gram: needs float32 values and int32 "
                        f"local_cols/seg_ids, got {values.dtype}, "
                        f"{local_cols.dtype}, {seg_ids.dtype}")
    C, E = (1, shape[0]) if len(shape) == 1 else shape
    plan = plan_csr_gram(n_hat, n_rows, C)
    values, local_cols, seg_ids = (values.contiguous(), local_cols.contiguous(),
                                   seg_ids.contiguous())
    G = torch.empty((n_hat, n_hat), dtype=torch.float32, device=values.device)
    lib = _library()
    context, stream = _build.launch_on(values.device)
    with context:
        work, counters = workspace(values.device, stream, plan)
        rc = lib.csr_gram_launch(
            values.data_ptr(), local_cols.data_ptr(), seg_ids.data_ptr(), C,
            E, n_rows, n_hat, plan.slabs.bit_length() - 1, plan.panel_rows,
            plan.groups, plan.chunks_per_group, G.data_ptr(),
            0 if work is None else work.data_ptr(),
            0 if counters is None else counters.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"csr_gram launch failed: "
                           f"{lib.csr_gram_error_string(rc).decode()} "
                           f"(C={C}, E={E}, n_rows={n_rows}, n_hat={n_hat}, "
                           f"plan={plan})")
    global launches
    launches += 1
    return G
