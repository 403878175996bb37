"""CSR column statistics on Hopper (kernel K2): the CUDA kernel's wrapper.

Port of ``repro.kernels.csr_stats`` (TPU kernel `_kernel`).  ONE launch
reduces a megabatch of C padded CSR chunks to per-column ``(sum, sumsq)``
in float32; see ``csrc/csr_stats.cu`` for the design (a cooperative
launch: each CTA adds its share of the entries into a shared-memory table
of columns, then into a float64 accumulator; after a grid barrier every
CTA rounds its slice of the columns to float32 and zeroes it) and what
bounds it.  Its plain version is `kernels.ref.csr_column_stats_batched_ref`.

Only this module touches the library; every launch adds one to
`launches`, and nothing else does.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .gram import SMS

THREADS = 1024                    # a CTA (kThreads in csr_stats.cu)
MIN_SLOTS, MAX_SLOTS = 256, 4096  # a CTA's table of columns
COLUMNS_PER_THREAD = 4            # of the finish, before another CTA is added

launches = 0                      # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


@dataclass(frozen=True)
class CsrStatsPlan:
    """How one launch reduces a megabatch on the card."""

    blocks: int         # CTAs, at most one an SM (the launch clamps to the card)
    share: int          # entries a CTA adds: ceil(entries / blocks)
    table_slots: int    # a CTA's table: a power of two >= 2 share, clamped
    smem_bytes: int     # its dynamic shared memory: 20 bytes a slot


def plan_csr_stats(entries: int, n: int) -> CsrStatsPlan:
    """The plan for ``entries`` CSR slots over ``n`` columns: a CTA for
    every THREADS entries or COLUMNS_PER_THREAD * THREADS columns,
    whichever needs more, at most one an SM; a table with twice the slots
    of a CTA's share of the entries (half full at most), so a share's
    repeated columns stay in shared memory."""
    if entries < 0 or n < 1:
        raise ValueError(f"csr_stats: needs entries >= 0 and n >= 1, got "
                         f"{entries} and {n}")
    blocks = max(1, min(SMS, max(-(-entries // THREADS),
                                 -(-n // (COLUMNS_PER_THREAD * THREADS)))))
    share = -(-entries // blocks)
    slots = min(MAX_SLOTS, max(MIN_SLOTS, 1 << max(0, 2 * share - 1)
                               .bit_length()))
    return CsrStatsPlan(blocks, share, slots, 20 * slots)


# (device index, raw stream) -> the float64 accumulator, 2 doubles a
# column, kept for the process.  Invariant: it is zero whenever no launch
# on that stream is in flight.  It starts zeroed, and every launch that
# runs to its end leaves it so (each CTA zeroes the columns it rounds, and
# the CTAs cover every column below n; no entry lands at or beyond n).  A
# launch that fails to start runs no CTA and touches nothing; one that
# faults on the card leaves it dirty, but a fault is sticky: the CUDA
# context then runs no later launch, so none can read it.  No lock: a
# buffer that two threads replace at once is used only by the launch that
# made it, and the caching allocator reuses a dropped one in that stream's
# order.
_scratch: dict[tuple[int, int], torch.Tensor] = {}


def workspace(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The zeroed float64 accumulator of ``stream`` (a raw handle on
    ``device``), at least 2 n doubles: made (or grown) once, then reused
    by every launch on that stream, which leaves it zero."""
    key = (device.index, stream)
    acc = _scratch.get(key)
    if acc is None or acc.numel() < 2 * n:
        acc = torch.zeros(max(2 * n, 1 << 18), dtype=torch.float64,
                          device=device)
        _scratch[key] = acc
    return acc


def _library():
    lib = _build.load("csr_stats")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.csr_stats_launch.argtypes = [p, p, ll, i, i, i, p, p, p, p]
        lib.csr_stats_launch.restype = i
        lib.csr_stats_error_string.argtypes = [i]
        lib.csr_stats_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def csr_column_stats_cuda(values: torch.Tensor, col_ids: torch.Tensor,
                          n: int):
    """``(col_sum, col_sumsq)``, (n,) float32 each, of the entries in
    ``values`` (float32) / ``col_ids`` (int32), CUDA tensors of one shape:
    (E,) for one chunk or (C, E) for a megabatch, reduced in ONE launch.
    Columns outside [0, n) are dropped."""
    if not (values.is_cuda and col_ids.is_cuda):
        raise ValueError("csr_stats: values and col_ids must be CUDA tensors")
    if values.device != col_ids.device:
        raise ValueError(f"csr_stats: col_ids on {col_ids.device}, values "
                         f"on {values.device}")
    if values.dtype != torch.float32 or col_ids.dtype != torch.int32:
        raise TypeError(f"csr_stats: needs float32 values and int32 col_ids, "
                        f"got {values.dtype} and {col_ids.dtype}")
    if values.shape != col_ids.shape or values.dim() not in (1, 2):
        raise ValueError(f"csr_stats: values {tuple(values.shape)} and "
                         f"col_ids {tuple(col_ids.shape)} must be one (E,) "
                         "or (C, E) shape")
    if n < 1:
        raise ValueError(f"csr_stats: n must be >= 1, got {n}")
    values, col_ids = values.contiguous(), col_ids.contiguous()
    dev = values.device
    plan = plan_csr_stats(values.numel(), n)
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    lib = _library()
    context, stream = _build.launch_on(dev)
    with context:
        acc = workspace(dev, stream, n)
        rc = lib.csr_stats_launch(values.data_ptr(), col_ids.data_ptr(),
                                  values.numel(), n, plan.blocks,
                                  plan.table_slots.bit_length() - 1,
                                  acc.data_ptr(), out[0].data_ptr(),
                                  out[1].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"csr_stats launch failed: "
                           f"{lib.csr_stats_error_string(rc).decode()} "
                           f"(entries={values.numel()}, n={n}, plan={plan})")
    global launches
    launches += 1
    return out[0], out[1]
