"""Dense column statistics on Hopper (kernel K5): the CUDA kernel's wrapper.

Port of ``repro.kernels.variance`` (TPU kernel `_kernel`, launched by
``column_stats_pallas``).  ONE launch reduces a dense (m, n) row block,
float32 or float64, to per-column ``(sum, sumsq)`` accumulated in
float32; see ``csrc/variance.cu`` for the design (one thread per column,
rows summed in ascending order, no atomics) and what bounds it.  Its
plain version is `kernels.ref.column_stats_ref`.

Only this module touches the library; every launch adds one to
`launches`, and nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0                      # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


def _library():
    lib = _build.load("variance")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.column_stats_launch.argtypes = [i, p, ll, i, p, p, p]
        lib.column_stats_launch.restype = i
        lib.column_stats_error_string.argtypes = [i]
        lib.column_stats_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def column_stats_cuda(A: torch.Tensor):
    """``(col_sum, col_sumsq)``, (n,) float32 each, of a (m, n) float32 or
    float64 CUDA tensor, in ONE launch (an (m, 0) block launches
    nothing)."""
    if not A.is_cuda:
        raise ValueError(f"column_stats: A must be a CUDA tensor, got "
                         f"{A.device}")
    if A.dim() != 2:
        raise ValueError(f"column_stats: A must be (m, n), got "
                         f"{tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"column_stats: A must be float32 or float64, got "
                        f"{A.dtype}")
    m, n = A.shape
    out = torch.empty((2, n), dtype=torch.float32, device=A.device)
    if n == 0:
        return out[0], out[1]
    A = A.contiguous()
    lib = _library()
    context, stream = _build.launch_on(A.device)
    with context:
        rc = lib.column_stats_launch(A.element_size(), A.data_ptr(), m, n,
                                     out[0].data_ptr(), out[1].data_ptr(),
                                     stream)
    if rc != 0:
        raise RuntimeError(f"column_stats launch failed: "
                           f"{lib.column_stats_error_string(rc).decode()} "
                           f"(m={m}, n={n}, dtype={A.dtype})")
    global launches
    launches += 1
    return out[0], out[1]
