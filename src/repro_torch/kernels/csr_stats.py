"""CSR column statistics on Hopper (kernel K2): the CUDA kernel's wrapper.

Port of ``repro.kernels.csr_stats`` (TPU kernel `_kernel`).  ONE launch
reduces a megabatch of C padded CSR chunks to per-column ``(sum, sumsq)``
in float32; see ``csrc/csr_stats.cu`` for the design (a float64
scatter-add with atomics, rounded to float32 once) and what bounds it.
Its plain version is `kernels.ref.csr_column_stats_batched_ref`.

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
    lib = _build.load("csr_stats")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.csr_stats_launch.argtypes = [p, p, ll, i, p, p, p, p]
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
    # [sum_c, sumsq_c] pairs in float64, then one 8-byte ticket slot
    acc = torch.zeros(2 * n + 1, dtype=torch.float64, device=dev)
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.csr_stats_launch(values.data_ptr(), col_ids.data_ptr(),
                                  values.numel(), n, acc.data_ptr(),
                                  out[0].data_ptr(), out[1].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"csr_stats launch failed: "
                           f"{lib.csr_stats_error_string(rc).decode()} "
                           f"(entries={values.numel()}, n={n})")
    global launches
    launches += 1
    return out[0], out[1]
