"""Dense Gram on Hopper (kernel K6): the CUDA kernel's wrapper.

Port of ``repro.kernels.gram`` (TPU kernel `_kernel`, launched by
``gram_pallas``).  ONE launch computes ``C = A^T A``, (n, n) float32, of
a dense (m, n) float32 block, contracting over rows; see
``csrc/gram.cu`` for the design (one CTA per 32 x 32 output tile of the
upper triangle, row panels through shared memory, rows summed in
ascending order on the CUDA cores) and what bounds it.  Ragged m and n
are masked in the kernel, so there is no padding.  Its plain version is
`kernels.ref.gram_ref`.

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
    lib = _build.load("gram")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gram_launch.argtypes = [p, i, i, p, p]
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
    A = A.contiguous()
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gram_launch(A.data_ptr(), m, n, C.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gram launch failed: "
                           f"{lib.gram_error_string(rc).decode()} "
                           f"(m={m}, n={n})")
    global launches
    launches += 1
    return C
