"""Box-QP coordinate descent on Hopper (kernel K7, the legacy per-row
solver path): the CUDA kernel's wrapper.

Port of ``repro.kernels.bcd_sweep`` (TPU kernel `_qp_kernel`, launched by
``qp_sweep_pallas``).  ONE launch runs ``sweeps`` passes of coordinate
descent (11) with the closed-form step (13) for one BCD row update,
coordinate ``j`` pinned, and returns ``(u, w = Y u, R2 = u^T w)``; see
``csrc/bcd_sweep.cu`` for the design (one CTA, u and w in shared memory,
the matvec w = Y u0 in the kernel, one barrier a coordinate step).  Its
plain version is `kernels.ref.qp_sweep_ref`.

Contract: Y is symmetric, as it is on the path (the BCD iterate with row
and column j zeroed).  The kernel reads row i of Y where the TPU kernel
reads column i, so that a warp reads consecutive addresses; the two are
the same only for a symmetric Y.  No padding: the kernel stops at n.

Only this module touches the library; every launch adds one to
`launches`, and nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

SMEM_LIMIT_BYTES = 232_448        # dynamic shared memory one H100 block may use
MAX_THREADS = 512
_RED_SLOTS = MAX_THREADS // 32

launches = 0                      # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


def _library():
    lib = _build.load("bcd_sweep")
    if not getattr(lib, "_typed", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.qp_sweep_launch.argtypes = [i, p, p, p, d, i, i, i, p, p, p, i, p]
        lib.qp_sweep_launch.restype = i
        lib.qp_sweep_error_string.argtypes = [i]
        lib.qp_sweep_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def max_n(itemsize: int) -> int:
    """The largest n whose u, w, s and reduction slots fit a block's
    shared memory."""
    return (SMEM_LIMIT_BYTES // itemsize - _RED_SLOTS) // 3


def qp_sweep_cuda(Y: torch.Tensor, s: torch.Tensor, lam, u0: torch.Tensor,
                  j: int, sweeps: int):
    """``(u, w, R2)`` of ``sweeps`` coordinate-descent passes on the box QP
    (11) from ``u0`` with coordinate ``j`` pinned, in ONE launch.  ``Y``
    (n, n) symmetric, ``s`` and ``u0`` (n,): CUDA tensors of one float32
    or float64 dtype; ``lam`` is rounded to that dtype.  ``R2`` is a 0-d
    tensor."""
    if not (Y.is_cuda and s.is_cuda and u0.is_cuda):
        raise ValueError("qp_sweeps: Y, s and u0 must be CUDA tensors")
    if not (Y.device == s.device == u0.device):
        raise ValueError(f"qp_sweeps: Y on {Y.device}, s on {s.device}, u0 "
                         f"on {u0.device}")
    if Y.dtype not in (torch.float32, torch.float64) \
            or not (Y.dtype == s.dtype == u0.dtype):
        raise TypeError(f"qp_sweeps: Y, s and u0 must share float32 or "
                        f"float64, got {Y.dtype}, {s.dtype}, {u0.dtype}")
    n = Y.shape[0]
    if Y.dim() != 2 or Y.shape[1] != n or s.shape != (n,) \
            or u0.shape != (n,):
        raise ValueError(f"qp_sweeps: Y must be (n, n) and s, u0 (n,), got "
                         f"{tuple(Y.shape)}, {tuple(s.shape)}, "
                         f"{tuple(u0.shape)}")
    if n > max_n(Y.element_size()):
        raise ValueError(f"qp_sweeps: n = {n} exceeds the "
                         f"{max_n(Y.element_size())} whose state fits a "
                         "block's shared memory")
    if sweeps < 0:
        raise ValueError(f"qp_sweeps: sweeps must be >= 0, got {sweeps}")
    u = torch.empty(n, dtype=Y.dtype, device=Y.device)
    w = torch.empty_like(u)
    r2 = torch.zeros((), dtype=Y.dtype, device=Y.device)
    if n == 0:
        return u, w, r2
    Y, s, u0 = Y.contiguous(), s.contiguous(), u0.contiguous()
    threads = min(MAX_THREADS, -(-n // 32) * 32)
    lib = _library()
    context, stream = _build.launch_on(Y.device)
    with context:
        rc = lib.qp_sweep_launch(Y.element_size(), Y.data_ptr(),
                                 s.data_ptr(), u0.data_ptr(), float(lam),
                                 int(j), n, int(sweeps), u.data_ptr(),
                                 w.data_ptr(), r2.data_ptr(), threads, stream)
    if rc != 0:
        raise RuntimeError(f"qp_sweeps launch failed: "
                           f"{lib.qp_sweep_error_string(rc).decode()} "
                           f"(n={n}, sweeps={sweeps}, dtype={Y.dtype})")
    global launches
    launches += 1
    return u, w, r2
