"""Sparse-projection gather-matvec on Hopper (kernel K4): the CUDA kernel's
wrapper.

Port of ``repro.kernels.project`` (TPU kernel `_kernel`, launched by
``sparse_project_pallas``).  ONE launch projects a batch X (B, n) of
documents onto k packed sparse components: ``out[b, c] = sum_j
values[c, j] * X[b, support_idx[c, j]]``; see ``csrc/project.cu`` for
the design (one thread per output, X read row-major where it lies) and
what bounds it.  Its plain version is `kernels.ref.sparse_project_ref`.

The reference's wrapper builds a transposed copy of the batch with an
appended zero row for the TPU kernel to gather rows from; this one does
not: that copy would read and write the whole (B, n) batch (26 MB at
NYTimes width) for the B * k * cap values the kernel needs.

Only this module touches the library; every launch adds one to
`launches`, and nothing else does.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

launches = 0                      # kernel launches since the last reset
_count_lock = threading.Lock()    # the serving thread and its caller launch


def reset_launches() -> None:
    global launches
    launches = 0


def _library():
    lib = _build.load("project")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sparse_project_launch.argtypes = [p, ll, ll, p, p, i, i, p, p]
        lib.sparse_project_launch.restype = i
        lib.sparse_project_error_string.argtypes = [i]
        lib.sparse_project_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def check_inputs(X, support_idx, values) -> None:
    """Raise on what K4 (and its plain version) does not take: X must be
    a (B, n) float32 tensor, ``support_idx`` an int32 and ``values`` a
    float32 tensor of one (k, cap) shape, all on one device."""
    for name, t in (("X", X), ("support_idx", support_idx),
                    ("values", values)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"sparse_project: {name} must be a tensor, got "
                            f"{type(t).__name__}")
    if X.dim() != 2 or X.dtype != torch.float32:
        raise TypeError(f"sparse_project: X must be (B, n) float32, got "
                        f"{tuple(X.shape)} {X.dtype}")
    if support_idx.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError(f"sparse_project: needs int32 support_idx and float32 "
                        f"values, got {support_idx.dtype} and {values.dtype}")
    if support_idx.dim() != 2 or support_idx.shape != values.shape:
        raise ValueError(f"sparse_project: support_idx "
                         f"{tuple(support_idx.shape)} and values "
                         f"{tuple(values.shape)} must be one (k, cap) shape")
    if not (X.device == support_idx.device == values.device):
        raise ValueError(f"sparse_project: X on {X.device}, support_idx on "
                         f"{support_idx.device}, values on {values.device}")


def sparse_project_cuda(X: torch.Tensor, support_idx: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """(B, k) float32 scores of the documents in ``X`` (B, n), contiguous
    float32 on the card, through the packed components ``support_idx``
    (int32) / ``values`` (float32), (k, cap) each, in ONE launch on the
    calling thread's current stream.  A slot whose value is 0 (padding)
    or whose index lies outside [0, n) adds nothing."""
    check_inputs(X, support_idx, values)
    if not X.is_cuda:
        raise ValueError(f"sparse_project: X must be a CUDA tensor, got "
                         f"{X.device}")
    if not (X.is_contiguous() and support_idx.is_contiguous()
            and values.is_contiguous()):
        raise ValueError("sparse_project: X, support_idx and values must be "
                         "contiguous")
    B, n = X.shape
    k, cap = support_idx.shape
    if n < 1:
        raise ValueError("sparse_project: X has no columns")
    out = torch.empty((B, k), dtype=torch.float32, device=X.device)
    if B * k == 0:
        return out
    lib = _library()
    context, stream = _build.launch_on(X.device)
    with context:
        rc = lib.sparse_project_launch(X.data_ptr(), B, n,
                                       support_idx.data_ptr(),
                                       values.data_ptr(), k, cap,
                                       out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sparse_project launch failed: "
                           f"{lib.sparse_project_error_string(rc).decode()} "
                           f"(B={B}, n={n}, k={k}, cap={cap})")
    global launches
    with _count_lock:
        launches += 1
    return out
