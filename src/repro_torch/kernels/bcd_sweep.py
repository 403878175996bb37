"""Box-QP coordinate descent on Hopper (kernel K7, the legacy per-row
solver path): the CUDA kernel's wrapper and its launch plan.

Port of ``repro.kernels.bcd_sweep`` (TPU kernel `_qp_kernel`, launched by
``qp_sweep_pallas``).  ONE launch runs ``sweeps`` passes of coordinate
descent (11) with the closed-form step (13) for one BCD row update,
coordinate ``j`` pinned, and returns ``(u, w = Y u, R2 = u^T w)``; see
``csrc/bcd_sweep.cu`` for the design.  Its plain version is
`kernels.ref.qp_sweep_ref`.

Two schemes, one CTA each, chosen by size (`plan_qp_sweep`):

* ``warp``  — one warp, Y copied once into its shared memory, the vectors
  in registers (``slots`` = n_pad / 32 a lane), K1's coordinate step;
  chosen where ``n_pad^2 + n_pad + 32`` words fit a block's 227 KB
  (float32: n_pad <= 224, float64: n_pad <= 160).
* ``block`` — min(n_pad, 512) threads, Y read from global memory, the
  vectors in shared memory (3 n + 16 words: float32 n <= 19,365, float64
  n <= 9,680), a block barrier a coordinate step.

The two give the same bits for w and R2 where both fit.

Contract: Y is symmetric, as it is on the path (the BCD iterate with
row and column j zeroed; neither scheme needs them zero).  The kernel
reads row i of Y where the TPU kernel reads column i, so that a warp
reads consecutive addresses; the two are the same only for a symmetric
Y.  No padding: the kernel stops at n.

Only this module touches the library; every launch adds one to
`launches`, and nothing else does.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build

SMEM_LIMIT_BYTES = 232_448        # dynamic shared memory one H100 block may use
MAX_THREADS = 512                 # ``block``: threads of the CTA
_RED_SLOTS = MAX_THREADS // 32    # ``block``: one partial sum a warp
_SCHEME_CODES = {"warp": 0, "block": 1}

launches = 0                      # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


@dataclass(frozen=True)
class QPSweepPlan:
    """How one launch runs a row update's box QP on the card: one CTA."""

    scheme: str         # 'warp' | 'block'
    n_pad: int          # n padded to a multiple of 32
    slots: int          # warp: n_pad / 32, the vector slots each lane owns
    threads: int        # CTA size: one warp, or min(n_pad, 512)
    smem_bytes: int     # dynamic shared memory of the CTA


def smem_bytes(scheme: str, n: int, itemsize: int) -> int:
    """Shared memory of the CTA: Y at n_pad^2 words, u0 and a slack of 32
    words, and 16 bytes to align Y's bulk copy (``warp``); or u, w, s and
    a partial sum a warp (``block``)."""
    n_pad = -(-int(n) // 32) * 32
    if scheme == "warp":
        return (n_pad * n_pad + n_pad + 32) * itemsize + 16
    return (3 * int(n) + _RED_SLOTS) * itemsize


@functools.lru_cache(maxsize=None)
def plan_qp_sweep(n: int, itemsize: int = 4,
                  scheme: str = "auto") -> QPSweepPlan:
    """The launch plan at size ``n``: ``warp`` where it fits a block's
    shared memory, else ``block``; a forced ``scheme`` is taken as given
    (it raises if it does not fit)."""
    n_pad = max(32, -(-int(n) // 32) * 32)
    if scheme == "auto":
        scheme = ("warp" if smem_bytes("warp", n, itemsize) <= SMEM_LIMIT_BYTES
                  else "block")
    if scheme not in _SCHEME_CODES:
        raise ValueError(f"unknown scheme {scheme!r} (auto | warp | block)")
    need = smem_bytes(scheme, n, itemsize)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"qp_sweeps: scheme {scheme!r} needs {need} B of shared memory "
            f"at n = {n}, over the {SMEM_LIMIT_BYTES} B a block may use")
    if scheme == "warp":
        return QPSweepPlan(scheme, n_pad, n_pad // 32, 32, need)
    return QPSweepPlan(scheme, n_pad, 0, min(n_pad, MAX_THREADS), need)


def _library():
    lib = _build.load("bcd_sweep")
    if not getattr(lib, "_typed", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.qp_sweep_launch.argtypes = [i, i, p, p, p, d, i, i, i, p, p, p, i, p]
        lib.qp_sweep_launch.restype = i
        lib.qp_sweep_error_string.argtypes = [i]
        lib.qp_sweep_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def qp_sweep_cuda(Y: torch.Tensor, s: torch.Tensor, lam, u0: torch.Tensor,
                  j: int, sweeps: int, scheme: str = "auto"):
    """``(u, w, R2)`` of ``sweeps`` coordinate-descent passes on the box QP
    (11) from ``u0`` with coordinate ``j`` pinned, in ONE launch.  ``Y``
    (n, n) symmetric with row and column ``j`` zero, ``s`` and ``u0``
    (n,): CUDA tensors of one float32 or float64 dtype; ``lam`` is rounded
    to that dtype.  ``R2`` is a 0-d tensor.  ``scheme`` as in
    `plan_qp_sweep`."""
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
    if sweeps < 0:
        raise ValueError(f"qp_sweeps: sweeps must be >= 0, got {sweeps}")
    u = torch.empty(n, dtype=Y.dtype, device=Y.device)
    w = torch.empty_like(u)
    if n == 0:
        return u, w, torch.zeros((), dtype=Y.dtype, device=Y.device)
    r2 = torch.empty((), dtype=Y.dtype, device=Y.device)
    plan = plan_qp_sweep(n, Y.element_size(), scheme)
    Y, s, u0 = Y.contiguous(), s.contiguous(), u0.contiguous()
    lib = _library()
    context, stream = _build.launch_on(Y.device)
    with context:
        rc = lib.qp_sweep_launch(Y.element_size(), _SCHEME_CODES[plan.scheme],
                                 Y.data_ptr(), s.data_ptr(), u0.data_ptr(),
                                 float(lam), int(j), n, int(sweeps),
                                 u.data_ptr(), w.data_ptr(), r2.data_ptr(),
                                 plan.threads, stream)
    if rc != 0:
        raise RuntimeError(f"qp_sweeps launch failed: "
                           f"{lib.qp_sweep_error_string(rc).decode()} "
                           f"(n={n}, sweeps={sweeps}, dtype={Y.dtype}, "
                           f"scheme={plan.scheme})")
    global launches
    launches += 1
    return u, w, r2
