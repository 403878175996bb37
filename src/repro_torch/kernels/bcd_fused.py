r"""Fused whole-solve BCD (Algorithm 1) on Hopper: the CUDA kernel's wrapper
and its launch plan.

Port of ``repro.kernels.bcd_fused`` (TPU kernels `_bcd_resident_kernel`
and `_bcd_tiled_kernel`).  The kernel (``csrc/bcd_fused.cu``) runs every
sweep of B independent problems in ONE launch, grid = (B,), one CTA per
problem; see the source for the design and what bounds it.  Its plain
version is `kernels.ref.bcd_solve_masked_ref` / `bcd_solve_batched_ref`.

Two schemes replace the TPU's VMEM budgets (a TPU core's ~16 MB, which do
not carry over to a 227 KB block):

* ``smem``   — one warp; X lives in its shared memory for the whole
  solve, the vectors in registers (``slots`` = n_pad / 32 a lane);
  chosen when its ``n_pad^2`` words (and a slack row) fit in 227 KB
  (float32: n_pad <= 224, float64: n_pad <= 160).
* ``global`` — min(n_pad, 512) threads; X is updated in place in the
  output buffer (L2 / HBM), the vectors in shared memory (3 n_pad + 16
  words: float32 n_pad <= 19,360, float64 n_pad <= 9,664).

Problems are zero-padded to a multiple of 32 (a warp), not the TPU's 128
lanes: the padding is never computed on (every loop stops at n_valid), and
a smaller pad keeps more buckets in shared memory.

Only this module touches the library; every launch adds one to
`launches`, and nothing else does.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build

SMEM_LIMIT_BYTES = 232_448        # dynamic shared memory one H100 block may use
MAX_THREADS = 512                 # ``global``: threads of a CTA
_RED_SLOTS = MAX_THREADS // 32    # ``global``: one partial sum a warp
_SCHEME_CODES = {"smem": 0, "global": 1}

launches = 0                      # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


def pad32(n: int) -> int:
    return max(32, -(-int(n) // 32) * 32)


@dataclass(frozen=True)
class SolvePlan:
    """How one launch executes a (batch of) whole solve(s) on the card:
    one CTA a problem."""

    scheme: str         # 'smem' | 'global'
    n_pad: int          # problem size padded to a multiple of 32
    slots: int          # smem: n_pad / 32, the vector slots each lane owns
    threads: int        # CTA size: one warp (smem), min(n_pad, 512) (global)
    smem_bytes: int     # dynamic shared memory of one CTA


def smem_bytes(scheme: str, n_pad: int, itemsize: int) -> int:
    """Shared memory of one CTA: X and a slack of n_pad + 32 words that
    the box QP's look-ahead reads past the last row (``smem``), or u, w, s
    and a partial sum a warp (``global``)."""
    words = (n_pad * n_pad + n_pad + 32 if scheme == "smem"
             else 3 * n_pad + _RED_SLOTS)
    return words * itemsize


def plan_fused_solve(n: int, itemsize: int = 4,
                     scheme: str = "auto") -> SolvePlan:
    """The launch plan at reduced size ``n``: ``smem`` when X fits a
    block's shared memory, else ``global``; a forced ``scheme`` is taken
    as given (it raises if it does not fit).  The batch size does not
    enter: each problem has its own CTA."""
    n_pad = pad32(n)
    if scheme == "auto":
        scheme = ("smem" if smem_bytes("smem", n_pad, itemsize)
                  <= SMEM_LIMIT_BYTES else "global")
    if scheme not in _SCHEME_CODES:
        raise ValueError(f"unknown scheme {scheme!r} (auto | smem | global)")
    need = smem_bytes(scheme, n_pad, itemsize)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"scheme {scheme!r} needs {need} B of shared memory at "
            f"n_pad={n_pad}, over the {SMEM_LIMIT_BYTES} B a block may use")
    if scheme == "smem":
        return SolvePlan(scheme, n_pad, n_pad // 32, 32, need)
    return SolvePlan(scheme, n_pad, 0, min(n_pad, MAX_THREADS), need)


def _library():
    lib = _build.load("bcd_fused")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bcd_fused_launch.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.bcd_fused_launch.restype = i
        lib.bcd_fused_divide.argtypes = [p, p, p, ctypes.c_longlong, p]
        lib.bcd_fused_divide.restype = i
        lib.bcd_fused_error_string.argtypes = [i]
        lib.bcd_fused_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def launch(Sigma3, X03, scal, *, plan: SolvePlan, max_sweeps: int,
           qp_sweeps: int, tau_iters: int):
    """ONE kernel launch over B padded problems.

    ``Sigma3``/``X03`` are contiguous (B, n_pad, n_pad) CUDA tensors of one
    float dtype, zero beyond each problem's ``n_valid``; ``scal`` is (B, 4)
    rows of [lam, beta, n_valid, tol] in that dtype.  Returns
    ``(X (B, n_pad, n_pad), hist (B, max_sweeps), meta (B, 2) = [F, sweeps])``.
    """
    B, n_pad = Sigma3.shape[0], Sigma3.shape[-1]
    dtype = Sigma3.dtype
    for name, t, shape in (("Sigma", Sigma3, (B, n_pad, n_pad)),
                           ("X0", X03, (B, n_pad, n_pad)),
                           ("scal", scal, (B, 4))):
        if not t.is_cuda:
            raise ValueError(f"bcd_fused: {name} must be a CUDA tensor")
        if t.device != Sigma3.device:
            raise ValueError(f"bcd_fused: {name} is on {t.device}, "
                             f"Sigma on {Sigma3.device}")
        if t.dtype != dtype or dtype not in (torch.float32, torch.float64):
            raise TypeError(f"bcd_fused: {name} is {t.dtype}; all inputs "
                            "must share float32 or float64")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"bcd_fused: {name} must be contiguous {shape}, "
                             f"got {tuple(t.shape)}")
    if n_pad != plan.n_pad:
        raise ValueError(f"bcd_fused: n_pad {n_pad} != plan {plan.n_pad}")
    if min(max_sweeps, qp_sweeps, tau_iters) < 0:
        raise ValueError("bcd_fused: sweep and iteration counts must be >= 0")
    lib = _library()
    X = torch.empty_like(Sigma3)
    hist = torch.empty((B, max_sweeps), dtype=dtype, device=Sigma3.device)
    meta = torch.empty((B, 2), dtype=dtype, device=Sigma3.device)
    context, stream = _build.launch_on(Sigma3.device)
    with context:
        rc = lib.bcd_fused_launch(
            Sigma3.element_size(), _SCHEME_CODES[plan.scheme],
            Sigma3.data_ptr(), X03.data_ptr(), scal.data_ptr(),
            X.data_ptr(), hist.data_ptr(), meta.data_ptr(),
            B, n_pad, max_sweeps, qp_sweeps, tau_iters, plan.threads, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"bcd_fused launch failed: {lib.bcd_fused_error_string(rc).decode()}"
            f" (B={B}, n_pad={n_pad}, scheme={plan.scheme})")
    global launches
    launches += 1
    return X, hist, meta


def divide_on_card(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x / y`` by the kernel's float32 division (the divisor's reciprocal
    formed ahead of the dividend), for the test that holds it to the
    card's IEEE division bit for bit; float32 CUDA tensors of one shape.
    Not counted in `launches`: it runs no solve."""
    if not (x.is_cuda and y.is_cuda) or x.dtype != torch.float32 \
            or y.dtype != torch.float32 or x.shape != y.shape:
        raise ValueError("bcd_fused.divide_on_card: needs float32 CUDA "
                         "tensors of one shape")
    x, y = x.contiguous(), y.contiguous()
    q = torch.empty_like(x)
    lib = _library()
    context, stream = _build.launch_on(x.device)
    with context:
        rc = lib.bcd_fused_divide(x.data_ptr(), y.data_ptr(), q.data_ptr(),
                                  x.numel(), stream)
    if rc != 0:
        raise RuntimeError("bcd_fused divide failed: "
                           f"{lib.bcd_fused_error_string(rc).decode()}")
    return q


def _pad_stack(Sigma3, X03, n_pad):
    p = n_pad - Sigma3.shape[-1]
    if p:
        Sigma3 = torch.nn.functional.pad(Sigma3, (0, p, 0, p))
        X03 = torch.nn.functional.pad(X03, (0, p, 0, p))
    return Sigma3.contiguous(), X03.contiguous()


def bcd_solve_batched_cuda(Sigmas, lams, betas, X0s, tol, n_valids, *,
                           max_sweeps: int = 20, qp_sweeps: int = 4,
                           tau_iters: int = 80, scheme: str = "auto"):
    """B independent whole solves in ONE launch.  ``Sigmas``/``X0s`` are
    (B, n, n) with problem b in its leading ``n_valids[b]`` coordinates and
    zeros beyond.  Returns ``(X (B,n,n), obj (B,), sweeps (B,) int32,
    history (B, max_sweeps))``; ``obj`` is the barrier-free F at exit."""
    B, n, _ = Sigmas.shape
    dtype, dev = Sigmas.dtype, Sigmas.device
    plan = plan_fused_solve(n, Sigmas.element_size(), scheme)
    Sigma3, X03 = _pad_stack(Sigmas, X0s.to(dtype), plan.n_pad)
    scal = torch.stack([
        torch.as_tensor(lams, dtype=dtype, device=dev).reshape(-1).expand(B),
        torch.as_tensor(betas, dtype=dtype, device=dev).reshape(-1).expand(B),
        torch.as_tensor(n_valids, device=dev).reshape(-1).expand(B).to(dtype),
        torch.as_tensor(tol, dtype=dtype, device=dev).reshape(-1).expand(B),
    ], dim=1).contiguous()
    X, hist, meta = launch(Sigma3, X03, scal, plan=plan, max_sweeps=max_sweeps,
                           qp_sweeps=qp_sweeps, tau_iters=tau_iters)
    return X[:, :n, :n], meta[:, 0], meta[:, 1].to(torch.int32), hist


def bcd_solve_cuda(Sigma, lam, beta, X0, tol, *, max_sweeps: int = 20,
                   qp_sweeps: int = 4, tau_iters: int = 80,
                   n_valid: int | None = None, scheme: str = "auto"):
    """One whole solve in ONE launch; ``n_valid`` (default n) restricts it
    to the leading principal submatrix.  Returns ``(X, obj, sweeps,
    history)``."""
    n = Sigma.shape[0]
    X, obj, sweeps, hist = bcd_solve_batched_cuda(
        Sigma[None], lam, beta, X0[None], tol,
        n if n_valid is None else int(n_valid),
        max_sweeps=max_sweeps, qp_sweeps=qp_sweeps, tau_iters=tau_iters,
        scheme=scheme,
    )
    return X[0], obj[0], sweeps[0], hist[0]
