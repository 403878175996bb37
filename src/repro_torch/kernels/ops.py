"""Public wrappers of the port's kernels (port of the solver half of
``repro.kernels.ops``).

Dispatch is by device, not by a fallback: a CUDA tensor goes to the
hand-written kernel (``impl='auto'`` or ``'cuda'``) and a failed build or
launch raises; a CPU tensor goes to the kernel's plain version in
`kernels.ref`.  ``impl='ref'`` forces the plain version on any device,
and ``impl='cuda'`` on a CPU tensor raises.  Every call counts one
``kernel.launches.<op>`` dispatch in the metrics registry.
"""
from __future__ import annotations

import torch

from ..obs import metrics, profile
from . import bcd_fused, ref
from .bcd_fused import SolvePlan, plan_fused_solve

__all__ = [
    "SOLVER_FAULTS", "SolvePlan", "bcd_solve", "bcd_solve_batched",
    "plan_fused_solve", "solver_fault_after", "solver_fault_before",
]

# Solver-fault seam (as in the reference): a test installs an injector
# here to perturb solve results or raise dispatch errors at exact call
# occurrences, by site name ("bcd_solve", "bcd_solve_batched").  ``None``
# (production) costs one attribute check per wrapper call.
SOLVER_FAULTS = None


def solver_fault_before(site: str) -> None:
    """Dispatch-error injection point: an installed injector may raise."""
    if SOLVER_FAULTS is not None:
        SOLVER_FAULTS.before(site)


def solver_fault_after(site: str, out, *, max_sweeps: int):
    """Result-perturbation injection point around a solve's returned
    ``(X, obj, sweeps, history)`` tuple (single or batched)."""
    if SOLVER_FAULTS is not None:
        return SOLVER_FAULTS.after(site, out, max_sweeps=max_sweeps)
    return out


def _launch(op: str):
    """Per-op dispatch accounting at the wrapper boundary: bump the
    ``kernel.launches.<op>`` counter and open an ``ops.<op>`` profiler
    region (a no-op unless profiling is on)."""
    metrics.counter(f"kernel.launches.{op}").inc()
    return profile.annotate(f"ops.{op}")


def use_kernel(impl: str, t: torch.Tensor) -> bool:
    """Whether a call with ``impl`` on tensor ``t`` runs the CUDA kernel."""
    if impl == "ref":
        return False
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown impl {impl!r} (auto | cuda | ref)")
    if t.is_cuda:
        return True
    if impl == "cuda":
        raise ValueError("impl='cuda' needs CUDA tensors; this one is on "
                         f"{t.device}")
    return False


def bcd_solve(Sigma, lam, beta, X0=None, *, max_sweeps: int = 20,
              qp_sweeps: int = 4, tol: float = 1e-7, tau_iters: int = 80,
              n_valid: int | None = None, impl: str = "auto",
              scheme: str = "auto"):
    """Whole-solve fused BCD (Algorithm 1): ONE kernel launch per solve.

    ``scheme`` picks the kernel's scheme ('auto' | 'smem' | 'global', see
    `plan_fused_solve`).  ``n_valid`` restricts the solve to the leading
    principal submatrix of a zero-padded problem.  Returns ``(X, obj,
    sweeps, history)``; ``obj``/``history`` are the barrier-free objective
    of the kernel's early exit.
    """
    n = Sigma.shape[0]
    dtype = Sigma.dtype
    if X0 is None:
        X0 = torch.eye(n, dtype=dtype, device=Sigma.device)
        if n_valid is not None and n_valid < n:
            X0[n_valid:, n_valid:] = 0
    kernel = use_kernel(impl, Sigma)
    with _launch("bcd_solve"):
        solver_fault_before("bcd_solve")
        if kernel:
            out = bcd_fused.bcd_solve_cuda(
                Sigma, lam, beta, X0, tol, max_sweeps=max_sweeps,
                qp_sweeps=qp_sweeps, tau_iters=tau_iters, n_valid=n_valid,
                scheme=scheme,
            )
        else:
            out = ref.bcd_solve_masked_ref(
                Sigma, lam, beta, X0, tol, n if n_valid is None else n_valid,
                max_sweeps=max_sweeps, qp_sweeps=qp_sweeps,
                tau_iters=tau_iters,
            )
    return solver_fault_after("bcd_solve", out, max_sweeps=max_sweeps)


def bcd_solve_batched(Sigmas, lams, betas, X0s, n_valids, *,
                      max_sweeps: int = 20, qp_sweeps: int = 4,
                      tol: float = 1e-7, tau_iters: int = 80,
                      impl: str = "auto", scheme: str = "auto"):
    """B independent whole solves in ONE launch (grid = (B,)).

    ``Sigmas``/``X0s`` are (B, n, n) zero-padded problems occupying their
    leading ``n_valids[b]`` coordinates.  Returns ``(X (B,n,n), obj (B,),
    sweeps (B,), history (B, max_sweeps))``.
    """
    kernel = use_kernel(impl, Sigmas)
    with _launch("bcd_solve_batched"):
        solver_fault_before("bcd_solve_batched")
        if kernel:
            out = bcd_fused.bcd_solve_batched_cuda(
                Sigmas, lams, betas, X0s, tol, n_valids,
                max_sweeps=max_sweeps, qp_sweeps=qp_sweeps,
                tau_iters=tau_iters, scheme=scheme,
            )
        else:
            out = ref.bcd_solve_batched_ref(
                Sigmas, lams, betas, X0s, tol, n_valids,
                max_sweeps=max_sweeps, qp_sweeps=qp_sweeps,
                tau_iters=tau_iters,
            )
    return solver_fault_after("bcd_solve_batched", out,
                              max_sweeps=max_sweeps)
