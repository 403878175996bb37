"""Block coordinate ascent for DSPCA (Algorithm 1 of Zhang & El Ghaoui, 2011).

Port of ``repro.core.bcd``.  Solves the augmented problem (6)

    max_X  Tr(Sigma X) - lam*||X||_1 - (Tr X)^2 / 2 + beta*logdet X,   X > 0

whose solution is an eps-suboptimal solution of the DSPCA SDP (1) when
``beta = eps/n``; the DSPCA variable is recovered as ``Z = X / Tr X``.
Each row/column update solves the box QP (11) by coordinate descent with
the closed form (13), then the 1-D problem in tau by bisection, then
writes ``y = Y u / tau``, ``x = sigma - lam - t + tau``.

Two solver programs, chosen by ``solver_impl``:

* ``'jnp'`` — the whole-matrix program (`_solve_bcd`), stopping on the
  augmented objective (its slogdet taken between sweeps); the name is the
  reference's, kept so a config dict carries across.  On the CPU its
  sweeps are plain row updates; on the card each sweep is one launch of
  the fused kernel with the early exit off, so the plain Python loop never
  runs on the card's main path (the supervisor's fallback re-solves run
  here).  ``qp_impl='pallas'`` (the reference's name for its legacy
  per-row kernel, kept so a config dict carries across) makes each sweep
  n row updates instead, each solving its box QP through `kernels.ops.
  qp_sweeps`: ONE launch of kernel K7 a row on the card, its plain
  version on the CPU.
* ``'fused'`` — ONE launch of the hand-written CUDA kernel per solve
  (`kernels.ops.bcd_solve`), stopping on the barrier-free F(X);
  ``'fused_ref'`` runs the kernel's plain version instead.

``'auto'`` is ``'fused'`` on a CUDA tensor (float32 and float64 alike:
the reference's itemsize <= 4 rule is a TPU compiler limit) and ``'jnp'``
on a CPU one.  Functions run on the device of their tensors.
"""
from __future__ import annotations

import itertools
import os
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ref as kref
from ..obs import metrics, trace


class SolverDivergenceError(RuntimeError):
    """A solve produced a non-finite objective on EVERY available path
    (fused kernel and the whole-matrix program as fallback): the problem itself is
    numerically bad, not the backend.  Carries the repro coordinates and,
    when a debris dir was configured, the path of the dumped
    (Sigma_hat, lam, X0, n_valid) bundle.  Raised out of
    `spca.fit_components`, ``completed`` holds the components the fit
    finished before it."""

    def __init__(self, msg: str, *, lam: float | None = None,
                 n: int | None = None, debris_path: str | None = None):
        super().__init__(msg)
        self.lam = lam
        self.n = n
        self.debris_path = debris_path
        self.completed: tuple = ()


_DEBRIS_SEQ = itertools.count()


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dump_debris(debris_dir: str, *, Sigma, lam, X0, n_valid,
                 tag: str = "solve") -> str:
    """Dump a self-contained repro bundle for a diverged problem (the
    reference's npz layout: Sigma_hat, lam, X0, n_valid)."""
    os.makedirs(debris_dir, exist_ok=True)
    Sigma = _host(Sigma)
    n = Sigma.shape[0]
    while True:
        path = os.path.join(
            debris_dir, f"debris_{tag}_{next(_DEBRIS_SEQ):04d}.npz"
        )
        if not os.path.exists(path):
            break
    np.savez(
        path,
        Sigma_hat=Sigma,
        lam=np.asarray(float(lam), np.float64),
        X0=_host(X0) if X0 is not None else np.eye(n, dtype=Sigma.dtype),
        n_valid=np.asarray(int(n_valid if n_valid is not None else n)),
    )
    return path


class BCDResult(NamedTuple):
    X: torch.Tensor          # solution of the augmented problem (6)
    Z: torch.Tensor          # X / Tr X — feasible for DSPCA (1)
    obj: torch.Tensor        # augmented objective value at X
    phi: torch.Tensor        # primal DSPCA value Tr(Sigma Z) - lam ||Z||_1
    # (max_sweeps,) per-sweep objective trace, nan-padded past the executed
    # sweeps: the augmented objective on the 'jnp' program, the barrier-free
    # F(X) on the fused impls.
    history: torch.Tensor
    sweeps: torch.Tensor     # number of sweeps actually executed
    beta: float = 0.0        # logdet barrier weight actually used
    # Final barrier-free F(X) as the fused kernel computed it for its early
    # exit; None on the 'jnp' program.
    kernel_obj: torch.Tensor | None = None


def augmented_objective(X, Sigma, lam, beta):
    """Objective of problem (6)."""
    sign, logdet = torch.linalg.slogdet(X)
    logdet = torch.where(sign > 0, logdet, torch.full_like(logdet, -torch.inf))
    return (
        torch.sum(Sigma * X)
        - lam * torch.sum(torch.abs(X))
        - 0.5 * torch.trace(X) ** 2
        + beta * logdet
    )


def primal_value(Z, Sigma, lam):
    """DSPCA primal objective phi(Z) = Tr(Sigma Z) - lam ||Z||_1."""
    return torch.sum(Sigma * Z) - lam * torch.sum(torch.abs(Z))


def qp_coordinate_descent(Y, s, lam, u0, j, sweeps: int):
    """Solve (11) ``min u^T Y u : ||u - s||_inf <= lam`` with ``u_j`` pinned.
    ``Y`` must have row/column ``j`` zeroed.  Returns (u, w=Y@u, R2=u^T Y u)
    as tensors."""
    return kref.qp_sweep_ref(Y, s, lam, u0, j, sweeps)


def solve_tau(R2, c, beta, iters: int = 80, dtype=torch.float64) -> float:
    """min_{tau>0} R2/tau - beta*log(tau) + (c + tau)^2 / 2, by bisection
    on the strictly increasing derivative g(tau) = tau + c - R2/tau^2 -
    beta/tau, computed in ``dtype``."""
    ft = kref.np_scalar(dtype)
    return float(kref.solve_tau(ft(float(R2)), ft(float(c)), ft(float(beta)),
                                iters))


def row_update(X, Sigma, lam, beta, j: int, qp_sweeps: int,
               tau_iters: int = 80, qp_impl: str = "jnp"):
    """Update row/column ``j`` of ``X`` (steps 4-6 of Algorithm 1); returns
    the new X.  ``qp_impl='pallas'`` solves the box QP through
    `kernels.ops.qp_sweeps` (kernel K7 on the card)."""
    n = X.shape[0]
    ft = kref.np_scalar(X.dtype)
    mask = torch.ones(n, dtype=X.dtype, device=X.device)
    mask[j] = 0
    Y = X * mask[:, None] * mask[None, :]       # X with row/col j zeroed
    s = Sigma[:, j] * mask
    t = ft(torch.trace(Y).item())
    c = ft(Sigma[j, j].item()) - ft(lam) - t
    if qp_impl == "pallas":
        from ..kernels import ops as kernel_ops

        _, w, R2 = kernel_ops.qp_sweeps(Y, s, lam, s, j, sweeps=qp_sweeps)
        R2 = ft(R2.item())
    else:
        _, w, R2 = kref.box_qp(Y, s, lam, s, j, qp_sweeps)
    tau = kref.solve_tau(R2, c, ft(beta), tau_iters)
    y = w / float(tau)                          # zero at j
    Y[:, j] = y
    Y[j, :] = y
    Y[j, j] = float(c + tau)
    return Y


def _sweep(X, Sigma, lam, beta, qp_sweeps, tau_iters, qp_impl="jnp"):
    """One sweep of n row updates.  On the card with ``qp_impl='jnp'`` it
    is ONE launch of the fused kernel with the early exit off (the plain
    row loop never runs on the card's main path); otherwise the row
    updates one by one (with ``'pallas'``, one K7 launch a row on the
    card)."""
    if X.is_cuda and qp_impl == "jnp":
        from ..kernels import bcd_fused

        return bcd_fused.bcd_solve_cuda(
            Sigma, lam, beta, X, -1.0, max_sweeps=1, qp_sweeps=qp_sweeps,
            tau_iters=tau_iters)[0]
    for j in range(X.shape[0]):
        X = row_update(X, Sigma, lam, beta, j, qp_sweeps, tau_iters, qp_impl)
    return X


def _solve_bcd(Sigma, lam, beta, X0, max_sweeps, qp_sweeps, tol, tau_iters,
               qp_impl="jnp"):
    """The whole-matrix program: sweeps until the augmented objective (6)
    is sweep-to-sweep stationary, tested on the host between sweeps."""
    ft = kref.np_scalar(Sigma.dtype)
    lam_t = torch.tensor(float(ft(lam)), dtype=Sigma.dtype, device=Sigma.device)
    beta_t = torch.tensor(float(ft(beta)), dtype=Sigma.dtype,
                          device=Sigma.device)
    tol = ft(tol)
    X = X0.clone()
    hist = torch.full((max_sweeps,), float("nan"), dtype=Sigma.dtype,
                      device=Sigma.device)
    prev = obj_s = ft(-np.inf)
    obj = torch.tensor(-np.inf, dtype=Sigma.dtype, device=Sigma.device)
    k = 0
    done = False
    while not done and k < max_sweeps:
        X = _sweep(X, Sigma, lam, beta, qp_sweeps, tau_iters, qp_impl)
        obj = augmented_objective(X, Sigma, lam_t, beta_t)
        obj_s = ft(obj.item())
        hist[k] = obj
        with np.errstate(invalid="ignore"):    # inf - inf is nan: not done
            done = bool(abs(obj_s - prev) <= tol * (ft(1.0) + abs(obj_s)))
        prev = obj_s
        k += 1
    Z = X / torch.trace(X)
    return BCDResult(
        X=X, Z=Z, obj=obj, phi=primal_value(Z, Sigma, lam_t), history=hist,
        sweeps=torch.tensor(k, dtype=torch.int32, device=Sigma.device),
    )


def _resolve_solver_impl(solver_impl: str, device) -> str:
    """Map 'auto' to a concrete impl: the fused kernel on a CUDA device
    (any problem size and float dtype — the global scheme has no size
    cap), the whole-matrix program elsewhere."""
    if solver_impl == "auto":
        return "fused" if torch.device(device).type == "cuda" else "jnp"
    if solver_impl not in ("jnp", "fused", "fused_ref"):
        raise ValueError(f"unknown solver_impl {solver_impl!r} "
                         "(auto | jnp | fused | fused_ref)")
    return solver_impl


def check_qp_impl(qp_impl: str) -> None:
    """Refuse an unknown inner-QP backend of the 'jnp' program."""
    if qp_impl not in ("jnp", "pallas"):
        raise ValueError(f"unknown qp_impl {qp_impl!r} (jnp | pallas)")


def default_beta(Sigma) -> float:
    """The logdet barrier weight ``1e-4 Tr(Sigma) / n`` (eps/n-style)."""
    return 1e-4 * float(torch.trace(Sigma)) / Sigma.shape[0]


def solve_bcd(
    Sigma,
    lam: float,
    *,
    beta: float | None = None,
    max_sweeps: int = 20,
    qp_sweeps: int = 4,
    tol: float = 1e-7,
    tau_iters: int = 80,
    X0=None,
    qp_impl: str = "jnp",
    solver_impl: str = "jnp",
) -> BCDResult:
    """Solve DSPCA (1) by block coordinate ascent on the augmented problem
    (6), on the device of ``Sigma`` (an (n, n) tensor).

    ``solver_impl``: 'jnp' (the whole-matrix program), 'fused' (ONE CUDA kernel
    launch for the whole solve), 'fused_ref' (its plain version) or 'auto'
    (fused on CUDA, jnp on the CPU).  ``qp_impl`` is the 'jnp' program's
    inner-QP backend: 'jnp' or 'pallas' (the legacy per-row path, one K7
    launch a row update on the card); the fused impls ignore it, as the
    reference's do.
    """
    check_qp_impl(qp_impl)
    n = Sigma.shape[0]
    if beta is None:
        beta = default_beta(Sigma)
    if X0 is None:
        X0 = torch.eye(n, dtype=Sigma.dtype, device=Sigma.device)
    else:
        X0 = X0.to(Sigma.dtype)
    impl = _resolve_solver_impl(solver_impl, Sigma.device)
    if impl in ("fused", "fused_ref"):
        from ..kernels import ops as kernel_ops

        lam_t = torch.tensor(float(lam), dtype=Sigma.dtype, device=Sigma.device)
        beta_t = torch.tensor(float(beta), dtype=Sigma.dtype,
                              device=Sigma.device)
        with trace.span("solver.solve", n=n, impl=impl):
            X, kernel_obj, sweeps, hist = kernel_ops.bcd_solve(
                Sigma, lam, beta, X0, max_sweeps=max_sweeps,
                qp_sweeps=qp_sweeps, tol=tol, tau_iters=tau_iters,
                impl="cuda" if impl == "fused" else "ref",
            )
            trace.device_sync(X)
        Z = X / torch.trace(X)
        return BCDResult(
            X=X, Z=Z, obj=augmented_objective(X, Sigma, lam_t, beta_t),
            phi=primal_value(Z, Sigma, lam_t), history=hist, sweeps=sweeps,
            beta=float(beta), kernel_obj=kernel_obj,
        )
    with trace.span("solver.solve", n=n, impl=impl):
        res = _solve_bcd(Sigma, lam, beta, X0, max_sweeps, qp_sweeps, tol,
                         tau_iters, qp_impl)
        trace.device_sync(res.X)
    return res._replace(beta=float(beta))


def solve_bcd_with_history(Sigma, lam: float, *, beta: float | None = None,
                           max_sweeps: int = 20, qp_sweeps: int = 4,
                           tau_iters: int = 80) -> BCDResult:
    """Like ``solve_bcd`` but always runs all ``max_sweeps`` sweeps (a
    negative tol disables the early exit), so ``history`` has no nan."""
    return solve_bcd(Sigma, lam, beta=beta, max_sweeps=max_sweeps,
                     qp_sweeps=qp_sweeps, tau_iters=tau_iters, tol=-1.0)


def solve_bcd_many(
    Sigmas,
    lams,
    *,
    betas=None,
    X0s=None,
    max_sweeps: int = 20,
    qp_sweeps: int = 4,
    tol: float = 1e-7,
    tau_iters: int = 80,
    impl: str = "auto",
    devices: int = 0,
) -> list[BCDResult]:
    """Solve B independent problems of (possibly) different sizes in ONE
    batched launch (`ops.bcd_solve_batched`).

    ``Sigmas`` is a list of (n_b, n_b) tensors on one device, ``lams`` the
    per-problem penalties, ``X0s`` optional warm starts (None entries
    cold-start at the identity).  Problems are zero-padded to a common size
    with per-problem ``n_valid`` masks, so each result equals its
    standalone solve.  ``impl`` is the batched op's: 'auto' | 'cuda' |
    'ref'.
    """
    if devices and devices > 1:
        raise NotImplementedError(
            "devices > 1 (the sharded device grid) is not ported yet: "
            "ROADMAP queue 1 item 12")
    B = len(Sigmas)
    if B == 0:
        return []
    dtype, dev = Sigmas[0].dtype, Sigmas[0].device
    sizes = [int(S.shape[0]) for S in Sigmas]
    n_pad = max(sizes)
    if betas is None:
        betas = [None] * B
    betas = [default_beta(S) if b is None else float(b)
             for S, b in zip(Sigmas, betas)]
    if X0s is None:
        X0s = [None] * B
    Sp = torch.zeros((B, n_pad, n_pad), dtype=dtype, device=dev)
    Xp = torch.zeros_like(Sp)
    for k, (S, n) in enumerate(zip(Sigmas, sizes)):
        Sp[k, :n, :n] = S
        if X0s[k] is None:
            Xp[k, :n, :n] = torch.eye(n, dtype=dtype, device=dev)
        else:
            Xp[k, :n, :n] = torch.as_tensor(X0s[k], dtype=dtype, device=dev)
    from ..kernels import ops as kernel_ops

    with trace.span("solver.solve_many", batch=B, n_pad=n_pad, impl=impl):
        X, kernel_objs, sweeps, hist = kernel_ops.bcd_solve_batched(
            Sp, lams, betas, Xp, sizes, max_sweeps=max_sweeps,
            qp_sweeps=qp_sweeps, tol=tol, tau_iters=tau_iters, impl=impl,
        )
        trace.device_sync(X)
    out: list[BCDResult] = []
    for k, n in enumerate(sizes):
        Xk = X[k, :n, :n]
        Zk = Xk / torch.trace(Xk)
        lam_k = torch.tensor(float(lams[k]), dtype=dtype, device=dev)
        beta_k = torch.tensor(betas[k], dtype=dtype, device=dev)
        out.append(BCDResult(
            X=Xk, Z=Zk, obj=augmented_objective(Xk, Sigmas[k], lam_k, beta_k),
            phi=primal_value(Zk, Sigmas[k], lam_k), history=hist[k],
            sweeps=sweeps[k], beta=betas[k], kernel_obj=kernel_objs[k],
        ))
    return out


def observe_result_health(res: BCDResult, *, max_sweeps: int
                          ) -> tuple[bool, bool]:
    """Numerical-health monitor over a `BCDResult`: a non-finite objective
    (the kernel's ``kernel_obj`` when present, else ``obj``) means the
    solve produced garbage; ``sweeps == max_sweeps`` means the early exit
    never fired (a stall).  Increments ``solver.nonfinite`` /
    ``solver.stalled`` and returns ``(nonfinite, stalled)``."""
    obj = res.kernel_obj if res.kernel_obj is not None else res.obj
    nonfinite = not np.isfinite(float(obj))
    stalled = int(res.sweeps) >= int(max_sweeps)
    if nonfinite:
        metrics.counter("solver.nonfinite").inc()
    if stalled:
        metrics.counter("solver.stalled").inc()
    return nonfinite, stalled


def solve_bcd_supervised(
    Sigma,
    lam: float,
    *,
    beta: float | None = None,
    max_sweeps: int = 20,
    qp_sweeps: int = 4,
    tol: float = 1e-7,
    tau_iters: int = 80,
    X0=None,
    qp_impl: str = "jnp",
    solver_impl: str = "jnp",
    fallback: bool = True,
    debris_dir: str | None = None,
) -> tuple[BCDResult, int]:
    """`solve_bcd` under the fallback ladder: when the FUSED path reports a
    non-finite objective or a max-sweeps stall, re-solve the same problem
    on the whole-matrix program (``solver.fallbacks``, a ``solver.fallback``
    span).  Non-finite on both paths raises `SolverDivergenceError` after
    dumping its repro bundle to ``debris_dir``.  Returns ``(result,
    fallbacks_taken)``."""
    res = solve_bcd(
        Sigma, lam, beta=beta, max_sweeps=max_sweeps, qp_sweeps=qp_sweeps,
        tol=tol, tau_iters=tau_iters, X0=X0, qp_impl=qp_impl,
        solver_impl=solver_impl,
    )
    nonfinite, stalled = observe_result_health(res, max_sweeps=max_sweeps)
    n = int(Sigma.shape[0])
    impl = _resolve_solver_impl(solver_impl, Sigma.device)
    fallbacks = 0
    if (nonfinite or stalled) and fallback and impl in ("fused", "fused_ref"):
        fallbacks = 1
        metrics.counter("solver.fallbacks").inc()
        with trace.span("solver.fallback", n=n,
                        reason="nonfinite" if nonfinite else "stall"):
            res = solve_bcd(
                Sigma, lam, beta=beta, max_sweeps=max_sweeps,
                qp_sweeps=qp_sweeps, tol=tol, tau_iters=tau_iters, X0=X0,
                qp_impl=qp_impl, solver_impl="jnp",
            )
        nonfinite, _ = observe_result_health(res, max_sweeps=max_sweeps)
    if nonfinite:
        metrics.counter("solver.divergence").inc()
        path = None
        if debris_dir:
            path = _dump_debris(debris_dir, Sigma=Sigma, lam=lam, X0=X0,
                                n_valid=None)
        raise SolverDivergenceError(
            f"solve diverged on every path (n={n}, lam={float(lam):.6g}"
            + (f"; repro bundle at {path}" if path else ")"),
            lam=float(lam), n=n, debris_path=path,
        )
    return res, fallbacks


def supervise_many(
    results: list[BCDResult],
    Sigmas,
    lams,
    *,
    X0s=None,
    max_sweeps: int = 20,
    qp_sweeps: int = 4,
    tol: float = 1e-7,
    tau_iters: int = 80,
    fallback: bool = True,
    debris_dir: str | None = None,
) -> tuple[list[BCDResult], int]:
    """The fallback ladder over a batched round: re-solve each unhealthy
    result individually on the whole-matrix program.  Returns the patched list
    and the number of fallbacks taken; non-finite on both paths raises
    `SolverDivergenceError`."""
    out = list(results)
    n_fallbacks = 0

    def diverged(k, msg):
        metrics.counter("solver.divergence").inc()
        n_k = int(Sigmas[k].shape[0])
        path = None
        if debris_dir:
            path = _dump_debris(
                debris_dir, Sigma=Sigmas[k], lam=lams[k],
                X0=None if X0s is None else X0s[k], n_valid=None,
                tag="batched",
            )
        return SolverDivergenceError(
            f"batched solve {k} {msg} (n={n_k}, lam={float(lams[k]):.6g}"
            + (f"; repro bundle at {path}" if path else ")"),
            lam=float(lams[k]), n=n_k, debris_path=path,
        )

    for k, res in enumerate(out):
        nonfinite, stalled = observe_result_health(res, max_sweeps=max_sweeps)
        if not (nonfinite or stalled):
            continue
        if not fallback:
            if nonfinite:
                raise diverged(k, "diverged")
            continue
        n_fallbacks += 1
        metrics.counter("solver.fallbacks").inc()
        n_k = int(Sigmas[k].shape[0])
        with trace.span("solver.fallback", n=n_k, batch_index=k,
                        reason="nonfinite" if nonfinite else "stall"):
            patched = solve_bcd(
                Sigmas[k], lams[k], beta=res.beta, max_sweeps=max_sweeps,
                qp_sweeps=qp_sweeps, tol=tol, tau_iters=tau_iters,
                X0=None if X0s is None else X0s[k], solver_impl="jnp",
            )
        still_bad, _ = observe_result_health(patched, max_sweeps=max_sweeps)
        if still_bad:
            raise diverged(k, "diverged on every path")
        out[k] = patched
    return out, n_fallbacks


def leading_sparse_component(Z, *, rel_tol: float = 1e-2):
    """The sparse PC from the DSPCA solution: the leading eigenvector of Z,
    entries below ``rel_tol * max|x|`` zeroed, unit norm, and the
    largest-|entry| positive."""
    _, V = torch.linalg.eigh(Z)
    x = V[:, -1]
    thresh = rel_tol * torch.max(torch.abs(x))
    x = torch.where(torch.abs(x) > thresh, x, torch.zeros_like(x))
    norm = torch.linalg.norm(x)
    x = x / torch.where(norm > 0, norm, torch.ones_like(norm))
    imax = torch.argmax(torch.abs(x))
    return x * torch.sign(x[imax])
