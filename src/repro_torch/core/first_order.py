"""First-order DSPCA baseline (d'Aspremont, El Ghaoui, Jordan, Lanckriet
2007); port of ``repro.core.first_order``.

The paper's Fig. 1 compares Algorithm 1 against this method.  DSPCA's
dual is

    phi = min_U  lambda_max(Sigma + U)   s.t.  |U_ij| <= lam,

solved by Nesterov's smoothing: lambda_max is replaced by

    f_mu(U) = mu * log( sum_i exp(eig_i(Sigma+U)/mu) ) - mu*log(n)

whose gradient is the softmax-weighted eigenprojector, itself a feasible
primal point Z (PSD, trace 1), which is what the convergence plots
track.  Each iteration costs one eigendecomposition, O(n^3).  Plain
torch on the device of ``Sigma``: ``torch.linalg.eigh``, softmax and
logsumexp, no kernel.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import as_tensor
from .bcd import primal_value


class FirstOrderResult(NamedTuple):
    Z: torch.Tensor               # best feasible primal found
    U: torch.Tensor               # final dual point
    primal_history: np.ndarray    # per-iteration primal value phi(Z_k)
    dual_history: np.ndarray      # per-iteration lambda_max(Sigma + U_k)
    times: np.ndarray             # cumulative wall-clock seconds


def _smooth_value_grad(U, Sigma, mu):
    eigs, V = torch.linalg.eigh(Sigma + U)
    wts = torch.softmax(eigs / mu, dim=0)
    f = mu * torch.logsumexp(eigs / mu, dim=0)
    Z = (V * wts[None, :]) @ V.T
    return f, Z, eigs[-1]


def _fo_step(Uy, U_prev, k, Sigma, mu, lam, step):
    """One accelerated projected-gradient step on the box-constrained
    dual: step against the gradient Z (we minimise), project onto the
    symmetric box |U| <= lam, then Nesterov momentum."""
    _, Z, zmax = _smooth_value_grad(Uy, Sigma, mu)
    U = torch.clamp(Uy - step * Z, -lam, lam)
    U = 0.5 * (U + U.T)
    tk = (k + 1.0) / (k + 4.0)
    return U, U + tk * (U - U_prev), Z, zmax


def solve_first_order(Sigma, lam: float, *, max_iters: int = 500,
                      eps: float = 1e-3, record_every: int = 1,
                      device=None) -> FirstOrderResult:
    """Run the smoothed first-order method for ``max_iters`` iterations on
    ``Sigma`` (a tensor stays on its device; anything else goes to
    ``device``, the card by default), recording the primal and dual values
    every ``record_every`` iterations and at the last."""
    Sigma = as_tensor(Sigma, device)
    n = Sigma.shape[0]
    mu = eps / (2.0 * np.log(max(n, 2)))
    step = mu  # 1/L with L = 1/mu for the smoothed objective
    lam_t = torch.tensor(lam, dtype=Sigma.dtype, device=Sigma.device)
    U = torch.zeros_like(Sigma)
    Uy = U
    best_Z = torch.eye(n, dtype=Sigma.dtype, device=Sigma.device) / n
    best_p = -np.inf
    primal_hist, dual_hist, times = [], [], []
    t0 = time.perf_counter()
    for k in range(max_iters):
        U, Uy, Z, zmax = _fo_step(Uy, U, k, Sigma, mu, lam_t, step)
        if k % record_every == 0 or k == max_iters - 1:
            p = float(primal_value(Z, Sigma, lam_t))
            if p > best_p:
                best_p, best_Z = p, Z
            primal_hist.append(p)
            dual_hist.append(float(zmax))
            times.append(time.perf_counter() - t0)
    return FirstOrderResult(
        Z=best_Z, U=U, primal_history=np.asarray(primal_hist),
        dual_history=np.asarray(dual_hist), times=np.asarray(times))
