"""Optimality certificates for DSPCA solutions (port of
``repro.core.validate``).

DSPCA (1) and its dual:

    phi  =  max_Z  Tr(Sigma Z) - lam ||Z||_1    s.t. Z PSD, Tr Z = 1
         =  min_U  lambda_max(Sigma + U)        s.t. |U_ij| <= lam

**KKT certificate (the strong one).**  At the optimum of the augmented
problem (6) the stationarity condition rearranges to the dual point

    U := (Tr X) I - beta X^{-1} - Sigma        (|U_ij| <= lam at optimum)

so after clipping U into the box, ``gap(X) = lambda_max(Sigma + clip(U))
- phi(X/TrX)`` is >= 0 and ~ O(beta n) at the solver's fixed point.

**Sign certificate (the weak one).**  U = -lam*sign(Z) is always dual
feasible and gives a valid upper bound from Z alone.
"""
from __future__ import annotations

import torch

from .bcd import primal_value


def kkt_gap(X, Sigma, lam, beta):
    """Strong certificate from the BCD iterate X of problem (6).

    Returns (gap, box_violation) as 0-d tensors: ``gap`` ~ O(beta*n) at the
    optimum; ``box_violation`` = max(|U|) - lam measures how exactly the
    stationarity conditions hold.  At small lambda X is nearly singular and
    the inverse is accurate only to cond(X)*eps, so a large violation flags
    certificate ill-conditioning, not solver failure."""
    n = X.shape[0]
    trX = torch.trace(X)
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    U = trX * eye - beta * torch.linalg.inv(X) - Sigma
    viol = torch.max(torch.abs(U)) - lam
    Uc = torch.clamp(U, -lam, lam)
    Uc = 0.5 * (Uc + Uc.T)
    ub = torch.linalg.eigvalsh(Sigma + Uc)[-1]
    Z = X / trX
    return ub - primal_value(Z, Sigma, lam), viol


def duality_gap(Z, Sigma, lam):
    """Weak (sign-based) certificate; valid upper bound, loose off-optimum."""
    return dual_upper_bound(Z, Sigma, lam) - primal_value(Z, Sigma, lam)


def dual_upper_bound(Z, Sigma, lam):
    U = -lam * torch.sign(Z)
    U = 0.5 * (U + U.T)
    return torch.linalg.eigvalsh(Sigma + U)[-1]


def is_psd(X, tol: float = 1e-8) -> bool:
    w = torch.linalg.eigvalsh(X)
    return bool(w[0] >= -tol * max(1.0, float(w[-1])))


def cardinality(x, rel_tol: float = 1e-3) -> int:
    """Number of entries of x above rel_tol * max|x|."""
    ax = torch.abs(torch.as_tensor(x))
    return int(torch.sum(ax > rel_tol * torch.max(ax)))


def explained_variance(x, Sigma) -> float:
    """x^T Sigma x for a unit vector x."""
    return float(x @ Sigma @ x)
