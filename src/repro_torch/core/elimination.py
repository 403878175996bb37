"""Safe feature elimination (Theorem 2.1 of Zhang & El Ghaoui, NIPS 2011).

Port of ``repro.core.elimination``.  Feature ``i`` can be *safely* removed
whenever ``Sigma_ii < lambda`` (eq. 3): then ``(a_i^T xi)^2 <= Sigma_ii <
lambda`` for every unit ``xi``, so the feature is absent from every
optimal support.  Supports are host-side ``np.ndarray``s (they drive
gather/bookkeeping, not device compute).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Screen(NamedTuple):
    """Result of the variance screen (tensors on the data's device)."""

    variances: torch.Tensor  # (n,) per-feature variance Sigma_ii
    means: torch.Tensor      # (n,) per-feature mean (0 when center=False)
    count: int               # number of observations m (an int, or an
                             # integer 0-d array whose dtype a registry keeps)


def feature_variances(A: torch.Tensor, *, center: bool = True) -> Screen:
    """Per-feature variances of a data matrix ``A`` of shape (m, n): the
    diagonal of ``(A - mu)^T (A - mu) / m`` (``center=True``) or of
    ``A^T A / m``."""
    m = A.shape[0]
    mean = A.mean(dim=0) if center else torch.zeros_like(A[0])
    sumsq = torch.sum(A * A, dim=0)
    var = sumsq / m - mean * mean
    return Screen(variances=torch.clamp(var, min=0.0), means=mean, count=m)


def _pooled_moments(w, means, variances):
    """Pooled mean/variance from per-partial fractional weights ``w`` (P,)
    and moments stacked along dim 0, on the partials' device."""
    mean = (w[:, None] * means).sum(0)
    # E[x^2] pooled, then recentred
    second = (w[:, None] * (means * means + variances)).sum(0)
    return mean, torch.clamp(second - mean * mean, min=0.0)


def combine_screens(partials: list[Screen]) -> Screen:
    """Merge partial screens (streaming host slices, shards) by the pooled
    formulas: the global mean/variance from each partial's ``mean_k,
    var_k, m_k``.  Counts pool as exact Python integers; the moments merge
    on the partials' device in one stacked reduction."""
    if not partials:
        raise ValueError("combine_screens needs at least one partial")
    counts = [int(p.count) for p in partials]
    m = sum(counts)
    m_eff = max(m, 1)
    means = torch.stack([torch.as_tensor(p.means) for p in partials])
    variances = torch.stack([torch.as_tensor(p.variances).to(means)
                             for p in partials])
    w = torch.tensor([c / m_eff for c in counts], dtype=means.dtype,
                     device=means.device)
    mean, var = _pooled_moments(w, means, variances)
    return Screen(variances=var, means=mean, count=m)


def select_support(variances, lam: float, max_reduced: int | None = None
                   ) -> np.ndarray:
    """The one support-selection policy every pipeline leg shares: the
    Thm 2.1 screen (``variances >= lam``); an empty survivor set falls back
    to the single largest-variance feature, and ``max_reduced`` keeps only
    the top-``max_reduced`` survivors by variance (sorted by index)."""
    v = np.asarray(variances)
    support = np.flatnonzero(v >= lam)
    if support.size == 0:
        support = np.array([int(np.argmax(v))])
    if max_reduced is not None and support.size > max_reduced:
        order = np.argsort(v[support])[::-1]
        support = np.sort(support[order[:max_reduced]])
    return support


def safe_support(variances, lam: float) -> np.ndarray:
    """Indices of features that survive the safe elimination test (eq. 3)."""
    return np.flatnonzero(np.asarray(variances) >= lam)


def reduced_covariance(A_red: torch.Tensor) -> torch.Tensor:
    """Covariance of the surviving features: Sigma_hat = A_red^T A_red / m."""
    return (A_red.T @ A_red) / A_red.shape[0]


def lam_for_target_size(variances, target_n: int) -> float:
    """Largest lambda that keeps at least ``target_n`` features."""
    v = np.sort(np.asarray(variances))[::-1]
    target_n = min(max(target_n, 1), v.size)
    return float(v[target_n - 1])
