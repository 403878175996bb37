"""Reference methods the paper positions itself against (port of
``repro.core.baselines``).

- ``pca_power``: classical leading-PC power iteration, O(n^2) (or O(nm)
  in data form) an iteration: the "PCA" side of the paper's "sparse PCA
  can be easier than PCA" comparison.
- ``thresholded_pca``: the ad-hoc simple-thresholding method [4] that
  DSPCA is shown to dominate in [1, 2, 11].

Plain torch on the device of the input.  The random start comes from a
`torch.Generator` seeded with ``seed``, so it differs from the
reference's ``jax.random.PRNGKey(seed)`` start: compare converged
eigenpairs (up to sign), not iterates.
"""
from __future__ import annotations

import torch

from ..device import as_tensor


def _start(n: int, like: torch.Tensor, seed: int) -> torch.Tensor:
    g = torch.Generator(device=like.device)
    g.manual_seed(int(seed))
    v = torch.randn(n, generator=g, dtype=like.dtype, device=like.device)
    return v / torch.linalg.norm(v)


def pca_power(Sigma, *, iters: int = 200, seed: int = 0, device=None):
    """Leading eigenvector by power iteration on an explicit covariance.
    Returns ``(v, v^T Sigma v)``."""
    Sigma = as_tensor(Sigma, device)
    v = _start(Sigma.shape[0], Sigma, seed)
    for _ in range(iters):
        w = Sigma @ v
        v = w / torch.linalg.norm(w)
    return v, v @ Sigma @ v


def pca_power_data(A, *, iters: int = 200, seed: int = 0, device=None):
    """Power iteration in data form, ``Sigma v = A^T (A v) / m`` centred,
    never forming the n x n covariance (the paper's point that even PCA
    needs care at n ~ 10^5).  Returns ``(v, v^T Sigma v)``."""
    A = as_tensor(A, device)
    m, n = A.shape
    mu = A.mean(dim=0)

    def matvec(v):
        Av = A @ v - torch.dot(mu, v)
        return (A.T @ Av - mu * Av.sum()) / m

    v = _start(n, A, seed)
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.linalg.norm(w)
    return v, v @ matvec(v)


def thresholded_pca(Sigma, k: int, *, iters: int = 200, device=None):
    """Keep the ``k`` largest-|.| entries of the leading eigenvector and
    renormalise.  Returns ``(x, x^T Sigma x)``."""
    Sigma = as_tensor(Sigma, device)
    v, _ = pca_power(Sigma, iters=iters)
    idx = torch.argsort(-v.abs())[:k]
    x = torch.zeros_like(v)
    x[idx] = v[idx]
    x = x / torch.linalg.norm(x)
    return x, x @ Sigma @ x
