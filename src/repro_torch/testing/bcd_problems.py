"""BCD problems made from a numpy seed, shared by ``chip_smoke.py`` (the
kernel against its plain version on the card) and the CPU tests (the
plain version against the reference's oracle), so that both hold the same
case to the same bound.
"""
from __future__ import annotations

import numpy as np

# The unstructured early-exit case: ``covariance_problems(
# np.random.default_rng(0), [40], 128)`` solved with these settings.  At
# qp_sweeps=2 each box QP is solved inexactly, F is not monotone over the
# sweeps and the trajectory is chaotic: two faithful float64
# implementations (the reference's oracle and the port's plain version)
# agree in F to ``agree_rtol`` over the first ``agree_sweeps`` sweeps, then
# drift apart about tenfold a sweep, to |dX| ~ 3e-2 by sweep 20
# (tests/test_torch_kernels_ref.py shows it).  The kernel is held to what
# two implementations can share: F over the first sweeps and the sweep
# count.
CHAOTIC = dict(sizes=[40], n_pad=128, seed=0, max_sweeps=20, qp_sweeps=2,
               tol=1e-6, agree_sweeps=6, agree_rtol=1e-9)


def covariance_problems(rng, sizes, n_pad, dtype=np.float64, spike=False):
    """Zero-padded Gaussian covariances on the leading ``sizes[b]``
    coordinates of (B, n_pad, n_pad), identity starts, and per-problem
    ``lam`` (0.3 of the largest variance) and ``beta``; ``spike`` plants a
    5-word direction, on which BCD converges.  Returns ``(S, X0, lams,
    betas)``."""
    B = len(sizes)
    S = np.zeros((B, n_pad, n_pad), dtype)
    X0 = np.zeros_like(S)
    lams, betas = [], []
    for b, nv in enumerate(sizes):
        F = rng.normal(size=(nv + 12, nv))
        if spike:
            F[:, :5] += 2.0 * rng.normal(size=(nv + 12, 1))
        C = F.T @ F / (nv + 12)
        S[b, :nv, :nv] = C
        X0[b, :nv, :nv] = np.eye(nv)
        lams.append(0.3 * float(C.diagonal().max()))
        betas.append(1e-4 * float(np.trace(C)) / nv)
    return S, X0, lams, betas
