"""Plain reference of the sparse-PCA fit, in float64 numpy.

It works everything out again from the corpus the benchmark made: the
variance screen, the safe elimination of Thm 2.1 (Zhang & El Ghaoui,
2011) with the solver-size guard and the support buckets the
configuration states, the centred reduced Gram, and the DSPCA solve of
problem (6) by block coordinate ascent (Algorithm 1), run to convergence
rather than for a fixed number of sweeps.  It imports nothing of the
program and takes none of its tables.
"""
from __future__ import annotations

import numpy as np
from scipy import sparse


def column_moments(n_docs: int, n_words: int, word_idx, counts):
    """Per-word mean and (population) variance of a COO bag of words."""
    c = np.asarray(counts, np.float64)
    w = np.asarray(word_idx, np.int64)
    s = np.bincount(w, weights=c, minlength=n_words)
    ss = np.bincount(w, weights=c * c, minlength=n_words)
    mean = s / n_docs
    return mean, np.maximum(ss / n_docs - mean * mean, 0.0)


def screened_support(var, lam: float, mask, max_reduced: int,
                     buckets) -> np.ndarray:
    """The words a solve at ``lam`` keeps: those not deflated (``mask``)
    whose variance is at least ``lam`` (Thm 2.1; none left keeps the
    largest), at most ``max_reduced`` of them by variance, topped up to
    the next size in ``buckets`` with the largest-variance words left out
    (safe: their loadings are zero)."""
    v = np.where(mask, np.asarray(var, np.float64), -np.inf)
    keep = np.flatnonzero(v >= lam)
    if keep.size == 0:
        keep = np.array([int(np.argmax(v))])
    avail = np.flatnonzero(np.isfinite(v) & (v > 0))
    order = avail[np.argsort(-v[avail], kind="stable")]
    if keep.size > max_reduced:
        keep = np.sort(order[:max_reduced])
    target = next((int(b) for b in buckets if b >= keep.size), keep.size)
    target = min(target, max_reduced)
    if target > keep.size and order.size > keep.size:
        keep = np.union1d(keep, order[:min(target, order.size)])
    return keep


def columns(n_docs: int, n_words: int, doc_idx, word_idx, counts):
    """The bag of words as a (documents, words) float64 matrix stored by
    columns, so that a support's columns are read without a pass over
    every nonzero."""
    return sparse.csc_matrix(
        (np.asarray(counts, np.float64),
         (np.asarray(doc_idx, np.int64), np.asarray(word_idx, np.int64))),
        shape=(n_docs, n_words))


def centred_gram(cols, support) -> np.ndarray:
    """(A_S - mean)^T (A_S - mean) / m over the columns ``support`` of
    `columns`' matrix, as A_S^T A_S / m - mean mean^T, in float64."""
    A = cols[:, np.asarray(support, np.int64)]
    m = cols.shape[0]
    mean = np.asarray(A.sum(axis=0)).ravel() / m
    return (A.T @ A).toarray() / m - np.outer(mean, mean)


def barrier_weight(S: np.ndarray) -> float:
    """beta = 1e-4 Tr(Sigma) / n, the configuration's eps/n barrier."""
    return 1e-4 * float(np.trace(S)) / S.shape[0]


def _tau(R2: float, c: float, beta: float) -> float:
    """The positive root of tau + c - R2 / tau^2 - beta / tau (strictly
    increasing in tau), by bisection to the last bit."""
    lo, hi = 0.0, max(1.0, -c) + np.sqrt(max(R2, 0.0)) + beta + 1.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if mid in (lo, hi):
            break
        if mid + c - R2 / (mid * mid) - beta / mid < 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _box_qp(Y: np.ndarray, lo: np.ndarray, hi: np.ndarray, u: np.ndarray,
            passes: int) -> np.ndarray:
    """``passes`` passes of exact coordinate minimisation of u^T Y u over
    the box [lo, hi], from ``u`` clipped into it."""
    u = np.clip(u, lo, hi)
    w = Y @ u
    d = np.diagonal(Y).tolist()
    lo_l, hi_l, u_l = lo.tolist(), hi.tolist(), u.tolist()
    n = u.size
    for _ in range(passes):
        for i in range(n):
            if d[i] <= 0.0:
                continue
            new = min(max(u_l[i] - float(w[i]) / d[i], lo_l[i]), hi_l[i])
            step = new - u_l[i]
            if step != 0.0:
                w += step * Y[i]
                u_l[i] = new
    return np.asarray(u_l)


def objective(X: np.ndarray, S: np.ndarray, lam: float, beta: float) -> float:
    """Problem (6): Tr(S X) - lam ||X||_1 - (Tr X)^2 / 2 + beta logdet X."""
    sign, logdet = np.linalg.slogdet(X)
    if sign <= 0:
        return -np.inf
    tr = np.trace(X)
    return float(np.sum(S * X) - lam * np.abs(X).sum() - 0.5 * tr * tr
                 + beta * logdet)


def solve_dspca(S: np.ndarray, lam: float, *, tol: float = 1e-9,
                max_sweeps: int = 300, qp_passes: int = 4) -> np.ndarray:
    """X maximising problem (6) at ``lam`` on the covariance ``S``, by
    block coordinate ascent from the identity: each row and column in
    turn takes ``qp_passes`` coordinate passes over its box QP (11), from
    where its last sweep left it, and solves its 1-D problem in tau, until
    a sweep changes the objective by at most ``tol`` (1 + |objective|)."""
    S = np.asarray(S, np.float64)
    n = S.shape[0]
    beta = barrier_weight(S)
    X = np.eye(n)
    us = [None] * n
    prev = -np.inf
    for _ in range(max_sweeps):
        for j in range(n):
            rest = np.r_[0:j, j + 1:n]
            Y = X[np.ix_(rest, rest)]
            s = S[rest, j]
            u0 = s.copy() if us[j] is None else us[j]
            u = _box_qp(Y, s - lam, s + lam, u0, qp_passes)
            us[j] = u
            w = Y @ u
            c = S[j, j] - lam - np.trace(Y)
            tau = _tau(float(u @ w), c, beta)
            X[rest, j] = w / tau
            X[j, rest] = w / tau
            X[j, j] = c + tau
        obj = objective(X, S, lam, beta)
        if abs(obj - prev) <= tol * (1.0 + abs(obj)):
            break
        prev = obj
    return X


def leading_component(X: np.ndarray, rel_tol: float) -> np.ndarray:
    """The sparse component of a solution: the leading eigenvector of
    Z = X / Tr X, entries below ``rel_tol`` of its largest zeroed, unit
    norm, its largest entry positive."""
    _, V = np.linalg.eigh(X / np.trace(X))
    x = V[:, -1].copy()
    x[np.abs(x) <= rel_tol * np.abs(x).max()] = 0.0
    x /= np.linalg.norm(x)
    return x * np.sign(x[np.argmax(np.abs(x))])


def search_bracket(var, mask, target_card: int) -> tuple[float, float]:
    """The lambda search's first bracket: from 0.999 of the largest
    variance among the words left (``mask``) down to the variance at rank
    max(30 target_card, 100) of them."""
    v = np.asarray(var, np.float64)[np.asarray(mask, bool)]
    vs = np.sort(v[v > 0])[::-1]
    depth = min(max(30 * int(target_card), 100), vs.size)
    return float(vs[0]) * 0.999, float(max(vs[depth - 1], 1e-12))


def search_is_bisection(bracket, evals, target_card: int, card_slack: int,
                        max_evals: int, chosen_lam: float,
                        rel: float = 1e-9) -> bool:
    """Whether ``evals`` ((lambda, cardinality, variance) of each solve, in
    order) are the geometric bisection's from ``bracket`` given the
    cardinalities they found, and ``chosen_lam`` is the best of them.

    The bisection tries the geometric mean of its bracket, stops at a
    cardinality in [target_card, target_card + card_slack] or after
    ``max_evals`` tries, and otherwise raises the bracket's lower end
    when the solution is too dense and lowers its upper end when too
    sparse.  The best try has its cardinality in that window, else the
    closest to ``target_card``, and then the larger variance; the first
    of equals."""
    hi, lo = bracket
    best = None
    for i, (lam, card, var) in enumerate(evals):
        want = float(np.sqrt(lo * hi))
        if i >= max_evals or abs(lam - want) > rel * want:
            return False
        hit = target_card <= card <= target_card + card_slack
        key = (0 if hit else abs(card - target_card), -var)
        if best is None or key < best[0]:
            best = (key, lam)
        if hit:
            return i == len(evals) - 1 and best[1] == chosen_lam
        if card > target_card:
            lo = lam
        else:
            hi = lam
    return (len(evals) == max_evals and best is not None
            and best[1] == chosen_lam)
