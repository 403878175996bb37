"""The plain reference against brute force at tiny sizes (CPU)."""
import numpy as np
import pytest

from portbench.reference import spca as rf


def _bag(seed, m=40, n=30, density=0.25):
    rng = np.random.default_rng(seed)
    A = (rng.random((m, n)) < density) * rng.integers(1, 6, (m, n))
    d, w = np.nonzero(A)
    return A.astype(np.float64), d.astype(np.int32), w.astype(np.int32), \
        A[d, w].astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_column_moments_and_gram_match_dense(seed):
    A, d, w, c = _bag(seed)
    mean, var = rf.column_moments(A.shape[0], A.shape[1], w, c)
    np.testing.assert_allclose(mean, A.mean(0), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(var, A.var(0), rtol=1e-12, atol=1e-14)
    support = np.array([0, 3, 7, 11, 29])
    G = rf.centred_gram(rf.columns(A.shape[0], A.shape[1], d, w, c),
                        support)
    B = A[:, support] - A[:, support].mean(0)
    np.testing.assert_allclose(G, B.T @ B / A.shape[0], rtol=1e-12,
                               atol=1e-13)


def _support_brute(var, lam, mask, max_reduced, buckets):
    v = [(var[i] if mask[i] else -np.inf, i) for i in range(len(var))]
    keep = [i for vi, i in v if vi >= lam]
    if not keep:
        keep = [max(v)[1]]
    order = [i for vi, i in sorted(v, key=lambda t: (-t[0], t[1]))
             if np.isfinite(vi) and vi > 0]
    if len(keep) > max_reduced:
        keep = order[:max_reduced]
    target = min(next((b for b in buckets if b >= len(keep)), len(keep)),
                 max_reduced)
    if target > len(keep) and len(order) > len(keep):
        keep = set(keep) | set(order[:target])
    return sorted(keep)


@pytest.mark.parametrize("lam", [0.0, 0.3, 0.9, 5.0])
@pytest.mark.parametrize("max_reduced", [4, 100])
def test_screened_support_by_brute_force(lam, max_reduced):
    rng = np.random.default_rng(7)
    var = rng.random(40)
    mask = rng.random(40) > 0.2
    buckets = (2, 3, 5, 8, 13)
    got = rf.screened_support(var, lam, mask, max_reduced, buckets)
    assert got.tolist() == _support_brute(var, lam, mask, max_reduced,
                                          buckets)


def _spiked(seed, n=7, k=3):
    rng = np.random.default_rng(seed)
    v = np.zeros(n)
    v[:k] = 1.0 / np.sqrt(k)
    N = rng.standard_normal((n, n)) * 0.1
    return 4.0 * np.outer(v, v) + N @ N.T + 0.2 * np.eye(n)


@pytest.mark.parametrize("seed", [0, 1])
def test_each_sweep_raises_the_objective(seed):
    """Block coordinate ascent: problem (6) never falls from one sweep to
    the next, and the sweeps settle."""
    S = _spiked(seed)
    lam, beta = 0.3, rf.barrier_weight(S)
    vals = [rf.objective(rf.solve_dspca(S, lam, tol=0.0, max_sweeps=k),
                         S, lam, beta) for k in (1, 2, 4, 8, 16, 64)]
    assert all(b >= a - 1e-12 * abs(a) for a, b in zip(vals, vals[1:]))
    assert abs(vals[-1] - vals[-2]) < 1e-6 * abs(vals[-1])


def test_diagonal_covariance_gives_its_largest_axis():
    """With a diagonal Sigma the DSPCA solution is the axis of the
    largest variance, whatever lambda below it."""
    S = np.diag([0.5, 3.0, 1.0, 2.0, 0.1])
    for lam in (0.05, 0.5, 1.5):
        x = rf.leading_component(rf.solve_dspca(S, lam), 1e-2)
        assert np.flatnonzero(x).tolist() == [1]


def test_leading_component_recovers_the_spike():
    S = _spiked(3)
    x = rf.leading_component(rf.solve_dspca(S, 0.3), 1e-2)
    assert np.flatnonzero(x).tolist() == [0, 1, 2]
    assert abs(np.linalg.norm(x) - 1.0) < 1e-12
    assert x[np.argmax(np.abs(x))] > 0


def test_tau_is_the_root_of_its_derivative():
    for R2, c, beta in [(2.0, -1.0, 1e-3), (0.0, 3.0, 1e-4), (5.0, 0.5, 0.1)]:
        t = rf._tau(R2, c, beta)
        assert t > 0
        assert abs(t + c - R2 / t ** 2 - beta / t) < 1e-9 * (1 + abs(c))


def _bisect(card_of, lo, hi, target, slack, max_evals):
    """The search as its rule states it, on a cardinality function."""
    evals = []
    for _ in range(max_evals):
        lam = float(np.sqrt(lo * hi))
        card = card_of(lam)
        evals.append((lam, card, 1.0 / lam))
        if target <= card <= target + slack:
            break
        if card > target:
            lo = lam
        else:
            hi = lam
    return evals


def test_search_bracket_by_brute_force():
    v = np.linspace(0.01, 2.0, 400)
    mask = np.ones(400, bool)
    mask[-3:] = False
    hi, lo = rf.search_bracket(v, mask, 5)
    left = np.sort(v[:-3])[::-1]
    assert hi == pytest.approx(0.999 * left[0]) and lo == left[149]


@pytest.mark.parametrize("jump", [False, True])
def test_search_is_bisection_accepts_the_rule_and_refuses_departures(jump):
    # cardinality falls with lambda; with ``jump`` it skips the window
    def card_of(lam):
        c = int(40 / lam)
        return 4 if jump and 5 <= c <= 7 else c
    lo, hi = 0.5, 40.0
    evals = _bisect(card_of, lo, hi, 5, 2, 8)
    assert len(evals) == 8 if jump else 1 < len(evals) < 8
    best = min(evals, key=lambda e: (0 if 5 <= e[1] <= 7 else abs(e[1] - 5),
                                     -e[2]))
    ok = rf.search_is_bisection((hi, lo), evals, 5, 2, 8, best[0])
    assert ok
    # stopped after its first try, a try moved, another try kept
    assert not rf.search_is_bisection((hi, lo), evals[:1], 5, 2, 8,
                                      evals[0][0])
    moved = [(evals[0][0] * 1.01,) + evals[0][1:]] + evals[1:]
    assert not rf.search_is_bisection((hi, lo), moved, 5, 2, 8, best[0])
    other = next(e[0] for e in evals if e[0] != best[0])
    assert not rf.search_is_bisection((hi, lo), evals, 5, 2, 8, other)
    # one try too many
    assert not rf.search_is_bisection((hi, lo), evals, 5, 2,
                                      len(evals) - 1, best[0])
