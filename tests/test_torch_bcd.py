"""The port's solver layer (``repro_torch.core``: bcd, validate,
elimination) against ``repro.core`` on the same numpy inputs, in float64.

The 'jnp' program runs the same IEEE operations as the reference's except
the reductions and the LU inside slogdet/inv, whose order differs by a
few ulps: iterates and objectives are compared to 1e-10, supports exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcd as jbcd
from repro.core import elimination as jelim
from repro.core import validate as jval
from repro_torch.core import bcd as tbcd
from repro_torch.core import elimination as telim
from repro_torch.core import validate as tval
from repro_torch.obs import metrics


def _cov(n, seed, spike=True):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n + 12, n))
    if spike:                      # a planted sparse direction
        F[:, :4] += 2.0 * rng.normal(size=(n + 12, 1))
    return F.T @ F / (n + 12)


def _lam(S):
    return 0.3 * float(S.diagonal().max())


@pytest.mark.parametrize("n", [12, 40])
def test_solve_bcd_jnp_program_matches_reference(n):
    S = _cov(n, seed=n)
    kw = dict(max_sweeps=6, qp_sweeps=3, tol=1e-9)
    j = jbcd.solve_bcd(jnp.asarray(S), _lam(S), **kw)
    t = tbcd.solve_bcd(torch.tensor(S), _lam(S), **kw)
    assert int(t.sweeps) == int(j.sweeps)
    assert t.beta == pytest.approx(j.beta, rel=1e-14)
    for name in ("X", "Z", "obj", "phi", "history"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)


def test_solve_bcd_warm_start_and_fused_ref_match_reference():
    S = _cov(24, seed=5)
    X0 = np.eye(24) + 0.01 * np.ones((24, 24))
    kw = dict(max_sweeps=4, qp_sweeps=2, tol=1e-9, solver_impl="fused_ref")
    j = jbcd.solve_bcd(jnp.asarray(S), _lam(S), X0=jnp.asarray(X0), **kw)
    t = tbcd.solve_bcd(torch.tensor(S), _lam(S), X0=torch.tensor(X0), **kw)
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), rtol=1e-10,
                               atol=1e-10)
    assert float(t.kernel_obj) == pytest.approx(float(j.kernel_obj), rel=1e-10)
    assert float(t.obj) == pytest.approx(float(j.obj), rel=1e-10)


@pytest.mark.parametrize("R2,c", [(0.7, -1.3), (2.5, 0.4), (0.0, -5.0),
                                  (1e-6, 3.0)])
def test_solve_tau_matches_reference(R2, c):
    beta = 1e-4
    want = float(jbcd.solve_tau(jnp.float64(R2), jnp.float64(c),
                                jnp.float64(beta)))
    assert tbcd.solve_tau(R2, c, beta) == want


def test_qp_coordinate_descent_matches_reference():
    S = _cov(16, seed=9)
    j = 3
    mask = np.ones(16)
    mask[j] = 0
    Y = S * mask[:, None] * mask[None, :]
    s = S[:, j] * mask
    u, w, R2 = tbcd.qp_coordinate_descent(torch.tensor(Y), torch.tensor(s),
                                          0.2, torch.tensor(s), j, 4)
    ju, jw, jR2 = jbcd.qp_coordinate_descent(jnp.asarray(Y), jnp.asarray(s),
                                             0.2, jnp.asarray(s), j, 4)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-12,
                               atol=1e-12)
    assert float(R2) == pytest.approx(float(jR2), rel=1e-12)


def test_solve_bcd_many_matches_reference():
    Ss = [_cov(n, seed=n) for n in (10, 24, 17)]
    lams = [_lam(S) for S in Ss]
    X0s = [None, np.eye(24) * 0.5, None]
    kw = dict(max_sweeps=3, qp_sweeps=2, tol=1e-8)
    j = jbcd.solve_bcd_many([jnp.asarray(S) for S in Ss], lams,
                            X0s=[None if x is None else jnp.asarray(x)
                                 for x in X0s], impl="ref", **kw)
    t = tbcd.solve_bcd_many([torch.tensor(S) for S in Ss], lams,
                            X0s=[None if x is None else torch.tensor(x)
                                 for x in X0s], impl="ref", **kw)
    for a, b in zip(t, j):
        assert int(a.sweeps) == int(b.sweeps)
        assert a.beta == pytest.approx(b.beta, rel=1e-14)
        for name in ("X", "obj", "phi", "history", "kernel_obj"):
            np.testing.assert_allclose(getattr(a, name).numpy(),
                                       np.asarray(getattr(b, name)),
                                       rtol=1e-10, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_leading_sparse_component_and_kkt_gap_match_reference(seed):
    S = _cov(20, seed=seed)
    res = jbcd.solve_bcd(jnp.asarray(S), _lam(S), max_sweeps=8, tol=1e-10)
    X, Z = np.asarray(res.X), np.asarray(res.Z)
    jx = np.asarray(jbcd.leading_sparse_component(jnp.asarray(Z)))
    tx = tbcd.leading_sparse_component(torch.tensor(Z)).numpy()
    assert np.array_equal(np.flatnonzero(jx), np.flatnonzero(tx))
    np.testing.assert_allclose(tx, jx, atol=1e-10)
    jg = jval.kkt_gap(jnp.asarray(X), jnp.asarray(S), _lam(S), res.beta)
    tg = tval.kkt_gap(torch.tensor(X), torch.tensor(S), _lam(S), res.beta)
    for a, b in zip(tg, jg):
        assert float(a) == pytest.approx(float(b), rel=1e-8, abs=1e-10)
    assert float(tval.duality_gap(torch.tensor(Z), torch.tensor(S), _lam(S))) \
        == pytest.approx(float(jval.duality_gap(jnp.asarray(Z),
                                                jnp.asarray(S), _lam(S))),
                         rel=1e-10)
    assert tval.cardinality(torch.tensor(tx)) == jval.cardinality(jnp.asarray(jx))
    assert tval.is_psd(torch.tensor(X)) == jval.is_psd(jnp.asarray(X))


def test_elimination_matches_reference():
    rng = np.random.default_rng(3)
    A = rng.poisson(2.0 / np.arange(1, 61) ** 0.8, size=(300, 60)).astype(float)
    js = jelim.feature_variances(jnp.asarray(A))
    ts = telim.feature_variances(torch.tensor(A))
    np.testing.assert_allclose(ts.variances.numpy(), np.asarray(js.variances),
                               rtol=1e-12, atol=1e-14)
    v = np.asarray(js.variances)
    for lam in (0.0, float(np.median(v)), float(v.max()) * 2):
        for cap in (None, 5):
            assert np.array_equal(telim.select_support(v, lam, cap),
                                  jelim.select_support(v, lam, cap))
        assert np.array_equal(telim.safe_support(v, lam),
                              jelim.safe_support(v, lam))
    assert telim.lam_for_target_size(v, 7) == jelim.lam_for_target_size(v, 7)


def _stalling_problem():
    S = _cov(12, seed=2)
    return torch.tensor(S), _lam(S)


def test_supervised_fallback_counts_and_matches_whole_matrix_program():
    """A stalled fused solve (max_sweeps too small for the early exit) is
    re-solved on the 'jnp' program, counted as a fallback."""
    S, lam = _stalling_problem()
    kw = dict(max_sweeps=2, qp_sweeps=2, tol=1e-12)
    with metrics.use_registry() as reg:
        res, fb = tbcd.solve_bcd_supervised(S, lam, solver_impl="fused_ref",
                                            **kw)
        assert fb == 1 and reg.value("solver.fallbacks") == 1
        assert reg.value("solver.stalled") == 2       # both paths stalled
    plain = tbcd.solve_bcd(S, lam, solver_impl="jnp", **kw)
    assert res.kernel_obj is None
    assert torch.equal(res.X, plain.X)


def test_supervised_divergence_raises_with_debris(tmp_path):
    S, lam = _stalling_problem()
    S = S.clone()
    S[0, 0] = float("nan")
    with metrics.use_registry() as reg:
        with pytest.raises(tbcd.SolverDivergenceError) as ei:
            tbcd.solve_bcd_supervised(S, lam, solver_impl="fused_ref",
                                      max_sweeps=2, qp_sweeps=1,
                                      debris_dir=str(tmp_path))
        assert reg.value("solver.divergence") == 1
    bundle = np.load(ei.value.debris_path)
    assert set(bundle.files) == {"Sigma_hat", "lam", "X0", "n_valid"}


def test_auto_resolves_by_device():
    assert tbcd._resolve_solver_impl("auto", "cpu") == "jnp"
    assert tbcd._resolve_solver_impl("auto", "cuda") == "fused"
    assert tbcd._resolve_solver_impl("fused_ref", "cuda") == "fused_ref"
    with pytest.raises(ValueError):
        tbcd._resolve_solver_impl("pallas", "cpu")


@pytest.mark.parametrize("n", [8, 20])
def test_solve_bcd_per_row_path_matches_reference(n):
    """``qp_impl='pallas'`` on the 'jnp' program: one ``ops.qp_sweeps``
    call a row update (the reference's per-row kernel, interpret mode),
    float64, to the 'jnp' program's bound."""
    S = _cov(n, seed=3 * n)
    kw = dict(max_sweeps=4, qp_sweeps=3, tol=1e-9, qp_impl="pallas",
              solver_impl="jnp")
    j = jbcd.solve_bcd(jnp.asarray(S), _lam(S), **kw)
    with metrics.use_registry() as reg:
        t = tbcd.solve_bcd(torch.tensor(S), _lam(S), **kw)
        assert reg.value("kernel.launches.qp_sweeps") == int(t.sweeps) * n
    assert int(t.sweeps) == int(j.sweeps)
    for name in ("X", "obj", "phi", "history"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)


def test_supervised_per_row_fallback_keeps_qp_impl():
    """A stalled fused solve's re-solve runs the 'jnp' program with the
    caller's ``qp_impl``: the per-row path, counted by its dispatches."""
    S, lam = _stalling_problem()
    kw = dict(max_sweeps=2, qp_sweeps=2, tol=1e-12)
    with metrics.use_registry() as reg:
        res, fb = tbcd.solve_bcd_supervised(S, lam, solver_impl="fused_ref",
                                            qp_impl="pallas", **kw)
        assert fb == 1
        assert reg.value("kernel.launches.qp_sweeps") == 2 * 12
    plain = tbcd.solve_bcd(S, lam, solver_impl="jnp", **kw)
    assert torch.equal(res.X, plain.X)


@pytest.mark.parametrize("solve", [tbcd.solve_bcd, tbcd.solve_bcd_supervised])
def test_unknown_qp_impl_is_a_value_error(solve):
    S, lam = _stalling_problem()
    with pytest.raises(ValueError, match="unknown qp_impl 'palas'"):
        solve(S, lam, qp_impl="palas")
