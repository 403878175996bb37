"""The lambda-grid probe of the port (``repro_torch.core.bcd.solve_bcd_grid``
and ``spca._grid_probe_bracket`` / ``search_lambda(lam_grid_probe=...)``)
against ``repro.core``, float64 on the CPU.  Inputs are numpy arrays from
a seed, given to both packages."""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SPCAConfig as JConfig
from repro.core import search_lambda as jsearch
from repro.core import spca as jspca
from repro.core.bcd import solve_bcd_grid as jgrid
from repro.kernels import ref as jref
from repro_torch.core import SPCAConfig as TConfig
from repro_torch.core import search_lambda as tsearch
from repro_torch.core import spca as tspca
from repro_torch.core.bcd import solve_bcd, solve_bcd_grid
from repro_torch.obs import metrics


def _sigma16():
    rng = np.random.default_rng(2)
    n = 16
    F = rng.normal(size=(n + 8, n))
    return (F.T @ F) / n


def _planted(m=1500, n=250, seed=4, k=4, boost=6.0):
    """The reference driver test's planted corpus (its ``_planted``)."""
    rng = np.random.default_rng(seed)
    base = 0.5 / np.arange(1, n + 1) ** 1.1
    X = rng.poisson(base[None, :] * 8, size=(m, n)).astype(np.float64)
    topics = [list(range(i * k, (i + 1) * k)) for i in range(3)]
    seg = m // 3
    for t, words in enumerate(topics):
        X[t * seg:(t + 1) * seg, words] += rng.poisson(boost, size=(seg, k))
    return X


LAMS = [0.3, 0.8, 1.5]


def test_solve_bcd_grid_matches_reference():
    """The whole-matrix program a lambda (the CPU's 'auto'): X to 1e-9,
    phi to 1e-8, the same sweeps and beta."""
    S = _sigma16()
    want = jgrid(jnp.asarray(S), LAMS, max_sweeps=15, tol=1e-12)
    got = solve_bcd_grid(torch.tensor(S), LAMS, max_sweeps=15, tol=1e-12)
    assert got.beta == pytest.approx(want.beta, rel=1e-15)
    assert got.X.shape == (3, 16, 16) and got.history.shape == (3, 15)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), atol=1e-9)
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(want.phi),
                               atol=1e-8)
    np.testing.assert_array_equal(got.sweeps.numpy(), np.asarray(want.sweeps))
    # the history is the augmented objective, as the reference's
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history),
                               atol=1e-8, equal_nan=True)
    # and each grid member is the single solve at the grid's beta
    for i, lam in enumerate(LAMS):
        single = solve_bcd(torch.tensor(S), lam, beta=got.beta, max_sweeps=15,
                           tol=1e-12)
        np.testing.assert_allclose(got.X[i].numpy(), single.X.numpy(),
                                   atol=1e-12)


def test_solve_bcd_grid_fused_ref_is_one_batched_dispatch():
    """impl='fused_ref' stacks the shared Sigma and runs the batched op
    once (the card runs K1 there): equal to the reference's batched plain
    version on the stacked problem."""
    S = _sigma16()
    n, B = S.shape[0], len(LAMS)
    c0 = metrics.counter("kernel.launches.bcd_solve_batched").value
    got = solve_bcd_grid(torch.tensor(S), LAMS, beta=1e-3, max_sweeps=6,
                         tol=1e-10, impl="fused_ref")
    assert metrics.counter("kernel.launches.bcd_solve_batched").value == c0 + 1
    X, obj, sweeps, hist = jref.bcd_solve_batched_ref(
        jnp.asarray(np.broadcast_to(S, (B, n, n))), jnp.asarray(LAMS),
        jnp.full((B,), 1e-3), jnp.asarray(np.broadcast_to(np.eye(n), (B, n, n))),
        jnp.asarray(1e-10), jnp.full((B,), n, jnp.int32), max_sweeps=6)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(X), atol=1e-10)
    np.testing.assert_allclose(got.kernel_obj.numpy(), np.asarray(obj),
                               atol=1e-10)
    np.testing.assert_array_equal(got.sweeps.numpy(), np.asarray(sweeps))
    np.testing.assert_allclose(got.history.numpy(), np.asarray(hist),
                               atol=1e-10, equal_nan=True)
    assert got.beta == 1e-3


def test_grid_probe_bracket_matches_reference():
    X = _planted()
    Sigma = np.cov(X, rowvar=False, bias=True)[:40, :40]
    lo, hi = 0.05, float(np.max(np.diag(Sigma))) * 0.999
    for target in (3, 8):
        jcfg = JConfig(max_sweeps=12, lam_grid_probe=5)
        tcfg = TConfig(max_sweeps=12, lam_grid_probe=5)
        want = jspca._grid_probe_bracket(jnp.asarray(Sigma), lo, hi, target,
                                         jcfg)
        got = tspca._grid_probe_bracket(torch.tensor(Sigma), lo, hi, target,
                                        tcfg)
        assert got == pytest.approx(want, rel=1e-12)


def test_search_with_probe_matches_reference_and_keeps_support():
    X = _planted()
    cfg = dict(max_sweeps=12, lam_search_evals=8)
    jd, td, td0 = {}, {}, {}
    want = jsearch(X, 4, cfg=JConfig(**cfg, lam_grid_probe=5), diagnostics=jd)
    got = tsearch(X, 4, cfg=TConfig(**cfg, lam_grid_probe=5), diagnostics=td,
                  device="cpu")
    plain = tsearch(X, 4, cfg=TConfig(**cfg), diagnostics=td0, device="cpu")
    assert np.array_equal(got.support, want.support)
    assert got.lam == pytest.approx(want.lam, rel=1e-12)
    assert got.variance == pytest.approx(want.variance, abs=1e-6)
    assert td == jd
    assert td["solve_launches"] == td["evals"] + 1    # the probe's launch
    # the probe changes the bracket, never the answer
    assert np.array_equal(got.support, plain.support)
    assert td["evals"] <= td0["evals"]


def test_probe_size_guard_skips_the_probe():
    """Above ``grid_probe_max_n`` the probe neither builds nor solves."""
    X = _planted()
    cfg = TConfig(max_sweeps=6, lam_search_evals=3, lam_grid_probe=5,
                  grid_probe_max_n=8)
    d = {}
    tsearch(X, 4, cfg=cfg, diagnostics=d, device="cpu")
    jd = {}
    jsearch(X, 4, cfg=JConfig(**{k: getattr(cfg, k) for k in (
        "max_sweeps", "lam_search_evals", "lam_grid_probe",
        "grid_probe_max_n")}), diagnostics=jd)
    assert d == jd and d["solve_launches"] == d["evals"]


def test_probe_config_runs_through_fit():
    """``SPCAConfig(lam_grid_probe=8)`` is accepted by the whole fit."""
    from repro_torch.core import fit_components

    X = _planted(m=300, n=40)
    cfg = replace(TConfig(max_sweeps=3, lam_search_evals=2), lam_grid_probe=8)
    d = {}
    pcs = fit_components(X, 2, target_card=3, cfg=cfg, diagnostics=d,
                         device="cpu")
    assert len(pcs) == 2
    assert all(c["solve_launches"] == c["evals"] + 1 for c in d["components"])
