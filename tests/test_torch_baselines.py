"""The port's baselines and stragglers against ``repro``, float64 on the
CPU: the first-order DSPCA method (``core.first_order``), the PCA power
iterations and thresholded PCA (``core.baselines``), ``eliminate`` and
the NYTimes/PubMed-dimension corpora."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core.elimination import eliminate as jeliminate
from repro.core.first_order import solve_first_order as jfo
from repro.data import nytimes_like as j_nyt
from repro.data import pubmed_like as j_pub
from repro_torch.core import baselines as tbase
from repro_torch.core import eliminate as teliminate
from repro_torch.core import solve_bcd
from repro_torch.core import solve_first_order as tfo
from repro_torch.data import nytimes_like as t_nyt
from repro_torch.data import pubmed_like as t_pub


def _gaussian_cov(n, m, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(m, n))
    return (F.T @ F) / m


@pytest.mark.parametrize("n, m, seed, frac", [(20, 30, 2, 0.35),
                                              (40, 60, 5, 0.2)])
def test_first_order_histories_match_reference(n, m, seed, frac):
    Sigma = _gaussian_cov(n, m, seed)
    lam = frac * float(np.max(np.diag(Sigma)))
    want = jfo(jnp.asarray(Sigma), lam, max_iters=60, eps=1e-3)
    got = tfo(torch.tensor(Sigma), lam, max_iters=60, eps=1e-3)
    np.testing.assert_allclose(got.primal_history, want.primal_history,
                               atol=1e-8)
    np.testing.assert_allclose(got.dual_history, want.dual_history, atol=1e-8)
    np.testing.assert_allclose(got.Z.numpy(), np.asarray(want.Z), atol=1e-8)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), atol=1e-8)
    assert got.times.shape == want.times.shape


def test_first_order_sandwiches_bcd():
    """The reference's certificate (its ``test_bcd.py`` sandwich): the
    first-order dual bounds the BCD primal from above, its best primal
    from below."""
    Sigma = _gaussian_cov(20, 30, seed=2)
    lam = 0.35 * float(np.max(np.diag(Sigma)))
    res = solve_bcd(torch.tensor(Sigma), lam, beta=1e-7, max_sweeps=60,
                    tol=1e-13)
    fo = tfo(torch.tensor(Sigma), lam, max_iters=2000, eps=1e-3)
    assert float(res.phi) <= fo.dual_history.min() + 1e-4
    assert float(res.phi) >= fo.primal_history.max() - 1e-4


def _same_pair(got, want, tol=1e-8):
    """Eigenpairs equal up to the vector's sign."""
    v, lam = got[0].numpy(), float(got[1])
    w = np.asarray(want[0])
    assert lam == pytest.approx(float(want[1]), abs=tol)
    assert min(np.abs(v - w).max(), np.abs(v + w).max()) < 1e-6


def test_pca_power_matches_reference_and_eigh():
    Sigma = _gaussian_cov(30, 200, seed=7)
    got = tbase.pca_power(torch.tensor(Sigma), iters=400)
    _same_pair(got, jbase.pca_power(jnp.asarray(Sigma), iters=400))
    evals, evecs = torch.linalg.eigh(torch.tensor(Sigma))
    assert float(got[1]) == pytest.approx(float(evals[-1]), abs=1e-8)


def test_pca_power_data_matches_reference():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(120, 25)) + 3.0 * rng.normal(size=(120, 1)) \
        * rng.normal(size=(1, 25))
    got = tbase.pca_power_data(torch.tensor(A), iters=300)
    _same_pair(got, jbase.pca_power_data(jnp.asarray(A), iters=300))


@pytest.mark.parametrize("k", [3, 6])
def test_thresholded_pca_matches_reference(k):
    Sigma = _gaussian_cov(30, 200, seed=7)
    got = tbase.thresholded_pca(torch.tensor(Sigma), k, iters=400)
    want = jbase.thresholded_pca(jnp.asarray(Sigma), k, iters=400)
    _same_pair(got, want)
    assert int(torch.count_nonzero(got[0])) == k


def test_eliminate_matches_reference():
    rng = np.random.default_rng(1)
    A = rng.poisson(0.6, size=(80, 50)).astype(np.float64)
    for center in (True, False):
        jA, jsup, jscr = jeliminate(jnp.asarray(A), 0.5, center=center)
        tA, tsup, tscr = teliminate(torch.tensor(A), 0.5, center=center)
        np.testing.assert_array_equal(tsup, jsup)
        np.testing.assert_allclose(tA.numpy(), np.asarray(jA), atol=1e-12)
        np.testing.assert_allclose(tscr.variances.numpy(),
                                   np.asarray(jscr.variances), atol=1e-12)


@pytest.mark.parametrize("make", ["nytimes", "pubmed"])
def test_paper_sized_corpora_match_reference(make):
    t_make, j_make = {"nytimes": (t_nyt, j_nyt),
                      "pubmed": (t_pub, j_pub)}[make]
    got, want = t_make(200), j_make(200)
    assert (got.n_docs, got.n_words, got.nnz) == (want.n_docs, want.n_words,
                                                  want.nnz)
    np.testing.assert_array_equal(got.doc_idx, want.doc_idx)
    np.testing.assert_array_equal(got.word_idx, want.word_idx)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.topics == want.topics
