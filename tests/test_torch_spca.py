"""The port's driver (``repro_torch.core.spca``) against ``repro.core.spca``:
the same corpus and the same ``stats=`` pair in both packages, float64.
Supports must be identical, explained variance within 1e-6 (the bar the
reference's own driver tests use), lambdas and launch counts equal."""
import os
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SPCAConfig as JConfig
from repro.core import fit_components as jfit
from repro.core import search_lambda as jsearch
from repro.data.corpus import NYTIMES_TOPICS, make_corpus
from repro_torch import convert
from repro_torch.core import fit_components as tfit
from repro_torch.core import search_lambda as tsearch
from repro_torch.core.spca import SPCAConfig as TConfig
from repro_torch.data import corpus as tcorpus

DOCS, WORDS = 1500, 2000


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(DOCS, WORDS, topics=NYTIMES_TOPICS, seed=0)


def _stats(corpus, backend):
    _, var = corpus.column_stats_exact()

    def build(support):
        A = corpus.columns_dense(np.asarray(support)).astype(np.float64)
        A = A - A.mean(0, keepdims=True)
        G = (A.T @ A) / corpus.n_docs
        return jnp.asarray(G) if backend == "jax" else torch.tensor(G)

    return var, build


def _assert_same_fit(tres, jres, tdiag, jdiag):
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        assert np.array_equal(t.support, j.support)
        assert t.reduced_n == j.reduced_n
        assert t.lam == pytest.approx(j.lam, rel=1e-12)
        assert t.variance == pytest.approx(j.variance, abs=1e-6)
        assert t.sweeps == j.sweeps
        np.testing.assert_allclose(t.x, j.x, atol=1e-6)
    for key in ("solve_launches", "cov_builds", "cov_slices",
                "refine_launches", "solver_fallbacks"):
        assert tdiag[key] == jdiag[key], key
    for td, jd in zip(tdiag["components"], jdiag["components"]):
        for key in ("evals", "warm_starts", "total_sweeps", "solve_launches",
                    "batched", "fallbacks"):
            assert td[key] == jd[key], key


@pytest.mark.parametrize("batch_evals,batch_deflation", [(0, False), (4, False),
                                                         (4, True)])
def test_fit_components_matches_reference(corpus, batch_evals,
                                          batch_deflation):
    # max_reduced caps n_hat at 64 so the plain loops stay fast on the CPU
    jcfg = JConfig(max_sweeps=5, qp_sweeps=2, lam_search_evals=6,
                   max_reduced=64, batch_evals=batch_evals,
                   batch_deflation=batch_deflation)
    tcfg = convert.config_from_reference(asdict(jcfg))
    jd, td = {}, {}
    jres = jfit(None, 2, target_card=5, cfg=jcfg, stats=_stats(corpus, "jax"),
                diagnostics=jd)
    tres = tfit(None, 2, target_card=5, cfg=tcfg,
                stats=_stats(corpus, "torch"), diagnostics=td, device="cpu")
    _assert_same_fit(tres, jres, td, jd)
    # the first component holds a planted topic
    assert any(set(ids) <= set(tres[0].support)
               for ids in corpus.topics.values())


def test_fit_from_data_matrix_and_project_deflation_match_reference():
    rng = np.random.default_rng(1)
    base = 0.5 / np.arange(1, 121) ** 1.1
    X = rng.poisson(base[None, :] * 8, size=(600, 120)).astype(np.float64)
    X[:300, :4] += rng.poisson(6.0, size=(300, 4))
    X[300:, 4:8] += rng.poisson(6.0, size=(300, 4))
    for deflation in ("remove", "project"):
        cfg = dict(max_sweeps=5, lam_search_evals=5)
        jd, td = {}, {}
        jres = jfit(X, 2, target_card=4, cfg=JConfig(**cfg),
                    deflation=deflation,
                    diagnostics=jd if deflation == "remove" else None)
        tres = tfit(X, 2, target_card=4, cfg=TConfig(**cfg),
                    deflation=deflation, device="cpu",
                    diagnostics=td if deflation == "remove" else None)
        for t, j in zip(tres, jres):
            assert np.array_equal(t.support, j.support), deflation
            assert t.variance == pytest.approx(j.variance, abs=1e-6)
        if deflation == "remove":
            assert td["solve_launches"] == jd["solve_launches"]


def test_search_lambda_on_covariance_matches_reference(corpus):
    var, build = _stats(corpus, "jax")
    support = np.argsort(-var)[:40]
    S = np.asarray(build(np.sort(support)))
    cfg = dict(max_sweeps=5, qp_sweeps=2, lam_search_evals=6,
               support_bucketing=False)
    jd, td = {}, {}
    j = jsearch(S, 5, is_covariance=True, cfg=JConfig(**cfg), diagnostics=jd)
    t = tsearch(S, 5, is_covariance=True, cfg=TConfig(**cfg), diagnostics=td,
                device="cpu")
    assert np.array_equal(t.support, j.support)
    assert t.variance == pytest.approx(j.variance, abs=1e-6)
    assert td == jd


def test_corpus_copy_is_bit_identical():
    a = make_corpus(300, 900, topics=NYTIMES_TOPICS, seed=3)
    b = tcorpus.make_corpus(300, 900, topics=tcorpus.NYTIMES_TOPICS, seed=3)
    assert a.vocab == b.vocab and a.topics == b.topics
    for name in ("doc_idx", "word_idx", "counts"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    for x, y in zip(a.column_stats_exact(), b.column_stats_exact()):
        assert np.array_equal(x, y)
    ids = np.array([3, 50, 57, 400])
    assert np.array_equal(a.columns_dense(ids), b.columns_dense(ids))


@pytest.mark.parametrize("field,value", [
    ("mesh_devices", 2), ("lam_grid_probe", 4),
])
def test_unported_config_fields_raise(field, value):
    cfg = TConfig(**{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfit(np.eye(4), 1, target_card=1, cfg=cfg, device="cpu")


def test_unknown_qp_impl_is_a_value_error():
    with pytest.raises(ValueError, match="unknown qp_impl"):
        tfit(np.eye(4), 1, target_card=1, cfg=TConfig(qp_impl="pallsa"),
             device="cpu")


def test_store_handle_raises_not_ported(tmp_path):
    """A store handle fits out of core, with pass and fit checkpoints and
    the pass watchdog since the reliability slice (ROADMAP queue 1 item
    8); what it still refuses, naming the item that ports it, is the
    device mesh (item 12)."""
    from repro_torch.sparse import write_corpus

    store = write_corpus(tcorpus.make_corpus(300, 400, seed=1),
                         str(tmp_path / "s"))
    with pytest.raises(NotImplementedError, match="item 12"):
        tfit(store, 1, cfg=TConfig(mesh_devices=2), device="cpu")
    diag = {}
    rd = str(tmp_path / "ckpt")
    pcs = tfit(store, 1, target_card=3, diagnostics=diag, device="cpu",
               cfg=TConfig(max_sweeps=3, lam_search_evals=3, resume_dir=rd,
                           pass_deadline_s=600.0, solve_deadline_s=600.0))
    assert pcs[0].cardinality > 0 and diag["corpus_passes"] == 2
    kinds = sorted(name.rsplit("_", 1)[0] for name in os.listdir(rd))
    assert kinds == ["fit", "pass_gram", "pass_screen"]


def test_convert_from_reference_state():
    jcfg = JConfig(max_sweeps=3, batch_evals=4, support_buckets=(16, 32))
    S = np.eye(5) * 2.0
    st = convert.from_reference(asdict(jcfg), variances=np.diag(S),
                                Sigma_hat=S, X0=np.eye(5), device="cpu")
    assert asdict(st.cfg) == asdict(jcfg)
    assert st.Sigma_hat.dtype == torch.float64 and st.X0.shape == (5, 5)
    with pytest.raises(TypeError, match="not SPCAConfig fields"):
        convert.config_from_reference({"bogus": 1})
    jres = jsearch(S + 0.1, 1, is_covariance=True, cfg=JConfig(max_sweeps=2),
                   keep_reduced=True)
    pc = convert.pc_result_from_reference(asdict(jres), device="cpu")
    assert np.array_equal(pc.support, jres.support)
    assert isinstance(pc.X_reduced, torch.Tensor)
    np.testing.assert_array_equal(pc.X_reduced.numpy(),
                                  np.asarray(jres.X_reduced))


@pytest.mark.parametrize("solver_impl,impl", [
    ("auto", "auto"), ("jnp", "auto"), ("fused", "cuda"), ("fused_ref", "ref"),
])
def test_batched_rounds_take_the_op_default_for_jnp(solver_impl, impl):
    """A batched round has no whole-matrix program: 'jnp' takes the op's
    default (the kernel on the card), only 'fused_ref' the plain version."""
    from repro_torch.core.spca import _batched_impl

    assert _batched_impl(solver_impl) == impl


def test_divergence_carries_the_completed_components(corpus, monkeypatch):
    """A fit that diverges in its third component raises with the first
    two, equal to those of a two-component fit."""
    from repro_torch.core import bcd, spca

    stats = _stats(corpus, "torch")
    cfg = TConfig(max_sweeps=4, lam_search_evals=6)
    two = tfit(None, 2, target_card=5, cfg=cfg, stats=stats, device="cpu")
    search = spca.search_lambda
    calls = []

    def diverge_third(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise bcd.SolverDivergenceError("diverged", lam=1.0, n=32)
        return search(*args, **kw)

    monkeypatch.setattr(spca, "search_lambda", diverge_third)
    with pytest.raises(bcd.SolverDivergenceError) as e:
        tfit(None, 3, target_card=5, cfg=cfg, stats=stats, device="cpu")
    assert [r.support.tolist() for r in e.value.completed] == [
        r.support.tolist() for r in two]
