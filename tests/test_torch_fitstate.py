"""Whole-fit checkpoint/resume of the port (``repro_torch.core.fitstate``
wired into ``core.spca``) on the CPU, mirroring the reference's kill-and-
resume proofs (tests/test_fitstate.py) and crossing fit checkpoints
between the two packages.

Every kill is an injected launch failure (``dispatch_error`` at the
``bcd_solve`` / ``bcd_solve_batched`` site) or an expired watchdog,
never timing.  Tolerances, each for its reason:
  * the port's resumed fit equals the port's uninterrupted fit EXACTLY
    (supports, lambdas, variances): the cursor restores the bracket, the
    incumbent and the warm block unchanged, so the remaining evaluations
    run the same arithmetic;
  * against the reference's fit on the same input: supports equal,
    explained variance to 1e-6 relative in float64 (the two packages'
    solves round differently in the last bits).
A fit checkpoint crosses between the packages only when both fingerprint
the same variance bytes: it does for a covariance input and for a CSR
store in the launchers' float32 arithmetic (both screens fold the same
sums and round once), and it does NOT for a dense data matrix, whose
float64 variances the two packages reduce in different orders (ROADMAP
queue 3); the tests hold each case.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro import testing as jt
from repro.core import SPCAConfig as JCfg
from repro.core import fit_components as jfit
from repro.core import fitstate as jfitstate
from repro.core import spca as jspca
from repro.data.corpus import make_corpus
from repro.sparse import write_corpus
from repro_torch import testing as tt
from repro_torch.core import SPCAConfig as TCfg
from repro_torch.core import fit_components as tfit
from repro_torch.core import fitstate, spca as tspca
from repro_torch.obs import health, metrics
from repro_torch.sparse import SparseCorpus as TStore

TOPICS = {"t0": ["w0", "w1"], "t1": ["w2", "w3"], "t2": ["w4", "w5"]}


def _dense(n_docs=200, n_feat=40, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n_docs, n_feat))
    A[:, :5] += 3 * rng.standard_normal((n_docs, 1))
    return A


def _cov(seed=0):
    A = _dense(seed=seed)
    A = A - A.mean(0)
    return A.T @ A / A.shape[0]


def _kw(**kw):
    kw.setdefault("max_sweeps", 8)
    kw.setdefault("lam_search_evals", 6)
    kw.setdefault("solver_impl", "fused_ref")   # through the ops seam
    return kw


def _tfit(data, k, card, **kw):
    diag: dict = {}
    cov = kw.pop("is_covariance", False)
    res = tfit(data, k, target_card=card, cfg=TCfg(**_kw(**kw)),
               diagnostics=diag, device="cpu", is_covariance=cov)
    return res, diag


def _jfit(data, k, card, **kw):
    cov = kw.pop("is_covariance", False)
    return jfit(data, k, target_card=card, cfg=JCfg(**_kw(**kw)),
                is_covariance=cov)


def _same(resumed, clean):
    """Port against port: exact."""
    assert len(resumed) == len(clean)
    for r1, r0 in zip(resumed, clean):
        np.testing.assert_array_equal(r1.support, r0.support)
        assert (r1.lam, r1.variance) == (r0.lam, r0.variance)


def _like_reference(port, ref):
    assert len(port) == len(ref)
    for t, j in zip(port, ref):
        np.testing.assert_array_equal(t.support, j.support)
        np.testing.assert_allclose(t.variance, j.variance, rtol=1e-6)


def _kill(data, k, card, rule, **kw):
    inj = tt.SolverFaultInjector(rule)
    with tt.install_solver(inj), pytest.raises(tt.InjectedDispatchError):
        _tfit(data, k, card, **kw)
    assert inj.injected["dispatch"] == 1


# ------------------------------------------------------ fitstate mechanics


def test_codec_round_trips_nested_arrays(tmp_path):
    ck = fitstate.FitCheckpointer(str(tmp_path))
    fp = {"kind": "fit", "x": 1}
    ck.open(fp)
    comp = {"x": np.arange(5.0), "support": np.arange(5, dtype=np.int64),
            "lam": 0.25, "nested": {"Sigma": np.eye(3), "tag": "a"},
            "none": None, "flag": True, "scalar": np.float32(2.5)}
    ck.record_component(comp)
    ck.record_search({"k": 1, "evals": 1, "lo": 0.1, "hi": 0.9,
                      "done": False, "warm_X": np.ones((2, 2))})
    st = fitstate.FitCheckpointer(str(tmp_path)).open(fp)
    got = st.components[0]
    np.testing.assert_array_equal(got["x"], comp["x"])
    assert got["support"].dtype == np.int64 and got["scalar"] == 2.5
    np.testing.assert_array_equal(got["nested"]["Sigma"], np.eye(3))
    assert got["lam"] == 0.25 and got["none"] is None and got["flag"] is True
    assert st.search["evals"] == 1 and not st.complete
    with pytest.raises(TypeError, match="cannot serialize"):
        # tensors are the caller's to bring to the host first
        ck.record_component({"x": torch.ones(2)})


def test_fingerprint_guard_corruption_and_cadence(tmp_path):
    ck = fitstate.FitCheckpointer(str(tmp_path))
    fp = fitstate.fit_fingerprint(np.arange(10.0), n_components=2,
                                  target_card=4, deflation="remove",
                                  cfg=TCfg(**_kw()))
    json.dumps(fp)
    ck.open(fp)
    ck.record_component({"x": np.ones(3)})
    ck.finish()
    fp2 = fitstate.fit_fingerprint(np.arange(10.0), n_components=2,
                                   target_card=4, deflation="remove",
                                   cfg=TCfg(**_kw(lam_search_evals=7)))
    assert fp2 != fp
    assert fitstate.FitCheckpointer(str(tmp_path)).open(fp2).components == []
    st = fitstate.FitCheckpointer(str(tmp_path)).open(fp)
    assert st.complete and len(st.components) == 1
    tt.truncate_file(os.path.join(ck._dir(), fitstate.STATE_NAME), frac=0.3)
    assert fitstate.FitCheckpointer(str(tmp_path)).open(fp).components == []
    ck.clear()
    assert not os.path.exists(ck._dir())
    ck3 = fitstate.FitCheckpointer(str(tmp_path), every=3)
    ck3.open({"kind": "fit"})
    for e in range(1, 5):
        ck3.record_search({"k": 0, "evals": e, "done": False})
    assert ck3.saves == 1
    ck3.record_search({"k": 0, "evals": 5, "done": True})
    ck3.record_component({"x": np.ones(2)})
    assert ck3.saves == 3


@pytest.mark.parametrize("cfg_kw", [{}, dict(batch_evals=3,
                                             support_buckets=(16, 32))])
def test_fit_fingerprint_equals_the_references(cfg_kw):
    v = np.random.default_rng(0).random(50)
    kw = dict(n_components=3, target_card=5, deflation="remove")
    t = fitstate.fit_fingerprint(v, cfg=TCfg(**_kw(**cfg_kw)), **kw)
    j = jfitstate.fit_fingerprint(v, cfg=JCfg(**_kw(**cfg_kw)), **kw)
    assert t == j
    from repro.sparse.resume import _digest as jdigest
    from repro_torch.sparse.resume import _digest as tdigest
    assert tdigest(t) == jdigest(j)


# --------------------------------- kill & resume at the phase boundaries


def test_kill_mid_lambda_search_resumes_identically(tmp_path):
    A = _dense()
    clean, d0 = _tfit(A, 3, 5)
    rd = str(tmp_path / "resume")
    kill_at = d0["components"][0]["evals"] + 2
    _kill(A, 3, 5, tt.dispatch_error(n=kill_at, match="bcd_solve"),
          resume_dir=rd)
    with metrics.use_registry() as reg:
        resumed, diag = _tfit(A, 3, 5, resume_dir=rd)
        assert reg.value("fit.resume.loads") == 1
        assert reg.value("fit.resume.evals_skipped") \
            == diag["fit_resume"]["evals_skipped"] >= 1
    assert diag["fit_resume"]["components_restored"] == 1
    assert diag["components"][0]["restored"]
    assert diag["components"][0]["evals"] == 0
    _same(resumed, clean)
    _like_reference(resumed, _jfit(A, 3, 5))


def test_kill_between_components_resumes_identically(tmp_path):
    A = _dense()
    clean, d0 = _tfit(A, 2, 5)
    rd = str(tmp_path / "resume")
    kill_at = d0["components"][0]["evals"]
    _kill(A, 2, 5, tt.dispatch_error(n=kill_at, match="bcd_solve"),
          resume_dir=rd)
    resumed, diag = _tfit(A, 2, 5, resume_dir=rd)
    assert diag["fit_resume"]["components_restored"] == 1
    assert diag["fit_resume"]["evals_skipped"] == 0
    _same(resumed, clean)
    _like_reference(resumed, _jfit(A, 2, 5))


def test_kill_mid_batched_search_resumes_identically(tmp_path):
    A = _dense(seed=3)
    kw = dict(batch_evals=3, lam_search_evals=9)
    clean, d0 = _tfit(A, 2, 5, **kw)
    rounds0 = d0["components"][0]["solve_launches"]
    assert d0["components"][1]["solve_launches"] >= 2
    rd = str(tmp_path / "resume")
    _kill(A, 2, 5, tt.dispatch_error(n=rounds0 + 1,
                                     match="bcd_solve_batched"),
          resume_dir=rd, **kw)
    resumed, diag = _tfit(A, 2, 5, resume_dir=rd, **kw)
    assert diag["fit_resume"]["evals_skipped"] >= 1
    assert diag["components"][1]["batched"]
    _same(resumed, clean)
    _like_reference(resumed, _jfit(A, 2, 5, **kw))


def test_completed_fit_restores_with_zero_solver_work(tmp_path):
    A = _dense()
    rd = str(tmp_path / "resume")
    clean, _ = _tfit(A, 2, 5, resume_dir=rd)
    with metrics.use_registry() as reg:
        again, diag = _tfit(A, 2, 5, resume_dir=rd)
        assert reg.value("fit.resume.loads") == 1
        assert reg.value("fit.resume.components") == 2
        assert reg.value("kernel.launches.bcd_solve") == 0
    assert diag["fit_resume"]["components_restored"] == 2
    assert diag["solve_launches"] == 0 and diag["cov_builds"] == 0
    _same(again, clean)
    _like_reference(again, _jfit(A, 2, 5))


def test_streaming_fit_killed_mid_search_never_restreams(tmp_path):
    c = make_corpus(300, 400, topics=TOPICS, seed=0)
    path = str(tmp_path / "store")
    write_corpus(c, path, shard_nnz=1500)
    store = TStore.open(path)
    geo = dict(chunk_nnz=512, chunk_rows=64, megabatch_chunks=2,
               max_sweeps=6)
    clean, d0 = _tfit(store, 3, 4, **geo)
    assert d0["ingest"]["chunks"] > 0
    assert d0["components"][1]["evals"] >= 2
    rd = str(tmp_path / "resume")
    kill_at = d0["components"][0]["evals"] + 1
    _kill(store, 3, 4, tt.dispatch_error(n=kill_at, match="bcd_solve"),
          resume_dir=rd, checkpoint_every=1, **geo)
    resumed, diag = _tfit(store, 3, 4, resume_dir=rd, checkpoint_every=1,
                          **geo)
    fr = diag["fit_resume"]
    assert fr["components_restored"] == 1 and fr["evals_skipped"] >= 1
    assert diag["ingest"].get("chunks", 0) == 0
    assert diag["resumed_megabatches"] > 0
    _same(resumed, clean)
    from repro.sparse import SparseCorpus as JStore
    _like_reference(resumed, _jfit(JStore.open(path), 3, 4, **geo))


def test_solve_deadline_fires_after_a_checkpointed_eval(tmp_path):
    A = _dense()
    base, _ = _tfit(A, 1, 5)
    rd = str(tmp_path / "resume")
    with metrics.use_registry() as reg:
        with pytest.raises(health.SolveDeadlineError) as ei:
            _tfit(A, 1, 5, resume_dir=rd, solve_deadline_s=0.0)
        assert reg.value("watchdog.expired") == 1
    assert ei.value.what == "solve round"
    res, diag = _tfit(A, 1, 5, resume_dir=rd)
    assert diag["fit_resume"]["evals_skipped"] >= 1
    _same(res, base)


def test_resume_dir_places_fit_state_beside_pass_checkpoints(tmp_path):
    rd = str(tmp_path / "resume")
    _tfit(_dense(), 1, 5, resume_dir=rd)
    assert any(f.startswith("fit_") for f in os.listdir(rd))


# ------------------------------------------ fit checkpoints across packages


def _jkill(data, k, card, rule, **kw):
    inj = jt.SolverFaultInjector(rule)
    with jt.install_solver(inj), pytest.raises(jt.InjectedDispatchError):
        _jfit(data, k, card, **kw)


def test_reference_fit_checkpoint_resumes_in_the_port(tmp_path):
    S = _cov()
    d0: dict = {}
    clean = jfit(S, 3, target_card=5, cfg=JCfg(**_kw()), diagnostics=d0,
                 is_covariance=True)
    rd = str(tmp_path / "resume")
    _jkill(S, 3, 5, jt.dispatch_error(n=d0["components"][0]["evals"] + 2,
                                      match="bcd_solve"),
           resume_dir=rd, is_covariance=True)
    resumed, diag = _tfit(S, 3, 5, resume_dir=rd, is_covariance=True)
    assert diag["fit_resume"]["components_restored"] == 1
    assert diag["fit_resume"]["evals_skipped"] >= 1
    _like_reference(resumed, clean)


def test_port_fit_checkpoint_resumes_in_the_reference(tmp_path):
    S = _cov(seed=1)
    clean, d0 = _tfit(S, 3, 5, is_covariance=True)
    rd = str(tmp_path / "resume")
    _kill(S, 3, 5, tt.dispatch_error(n=d0["components"][0]["evals"] + 1,
                                     match="bcd_solve"),
          resume_dir=rd, is_covariance=True)
    diag: dict = {}
    resumed = jfit(S, 3, target_card=5, diagnostics=diag, is_covariance=True,
                   cfg=JCfg(**_kw(resume_dir=rd)))
    assert diag["fit_resume"]["components_restored"] == 1
    assert diag["fit_resume"]["evals_skipped"] >= 1
    _like_reference(clean, resumed)


def test_store_fit_checkpoint_crosses_packages(tmp_path):
    """Out of core, in the launchers' float32 arithmetic (the reference
    with x64 off, the port's default ``acc_dtype``), both screens fold the
    same sums and round once, so the variance bytes and the fingerprints
    agree: a completed reference fit restores in the port with no solver
    work.  (Under the tests' x64 the reference's screen is float64 and the
    port's store fit float32: a different fit, refused by design.)"""
    import jax

    from repro.sparse import SparseCorpus as JStore

    c = make_corpus(300, 400, topics=TOPICS, seed=0)
    path = str(tmp_path / "store")
    write_corpus(c, path, shard_nnz=1500)
    geo = dict(chunk_nnz=512, chunk_rows=64, megabatch_chunks=2,
               max_sweeps=6)
    rd = str(tmp_path / "resume")
    jax.config.update("jax_enable_x64", False)
    try:
        ref = _jfit(JStore.open(path), 2, 4, resume_dir=rd, **geo)
        jv, _ = jspca._as_stats(JStore.open(path), False, True,
                                JCfg(**_kw(**geo)))
    finally:
        jax.config.update("jax_enable_x64", True)
    tv, _ = tspca._as_stats(TStore.open(path), False, True, "cpu",
                            TCfg(**_kw(**geo)))
    assert np.asarray(jv).dtype == tv.dtype == np.float32
    assert np.array_equal(np.asarray(jv), tv)
    got, diag = _tfit(TStore.open(path), 2, 4, resume_dir=rd, **geo)
    assert diag["fit_resume"]["components_restored"] == 2
    assert diag["solve_launches"] == 0
    assert diag["ingest"].get("gram_passes", 0) == 0
    _like_reference(got, ref)


def test_dense_data_fit_checkpoint_does_not_cross(tmp_path):
    """For a dense data matrix the two packages' float64 variances differ
    in the last bits, so the fingerprints differ and the port starts a
    reference checkpoint's fit clean (ROADMAP queue 3): the result is the
    same fit, with nothing restored."""
    A = _dense()
    jv, _ = jspca._as_stats(A, False, True)
    tv, _ = tspca._as_stats(A, False, True, "cpu")
    assert not np.array_equal(np.asarray(jv), tv)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-13)
    rd = str(tmp_path / "resume")
    ref = _jfit(A, 2, 5, resume_dir=rd)
    got, diag = _tfit(A, 2, 5, resume_dir=rd)
    assert diag["fit_resume"]["components_restored"] == 0
    assert len([f for f in os.listdir(rd) if f.startswith("fit_")]) == 2
    _like_reference(got, ref)
