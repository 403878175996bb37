"""The port's dense row-block pipeline (``Corpus.batches``, the dense
``update`` legs of ``data.bow``, ``screen_and_gram_streaming``) and the
per-row solver path (``SPCAConfig.qp_impl='pallas'``) against the
reference's, on the same corpora, on the CPU.

Tolerances, each for its reason:
  * blocks, screen sums and counts: exact (the corpus holds integer
    counts, so every float32 block sum is exact on both sides and the
    float64 folds are the same additions);
  * means and variances, 1e-12 relative: only the final float64
    divisions round;
  * Gram / Sigma_hat, 1e-6 of the largest entry: float32 block products
    in another order (a BLAS product on both sides), then the float64 or
    compensated float32 fold;
  * supports: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SPCAConfig as JCfg
from repro.core import fit_components as jfit
from repro.core.elimination import lam_for_target_size
from repro.data import bow as jbow
from repro.data.corpus import make_corpus
from repro.sparse import write_corpus
from repro_torch.core import SPCAConfig as TCfg
from repro_torch.core import fit_components as tfit
from repro_torch.data import StreamingGram, StreamingStats
from repro_torch.data import corpus as tcorpus
from repro_torch.data import screen_and_gram_streaming
from repro_torch.obs import metrics
from repro_torch.sparse.store import SparseCorpus

GEOM = dict(chunk_nnz=1024, chunk_rows=64)
TOPICS = {"t": ["a", "b", "c"], "u": ["d", "e", "f"]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    corpus = make_corpus(700, 1500, topics=TOPICS, seed=5)
    path = str(tmp_path_factory.mktemp("store") / "csr")
    write_corpus(corpus, path, shard_nnz=20_000)
    return corpus, SparseCorpus.open(path)


def _rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1e-300, np.abs(want).max()))


def _support(corpus, k=40):
    _, var = corpus.column_stats_exact()
    return np.sort(np.argsort(-var, kind="stable")[:k])


@pytest.mark.parametrize("batch_docs", [64, 100, 700, 1000])
def test_corpus_batches_are_bit_identical(batch_docs):
    a = make_corpus(700, 900, topics=TOPICS, seed=3)
    b = tcorpus.make_corpus(700, 900, topics=TOPICS, seed=3)
    got, want = list(b.batches(batch_docs)), list(a.batches(batch_docs))
    assert len(got) == len(want) == -(-700 // batch_docs)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == np.float32
        assert np.array_equal(x, y)


def _stats_pair():
    return (StreamingStats(1500, device="cpu"), jbow.StreamingStats(1500))


def _same_stats(t, j):
    assert t.count == j.count
    assert np.array_equal(t.sum.numpy(), j.sum)
    assert np.array_equal(t.sumsq.numpy(), j.sumsq)
    ts, js = t.finalize(), j.finalize()
    _rel(ts.means.numpy(), js.means, 1e-12)
    _rel(ts.variances.numpy(), js.variances, 1e-12)


@pytest.mark.parametrize("leg", ["dense", "dense_tensor", "mixed"])
def test_stats_update_matches_reference(data, leg):
    """The dense leg alone (numpy or tensor blocks), and mixed with the
    CSR megabatch leg in one accumulator (the corpus through both)."""
    corpus, store = data
    t, j = _stats_pair()
    for b in corpus.batches(96):
        t.update(torch.from_numpy(b) if leg == "dense_tensor" else b)
        j.update(b)
    if leg == "mixed":
        for mb in store.iter_megabatches(megabatch=3, **GEOM):
            t.update_csr_batch(mb)
            j.update_csr_batch(mb)
        assert t.count == 2 * corpus.n_docs
    _same_stats(t, j)


def test_stats_merge_and_state_cross_packages(data):
    corpus, _ = data
    blocks = list(corpus.batches(96))
    half = len(blocks) // 2
    t1, j1 = _stats_pair()
    t2, _ = _stats_pair()
    for b in blocks[:half]:
        t1.update(b)
        j1.update(b)
    for b in blocks[half:]:
        t2.update(b)
    # the port's partial resumes in the reference and the reference's in
    # the port; the merged port accumulator equals both
    j_from_t, t_from_j = jbow.StreamingStats(1500), StreamingStats(
        1500, device="cpu")
    j_from_t.load_state(t2.state_dict())
    t_from_j.load_state(j1.state_dict())
    for b in blocks[:half]:
        j_from_t.update(b)
    for b in blocks[half:]:
        t_from_j.update(b)
    t1.merge(t2)
    assert t1.state_signature() == j1.state_signature()
    _same_stats(t1, j_from_t)
    _same_stats(t_from_j, j_from_t)


def _gram_pair(support, dtype):
    jd = np.float64 if dtype == torch.float64 else np.float32
    return (StreamingGram(support, acc_dtype=dtype, device="cpu"),
            jbow.StreamingGram(support, acc_dtype=jd))


def _same_gram(t, j, means):
    assert t.count == j.count
    _rel(t.finalize(means=means), j.finalize(means=means), 1e-6)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("leg", ["dense", "dense_tensor", "mixed"])
def test_gram_update_matches_reference(data, dtype, leg):
    corpus, store = data
    support = _support(corpus)
    means = corpus.column_stats_exact()[0]
    t, j = _gram_pair(support, dtype)
    with jax.enable_x64(dtype == torch.float64):
        for b in corpus.batches(96):
            t.update(torch.from_numpy(b) if leg == "dense_tensor" else b)
            j.update(b)
        if leg == "mixed":
            for mb in store.iter_megabatches(megabatch=3, **GEOM):
                t.update_csr_batch(mb)
                j.update_csr_batch(mb)
        _same_gram(t, j, means)
    assert t.g.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gram_merge_and_state_cross_packages(data, dtype):
    corpus, _ = data
    support = _support(corpus)
    blocks = list(corpus.batches(96))
    half = len(blocks) // 2
    with jax.enable_x64(dtype == torch.float64):
        t1, j1 = _gram_pair(support, dtype)
        t2, j_from_t = _gram_pair(support, dtype)
        t_from_j, _ = _gram_pair(support, dtype)
        for b in blocks[:half]:
            t1.update(b)
            j1.update(b)
        for b in blocks[half:]:
            t2.update(b)
        j_from_t.load_state(t2.state_dict())
        t_from_j.load_state(j1.state_dict())
        for b in blocks[:half]:
            j_from_t.update(b)
        for b in blocks[half:]:
            t_from_j.update(b)
        t1.merge(t2)
        assert t1.state_signature() == j1.state_signature()
        _same_gram(t1, j_from_t, None)
        _same_gram(t_from_j, j_from_t, None)


def test_gram_update_on_empty_support_counts_rows():
    t = StreamingGram(np.zeros(0, np.int64), device="cpu")
    with metrics.use_registry() as reg:
        t.update(np.ones((5, 9), np.float32))
        assert reg.value("kernel.launches.gram") == 0
    assert t.count == 5 and t.finalize().shape == (0, 0)


@pytest.fixture(scope="module")
def pipeline_corpus():
    corpus = make_corpus(2000, 5000, topics=TOPICS, seed=11)
    lam = lam_for_target_size(corpus.column_stats_exact()[1], 60)
    return corpus, lam


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_screen_and_gram_streaming_matches_reference(pipeline_corpus, dtype):
    """float64: the reference under x64; float32: with x64 off (the
    launcher's), where the screen is float32 and the Gram compensated."""
    corpus, lam = pipeline_corpus
    with jax.enable_x64(dtype == torch.float64):
        with metrics.use_registry() as reg:
            S, sup, scr = screen_and_gram_streaming(
                lambda: corpus.batches(256), corpus.n_words, lam,
                acc_dtype=dtype, device="cpu")
            launches = [reg.value(f"kernel.launches.{op}")
                        for op in ("column_stats", "gram")]
        jS, jsup, jscr = jbow.screen_and_gram_streaming(
            lambda: corpus.batches(256), corpus.n_words, lam)
        jvar = np.asarray(jscr.variances)
    assert launches == [8, 8]
    assert np.array_equal(sup, jsup) and sup.size >= 60
    assert scr.count == int(jscr.count) == 2000
    assert scr.variances.dtype == dtype and jvar.dtype == np.dtype(
        str(dtype).split(".")[-1])
    _rel(scr.variances.numpy(), jvar, 1e-12 if dtype == torch.float64
         else 1e-7)
    assert S.dtype == np.float64
    _rel(S, jS, 1e-6)
    # and both against the exact float64 covariance of the support
    A = corpus.columns_dense(sup).astype(np.float64)
    A -= A.mean(0)
    _rel(S, A.T @ A / corpus.n_docs, 1e-6)


def test_screen_and_gram_streaming_uncentred_and_tensor_blocks(
        pipeline_corpus):
    corpus, lam = pipeline_corpus
    S, sup, scr = screen_and_gram_streaming(
        lambda: (torch.from_numpy(b) for b in corpus.batches(300)),
        corpus.n_words, lam, center=False, acc_dtype=torch.float64,
        device="cpu")
    jS, jsup, jscr = jbow.screen_and_gram_streaming(
        lambda: corpus.batches(300), corpus.n_words, lam, center=False)
    assert np.array_equal(sup, jsup)
    assert not scr.means.any()
    _rel(S, jS, 1e-6)


def test_fit_with_per_row_solver_matches_reference():
    """``qp_impl='pallas'``: the 'jnp' program's per-row path (one
    ``ops.qp_sweeps`` call a row update; the reference's interpret-mode
    kernel): the same supports as the reference's, and on the CPU the
    very numbers of the port's own 'jnp' inner loop (the plain version
    is that loop)."""
    rng = np.random.default_rng(0)
    X = rng.poisson(1.0, size=(160, 24)).astype(np.float64)
    X[:80, :3] += rng.poisson(4.0, size=(80, 3))
    X[80:, 5:8] += rng.poisson(3.0, size=(80, 3))
    kw = dict(max_sweeps=3, lam_search_evals=3, solver_impl="jnp")
    with metrics.use_registry() as reg:
        got = tfit(X, 2, target_card=3, device="cpu",
                   cfg=TCfg(qp_impl="pallas", **kw))
        assert reg.value("kernel.launches.qp_sweeps") > 0
    plain = tfit(X, 2, target_card=3, device="cpu", cfg=TCfg(**kw))
    want = jfit(jnp.asarray(X), 2, target_card=3,
                cfg=JCfg(qp_impl="pallas", **kw))
    for g, p, w in zip(got, plain, want):
        assert g.support.tolist() == p.support.tolist() == w.support.tolist()
        assert g.lam == p.lam and g.variance == p.variance
        assert g.lam == pytest.approx(w.lam, rel=1e-10)
