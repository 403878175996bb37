"""The port's streaming leg (``repro_torch.data.bow``, ``data.pipeline``,
``sparse.engine``, the store branch of ``core.spca``) against the
reference's, on one store and the same megabatches, on the CPU.

Tolerances, each for its reason:
  * screen (sums, means, variances), 1e-12 relative: the corpus holds
    integer counts, so every per-megabatch sum is exact in float32 on both
    sides and only the final float64 divisions round;
  * Gram / Sigma_hat in float64, 1e-6 of its largest entry: the
    per-megabatch B^T B is a float32 product on both sides, in another
    order (scipy's spgemm in float64 rounded to float32 there, a float32
    BLAS product here);
  * Gram in float32 + Neumaier, 1e-6 of its largest entry: the same
    product, folded with compensation on both sides;
  * supports and counters: exact.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SPCAConfig as JCfg
from repro.core import elimination as jelim
from repro.core import fit_components as jfit
from repro.data import bow as jbow
from repro.data.corpus import make_corpus
from repro.sparse import engine as jengine
from repro.sparse import write_corpus
from repro_torch.core import SPCAConfig as TCfg
from repro_torch.core import elimination as telim
from repro_torch.core import fit_components as tfit
from repro_torch.data import bow as tbow
from repro_torch.data.pipeline import prefetch
from repro_torch.obs import metrics, trace
from repro_torch.sparse import engine as tengine
from repro_torch.sparse.store import SparseCorpus

GEOM = dict(chunk_nnz=1024, chunk_rows=64)
C = 4


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    corpus = make_corpus(900, 2500, topics={"t": ["a", "b", "c"]}, seed=3)
    path = str(tmp_path_factory.mktemp("store") / "csr")
    write_corpus(corpus, path, shard_nnz=20_000)
    s = SparseCorpus.open(path)
    assert s.n_chunks(**GEOM) % C, "the last megabatch must be ragged"
    return corpus, s


def _support(corpus, k=60):
    _, var = corpus.column_stats_exact()
    return np.sort(np.argsort(-var, kind="stable")[:k])


def _rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1e-300, np.abs(want).max()))


def _feed(store, accs, *, chunks=False):
    """The same batches into every accumulator, each batch while it is
    still current in the store's buffer ring."""
    if chunks:
        for ch in store.iter_chunks(**GEOM):
            for a in accs:
                a.update_csr(ch)
        return
    for mb in store.iter_megabatches(megabatch=C, **GEOM):
        for a in accs:
            a.update_csr_batch(mb)


@pytest.mark.parametrize("leg", ["megabatch", "chunk"])
def test_streaming_stats_matches_reference(store, leg):
    corpus, s = store
    t = tbow.StreamingStats(s.n_cols, device="cpu")
    j = jbow.StreamingStats(s.n_cols)
    _feed(s, [t, j], chunks=leg == "chunk")
    assert t.count == j.count == corpus.n_docs
    _rel(t.sum.numpy(), j.sum, 1e-12)
    _rel(t.sumsq.numpy(), j.sumsq, 1e-12)
    for center in (True, False):
        ts, js = t.finalize(center=center), j.finalize(center=center)
        _rel(ts.variances.numpy(), js.variances, 1e-12)
        _rel(ts.means.numpy(), js.means, 1e-12)
        assert ts.count == int(js.count)
    mean, var = corpus.column_stats_exact()
    _rel(t.finalize().variances.numpy(), var, 1e-12)


@pytest.mark.parametrize("acc", ["float32", "float64"])
@pytest.mark.parametrize("leg", ["megabatch", "chunk"])
def test_streaming_gram_matches_reference(store, acc, leg):
    corpus, s = store
    support = _support(corpus)
    t = tbow.StreamingGram(support, chunk_rows=GEOM["chunk_rows"],
                           acc_dtype=getattr(torch, acc), device="cpu")
    j = jbow.StreamingGram(support, chunk_rows=GEOM["chunk_rows"],
                           acc_dtype=getattr(np, acc))
    assert (t._err is None) == (acc == "float64") == (j._err is None)
    _feed(s, [t, j], chunks=leg == "chunk")
    assert t.count == j.count == corpus.n_docs
    mean, _ = corpus.column_stats_exact()
    got, want = t.finalize(means=mean), j.finalize(means=mean)
    _rel(got, want, 1e-6)
    A = corpus.columns_dense(support).astype(np.float64)
    A -= A.mean(0)
    _rel(got, A.T @ A / corpus.n_docs, 1e-6)
    assert t.state_signature() == j.state_signature()


def test_streaming_gram_f32_accumulation_is_compensated():
    acc = tbow.StreamingGram(np.arange(3), device="cpu")
    acc._acc(torch.full((3, 3), 1e8))
    for _ in range(1000):
        acc._acc(torch.ones(3, 3))      # each add is below f32's step at 1e8
    acc.count = 1
    np.testing.assert_allclose(acc.finalize(), 1e8 + 1000.0, rtol=1e-9)
    assert float(acc.g[0, 0]) == 1e8    # the uncompensated sum lost them


def test_merge_of_host_slices_matches_one_pass_and_reference(store):
    corpus, s = store
    support = _support(corpus, 40)
    mean, _ = corpus.column_stats_exact()
    one = tbow.StreamingGram(support, chunk_rows=64, device="cpu")
    stats_one = tbow.StreamingStats(s.n_cols, device="cpu")
    _feed(s, [one, stats_one])
    parts, jparts, sparts = [], [], []
    for h in range(2):
        p = tbow.StreamingGram(support, chunk_rows=64, device="cpu")
        jp = jbow.StreamingGram(support, chunk_rows=64, acc_dtype=np.float32)
        sp = tbow.StreamingStats(s.n_cols, device="cpu")
        for mb in s.iter_megabatches(megabatch=C, host_id=h, num_hosts=2,
                                     **GEOM):
            for a in (p, jp, sp):
                a.update_csr_batch(mb)
        parts.append(p)
        jparts.append(jp)
        sparts.append(sp)
    pooled = parts[0].merge(parts[1])
    jpooled = jparts[0].merge(jparts[1])
    _rel(pooled.finalize(means=mean), one.finalize(means=mean), 1e-6)
    _rel(pooled.finalize(means=mean), jpooled.finalize(means=mean), 1e-6)
    spooled = sparts[0].merge(sparts[1])
    _rel(spooled.sum.numpy(), stats_one.sum.numpy(), 1e-12)
    assert spooled.count == stats_one.count == corpus.n_docs
    with pytest.raises(AssertionError):
        parts[0].merge(tbow.StreamingGram(support[:5], device="cpu"))


def test_state_dict_round_trips_and_crosses_to_reference(store):
    corpus, s = store
    support = _support(corpus, 30)
    g = tbow.StreamingGram(support, chunk_rows=64, device="cpu")
    st = tbow.StreamingStats(s.n_cols, device="cpu")
    _feed(s, [g, st])
    g2 = tbow.StreamingGram(support, chunk_rows=64,
                            device="cpu").load_state(g.state_dict())
    np.testing.assert_array_equal(g2.finalize(), g.finalize())
    st2 = tbow.StreamingStats(s.n_cols, device="cpu").load_state(
        st.state_dict())
    np.testing.assert_array_equal(st2.sum.numpy(), st.sum.numpy())
    assert st2.count == st.count
    # the same host arrays restore the reference's accumulators
    jg = jbow.StreamingGram(support, chunk_rows=64, acc_dtype=np.float32)
    jg.load_state(g.state_dict())
    np.testing.assert_array_equal(jg.finalize(), g.finalize())
    assert jg.state_signature() == g.state_signature()
    js = jbow.StreamingStats(s.n_cols).load_state(st.state_dict())
    np.testing.assert_array_equal(js.sum, st.sum.numpy())
    assert js.state_signature() == st.state_signature()


def test_combine_screens_matches_reference():
    rng = np.random.default_rng(0)
    parts = [(rng.normal(size=50), rng.random(50), int(c))
             for c in (120, 0, 37, 900)]
    t = telim.combine_screens([
        telim.Screen(torch.from_numpy(v), torch.from_numpy(m), c)
        for m, v, c in parts])
    j = jelim.combine_screens([
        jelim.Screen(jnp.asarray(v), jnp.asarray(m), np.asarray(c))
        for m, v, c in parts])
    assert t.count == int(j.count) == 1057
    _rel(t.means.numpy(), j.means, 1e-12)
    _rel(t.variances.numpy(), j.variances, 1e-12)
    with pytest.raises(ValueError):
        telim.combine_screens([])


def test_prefetch_propagates_worker_error_and_keeps_order():
    def src():
        yield from range(3)
        raise KeyError("reader failed")

    got = []
    with pytest.raises(KeyError, match="reader failed"):
        for x in prefetch(src(), size=2):
            got.append(x)
    assert got == [0, 1, 2]
    stats = {}
    assert list(prefetch(iter(range(7)), size=1, stats=stats)) == list(range(7))
    assert stats["items"] == 7


def test_prefetch_abandonment_closes_the_source():
    released = threading.Event()

    def src():
        try:
            yield from range(1000)
        finally:
            released.set()

    g = prefetch(src(), size=2)
    assert next(g) == 0
    g.close()
    assert released.wait(timeout=5.0)


def test_engine_propagates_a_reader_error(store):
    _, s = store
    with pytest.raises(ValueError, match="chunk_nnz"):
        tengine.sparse_feature_variances(s, chunk_nnz=8, chunk_rows=64,
                                         device="cpu")


def test_sparse_stats_counters_equal_reference(store):
    corpus, s = store
    kw = dict(megabatch=C, **GEOM)
    tc, jc = {}, {}
    with metrics.use_registry() as reg, trace.enable() as tr:
        tvar, tbuild = tengine.sparse_stats(s, counters=tc, device="cpu",
                                            acc_dtype=torch.float64, **kw)
        jvar, jbuild = jengine.sparse_stats(s, counters=jc, **kw)
        support = _support(corpus, 50)
        S_t, S_j = tbuild(support), jbuild(support)
        assert reg.value("ingest.screen_launches") == tc["screen_launches"]
        assert reg.value("ingest.gram_launches") == tc["gram_launches"]
        assert reg.value("kernel.launches.csr_column_stats") \
            == tc["screen_launches"]
        assert reg.value("kernel.launches.csr_gram_batched") \
            == tc["gram_launches"]
        assert len(tr.find("ingest.megabatch")) == 2 * tc["screen_launches"]
        assert len(tr.find("ingest.screen_pass")) == 1
    ints = {k: v for k, v in jc.items() if not k.startswith("prefetch_")}
    assert {k: tc[k] for k in ints} == ints
    assert tc["screen_launches"] == -(-s.n_chunks(**GEOM) // C)
    assert set(tc) == set(jc)
    assert tvar.dtype == np.float64 and S_t.dtype == torch.float64
    _rel(tvar, jvar, 1e-12)
    _rel(S_t.numpy(), S_j, 1e-6)
    # the launcher's float32 arithmetic (x64 off in the reference)
    var32, build32 = tengine.sparse_stats(s, device="cpu", **kw)
    assert var32.dtype == np.float32
    S32 = build32(support)
    assert S32.dtype == torch.float32
    _rel(S32.numpy(), S_j, 1e-6)


def test_multi_host_screen_pools_like_reference(store):
    """Two host slices, each a partial screen, pooled by combine_screens:
    the single pass's screen, and the reference's pooled one."""
    _, s = store
    kw = dict(megabatch=C, **GEOM)
    ctr = {}
    one = tengine.sparse_feature_variances(s, device="cpu",
                                           acc_dtype=torch.float64, **kw)
    two = tengine.sparse_feature_variances(s, num_hosts=2, counters=ctr,
                                           device="cpu",
                                           acc_dtype=torch.float64, **kw)
    ref2 = jengine.sparse_feature_variances(s, num_hosts=2, **kw)
    assert two.count == one.count == int(ref2.count)
    for got, want in ((two.variances, one.variances),
                      (two.means, one.means)):
        _rel(got.numpy(), want.numpy(), 1e-12)
    _rel(two.variances.numpy(), ref2.variances, 1e-12)
    _rel(two.means.numpy(), ref2.means, 1e-12)
    assert ctr["screen_passes"] == 1
    assert ctr["chunks"] == s.n_chunks(**GEOM)


def test_resume_counters_equal_reference(store, tmp_path):
    """Both packages' ``sparse_stats`` with a resume root: the same
    checkpoint tallies on a clean run, and on a re-run the same resumed
    megabatches with zero chunks streamed, the results unchanged."""
    corpus, s = store
    kw = dict(megabatch=C, checkpoint_every=3, **GEOM)
    support = _support(corpus, 50)
    runs = {}
    for name, eng, extra in (
            ("ref", jengine, {}),
            ("port", tengine, dict(device="cpu", acc_dtype=torch.float64))):
        rd = str(tmp_path / name)
        got = []
        for _ in range(2):
            ctr = {}
            var, build = eng.sparse_stats(s, counters=ctr, resume_dir=rd,
                                          **kw, **extra)
            S = build(support)
            got.append((ctr, np.asarray(var), np.asarray(S)))
        runs[name] = got
    for i in range(2):
        (tc, tv, tS), (jc, jv, jS) = runs["port"][i], runs["ref"][i]
        ints = {k: v for k, v in jc.items() if not k.startswith("prefetch_")}
        assert {k: tc.get(k) for k in ints} == ints
        _rel(tv, jv, 1e-12)
        _rel(tS, jS, 1e-6)
    second = runs["port"][1][0]
    assert second.get("chunks", 0) == 0
    assert second["resumed_megabatches"] == 2 * -(-s.n_chunks(**GEOM) // C)
    np.testing.assert_array_equal(runs["port"][1][1], runs["port"][0][1])
    np.testing.assert_array_equal(runs["port"][1][2], runs["port"][0][2])


def test_fit_from_store_is_two_passes_with_reference_supports(store):
    corpus, s = store
    kw = dict(max_sweeps=6, lam_search_evals=5, megabatch_chunks=C, **GEOM)
    td, jd = {}, {}
    with trace.enable() as tr:
        t0 = time.perf_counter()
        tr_ = tfit(s, 3, target_card=4, cfg=TCfg(**kw), diagnostics=td,
                   device="cpu")
        assert time.perf_counter() - t0 < 120
        builds = tr.find("cov.build")
        assert len(builds) == 1
        assert [c.name for c in builds[0].children] == ["ingest.gram_pass"]
    jr = jfit(s, 3, target_card=4, cfg=JCfg(**kw), diagnostics=jd)
    assert [r.support.tolist() for r in tr_] == [r.support.tolist()
                                                 for r in jr]
    assert td["corpus_passes"] == jd["corpus_passes"] == 2
    assert td["cov_builds"] == jd["cov_builds"] == 1
    assert td["resumed_megabatches"] == 0
    for k in ("screen_launches", "gram_launches", "chunks", "screen_passes",
              "gram_passes"):
        assert td["ingest"][k] == jd["ingest"][k], k
    with pytest.raises(ValueError, match="project"):
        tfit(s, 1, cfg=TCfg(**kw), deflation="project", device="cpu")
