"""The port's serving stack (``repro_torch.serve``) beside the reference's
(``repro.serve``) on the same packs and batches, on the CPU (the kernels'
plain versions): `TopicProjector`, `ModelRegistry`, `MicroBatcher` and
`DriftMonitor`.  Then the reference's own serving cases, run on the port:
hot-swap under concurrent lookups, rollback, corrupt-version skip, shed,
deadline, stop, and the one-shape contract (``trace_count == 1``).

Tolerances: scores rtol 1e-5, atol 1e-5 (float32 sums of up to ``cap``
terms in another order, the reference's own bar in
``tests/test_serve.py``); drift verdicts and ``offending`` exactly,
``max_ratio`` to 1e-5 relative (float32 column moments summed in another
order).  Registries hold float64 screens here, as the reference does under
the tests' x64; the launcher's float32 screen is covered by
``tests/test_torch_serve_topics.py``.
"""
import os
import tempfile
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.elimination import Screen as JScreen
from repro.core.spca import PCResult as JPCResult
from repro.data.corpus import make_corpus
from repro.serve import DriftMonitor as JDriftMonitor
from repro.serve import MicroBatcher as JMicroBatcher
from repro.serve import ModelRegistry as JModelRegistry
from repro.serve import TopicProjector as JTopicProjector
from repro.serve import pack_components as jpack
from repro_torch.convert import model_version_from_reference
from repro_torch.core.elimination import Screen
from repro_torch.core.spca import PCResult
from repro_torch.obs import metrics
from repro_torch.serve import (
    BatcherConfig, DriftMonitor, MicroBatcher, ModelRegistry, ProjectorPack,
    TopicProjector, pack_components,
)
from repro_torch.serve.batcher import RequestShed, RequestTimeout, _Request

TOL = dict(rtol=1e-5, atol=1e-5)


def _fake_components(n, k, card, seed=0, lam=1.0, cls=PCResult):
    rng = np.random.default_rng(seed)
    results = []
    used = rng.permutation(n)
    for c in range(k):
        sup = np.sort(used[c * card:(c + 1) * card])
        x = np.zeros(n)
        x[sup] = rng.normal(size=card)
        x /= np.linalg.norm(x)
        results.append(cls(x=x, support=sup, lam=lam + 0.1 * c, variance=1.0,
                           cardinality=card, reduced_n=card, gap=0.0))
    return results


def _screens(n, count, seed=0):
    """The same float64 training screen for both packages."""
    rng = np.random.default_rng(seed)
    var, mean = rng.uniform(0.5, 2.0, n), rng.uniform(0.0, 1.0, n)
    return (Screen(variances=torch.from_numpy(var),
                   means=torch.from_numpy(mean), count=count),
            JScreen(variances=jnp.asarray(var), means=jnp.asarray(mean),
                    count=jnp.asarray(count)))


def _projector(n, k, card, seed=0):
    return TopicProjector(pack_components(_fake_components(n, k, card, seed),
                                          n_features=n), device="cpu")


def _docs(X):
    return [(np.flatnonzero(x), x[np.flatnonzero(x)]) for x in X]


# --------------------------------------------------------------- projector
def test_projector_matches_reference_projector():
    n, k = 400, 3
    res = _fake_components(n, k, 6, seed=4)
    jres = _fake_components(n, k, 6, seed=4, cls=JPCResult)
    port = TopicProjector(pack_components(res, n_features=n), device="cpu")
    ref = JTopicProjector(jpack(jres, n_features=n), impl="ref")
    X = np.random.default_rng(0).poisson(0.4, size=(12, n)).astype(np.float32)
    got = port.project(X)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.project(X)), **TOL)
    np.testing.assert_allclose(port.project_docs(_docs(X)),
                               ref.project_docs(_docs(X)), **TOL)
    np.testing.assert_allclose(port.project_docs(_docs(X)), got.numpy(),
                               **TOL)
    top, mag = port.assign_topics(got)
    jtop, jmag = ref.assign_topics(np.asarray(ref.project(X)))
    np.testing.assert_array_equal(top, jtop)
    np.testing.assert_allclose(mag, jmag, **TOL)


def test_projector_sparse_doc_path_with_overlapping_supports():
    """'project' (Hotelling) deflation can give overlapping supports: a
    shared word must contribute to EVERY component that loads on it."""
    n, card = 100, 4
    rng = np.random.default_rng(5)
    shared = np.array([7, 42])
    results = []
    for c in range(3):
        extra = 50 + c * card + np.arange(card - shared.size)
        sup = np.sort(np.concatenate([shared, extra]))
        x = np.zeros(n)
        x[sup] = rng.normal(size=card)
        results.append(PCResult(x=x, support=sup, lam=1.0, variance=1.0,
                                cardinality=card, reduced_n=card, gap=0.0))
    proj = TopicProjector(pack_components(results, n_features=n),
                          device="cpu")
    X = rng.poisson(1.0, size=(10, n)).astype(np.float32)
    X[:, shared] += 3.0
    np.testing.assert_allclose(proj.project_docs(_docs(X)),
                               proj.project(X).numpy(), **TOL)


def test_projector_counts_shapes_and_rejects_a_bad_pack():
    proj = _projector(120, 2, 4)
    X = np.ones((8, 120), np.float32)
    for _ in range(3):
        proj.project(X)
    proj.project(torch.from_numpy(X))            # a tensor: same shape
    assert proj.trace_count == 1
    proj.project(X[:3])                          # a ragged batch shows
    assert proj.trace_count == 2
    bad = ProjectorPack(support_idx=np.array([[45, 0]], np.int32),
                        values=np.array([[1.0, 0.0]], np.float32),
                        n_features=40)
    with pytest.raises(ValueError, match="outside"):
        TopicProjector(bad, device="cpu")


def test_pack_components_shape_stable_across_cardinality_wobble():
    n = 300
    p1 = pack_components(_fake_components(n, 3, 5), n_features=n)
    p2 = pack_components(_fake_components(n, 3, 7, seed=1), n_features=n)
    assert p1.cap == p2.cap == 8


# ---------------------------------------------------------------- registry
def _register_both(tmp_path, n=250):
    res = _fake_components(n, 2, 4)
    jres = _fake_components(n, 2, 4, cls=JPCResult)
    screen, jscreen = _screens(n, 100)
    port = ModelRegistry(str(tmp_path / "port"), device="cpu")
    ref = JModelRegistry(str(tmp_path / "ref"), impl="ref")
    for reg, r, s in ((port, res, screen), (ref, jres, jscreen)):
        reg.register(r, s, n_features=n, meta={"corpus": "unit", "note": 7})
        reg.register(r[:1], s, n_features=n)
    return port, ref, n


def test_registry_manifests_match_the_reference(tmp_path):
    _register_both(tmp_path)
    for v in (0, 1):
        step = f"step_{v:09d}"
        a = (tmp_path / "port" / step / "manifest.json").read_text()
        b = (tmp_path / "ref" / step / "manifest.json").read_text()
        assert a == b
        with np.load(tmp_path / "port" / step / "host_00000.npz") as pa, \
                np.load(tmp_path / "ref" / step / "host_00000.npz") as pb:
            assert pa.files == pb.files
            for k in pa.files:
                assert pa[k].dtype == pb[k].dtype, k
                np.testing.assert_array_equal(pa[k], pb[k])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_registry_written_by_one_package_serves_in_the_other(tmp_path,
                                                             writer):
    _register_both(tmp_path)
    X = np.random.default_rng(3).poisson(0.5, size=(9, 250)).astype(
        np.float32)
    root = str(tmp_path / ("ref" if writer == "reference" else "port"))
    port = ModelRegistry(root, device="cpu")
    ref = JModelRegistry(root, impl="ref")
    assert port.load_all() == ref.load_all() == [0, 1]
    for v in (0, 1):
        a, b = port.get(v), ref.get(v)
        np.testing.assert_array_equal(a.pack.support_idx, b.pack.support_idx)
        np.testing.assert_array_equal(a.pack.values, b.pack.values)
        assert a.lam == b.lam and a.meta == b.meta
        np.testing.assert_array_equal(a.lams, b.lams)
        np.testing.assert_array_equal(a.screen.variances.numpy(),
                                      np.asarray(b.screen.variances))
        assert int(a.screen.count) == int(b.screen.count) == 100
        np.testing.assert_allclose(a.projector.project(X).numpy(),
                                   np.asarray(b.projector.project(X)), **TOL)
    assert port.active().version == ref.active().version == 1


def test_model_version_from_reference_leaves_serves_the_same_scores(
        tmp_path):
    """The reference's registry leaves, as numpy arrays, become the
    port's ModelVersion; both serve the same scores and drift alike."""
    _, ref, n = _register_both(tmp_path)
    step = tmp_path / "ref" / "step_000000000" / "host_00000.npz"
    with np.load(step) as z:
        leaves = {k: z[k] for k in z.files}
    mv = model_version_from_reference(leaves, device="cpu")
    jmv = ref.get(0)
    assert mv.pack.k == 2 and mv.meta == {"corpus": "unit", "note": 7}
    X = np.random.default_rng(8).poisson(0.6, size=(17, n)).astype(
        np.float32)
    np.testing.assert_allclose(mv.projector.project(X).numpy(),
                               np.asarray(jmv.projector.project(X)), **TOL)
    with pytest.raises(TypeError, match="not registry leaves"):
        model_version_from_reference({**leaves, "bogus": 1}, device="cpu")


def test_registry_persist_and_reload(tmp_path):
    n = 250
    res = _fake_components(n, 2, 4)
    screen, _ = _screens(n, 100)
    reg = ModelRegistry(str(tmp_path), device="cpu")
    mv = reg.register(res, screen, n_features=n,
                      meta={"corpus": "unit", "note": 7})
    assert mv.version == 0
    assert reg.register(res, screen, n_features=n).version == 1
    assert reg.active().version == 1
    reg.rollback(0)
    assert reg.active().version == 0
    fresh = ModelRegistry(str(tmp_path), device="cpu")
    assert fresh.load_all() == [0, 1]
    assert fresh.active().version == 1
    np.testing.assert_array_equal(fresh.get(0).pack.support_idx,
                                  mv.pack.support_idx)
    assert fresh.get(0).lam == pytest.approx(mv.lam)
    np.testing.assert_allclose(fresh.get(0).lams, mv.lams)
    assert fresh.get(0).meta == {"corpus": "unit", "note": 7}


def test_registry_hot_swap_under_concurrent_lookups():
    """Readers hammering active() during swaps always see a complete,
    internally consistent version (pack matches projector)."""
    n = 200
    screen, _ = _screens(n, 10)
    reg = ModelRegistry(None, device="cpu")
    reg.register(_fake_components(n, 2, 4, seed=0), screen, n_features=n)
    stop = threading.Event()
    errors: list[Exception] = []

    def reader():
        X = np.ones((4, n), np.float32)
        try:
            while not stop.is_set():
                mv = reg.active()
                s = mv.projector.project(X)
                assert tuple(s.shape) == (4, mv.pack.k)
                assert mv.pack.values is mv.projector.pack.values
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for v in range(1, 6):
        reg.register(_fake_components(n, 2 + v % 2, 4, seed=v), screen,
                     n_features=n, persist=False)
        time.sleep(0.02)
    stop.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert not errors, errors
    assert reg.active().version == 5
    assert reg.versions() == [0, 1, 2, 3, 4, 5]


def test_registry_skips_corrupt_version_and_rolls_back(tmp_path):
    n = 150
    screen, _ = _screens(n, 50)
    reg = ModelRegistry(str(tmp_path), device="cpu")
    for seed in range(3):
        reg.register(_fake_components(n, 2, 4, seed=seed), screen,
                     n_features=n)
    npz = str(tmp_path / "step_000000002" / "host_00000.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 3)
    fresh = ModelRegistry(str(tmp_path), device="cpu")
    with metrics.use_registry() as mreg:
        with pytest.warns(RuntimeWarning, match="corrupt version 2"):
            assert fresh.load_all() == [0, 1]
        assert mreg.value("serve.registry.corrupt") == 1
        assert fresh.active().version == 1
        mv = fresh.rollback_to_last_good()
        assert mv.version == 0 and fresh.active().version == 0
        assert mreg.value("serve.registry.rollbacks") == 1
    with pytest.raises(LookupError, match="no version older"):
        fresh.rollback_to_last_good()
    # the reference skips the same version of the same root
    with pytest.warns(RuntimeWarning, match="corrupt version 2"):
        assert JModelRegistry(str(tmp_path), impl="ref").load_all() == [0, 1]


def test_registry_skips_torn_manifest(tmp_path):
    n = 80
    screen, _ = _screens(n, 5)
    reg = ModelRegistry(str(tmp_path), device="cpu")
    reg.register(_fake_components(n, 2, 4), screen, n_features=n)
    reg.register(_fake_components(n, 2, 4, seed=1), screen, n_features=n)
    mf = tmp_path / "step_000000001" / "manifest.json"
    mf.write_text(mf.read_text()[:20])
    with pytest.warns(RuntimeWarning, match="corrupt version 1"):
        assert ModelRegistry(str(tmp_path), device="cpu").load_all() == [0]


def test_rollback_to_last_good_requires_active():
    with pytest.raises(LookupError, match="no active model"):
        ModelRegistry(None, device="cpu").rollback_to_last_good()


# ----------------------------------------------------------------- batcher
def test_batcher_matches_reference_batcher():
    """The same requests through both batchers: the same scores."""
    n = 150
    res = _fake_components(n, 2, 4)
    jres = _fake_components(n, 2, 4, cls=JPCResult)
    port = TopicProjector(pack_components(res, n_features=n), device="cpu")
    ref = JTopicProjector(jpack(jres, n_features=n), impl="ref")
    X = np.random.default_rng(2).poisson(0.5, size=(20, n)).astype(
        np.float32)
    out = []
    for cls, proj in ((MicroBatcher, port), (JMicroBatcher, ref)):
        with cls(proj, n, BatcherConfig(max_batch=4)) as mb:
            futs = [mb.submit(w, c) for w, c in _docs(X)]
            out.append(np.stack([f.result(timeout=30) for f in futs]))
    assert isinstance(out[0][0], np.ndarray)
    np.testing.assert_allclose(out[0], out[1], **TOL)
    np.testing.assert_allclose(out[0], port.project(X).numpy(), **TOL)


def test_batcher_shape_stability_across_ragged_requests():
    """Ragged request sizes never reach the projector: it sees the one
    padded (max_batch, n) shape, warm-up included (trace_count == 1)."""
    n = 300
    proj = _projector(n, 3, 5)
    rng = np.random.default_rng(1)
    mb = MicroBatcher(proj, n, BatcherConfig(max_batch=8, max_wait_ms=1.0))
    with metrics.use_registry() as reg:
        with mb:
            futs = []
            for sz in rng.integers(1, 60, size=100):
                wi = rng.choice(n, size=sz, replace=False)
                futs.append(mb.submit(wi, np.ones(sz, np.float32)))
            scores = [f.result(timeout=30) for f in futs]
        # one dispatch per batch plus the warm-up
        assert (reg.value("kernel.launches.sparse_project")
                == mb.batches_served + 1)
        assert reg.value("serve.requests") == 100
        assert reg.value("serve.batches") == mb.batches_served
    assert proj.trace_count == 1, "projector saw a ragged shape"
    assert all(s.shape == (3,) for s in scores)
    assert mb.batches_served >= 100 // 8
    snap = mb.stats.snapshot()
    assert snap["count"] == 100
    assert snap["p99_ms"] >= snap["p50_ms"] >= 0.0


def test_batcher_tensor_scores_resolve_as_numpy_rows():
    """A projector that returns a tensor resolves every future with a
    numpy row of its own batch."""
    n = 40
    proj = _projector(n, 2, 3)
    X = np.random.default_rng(4).poisson(1.0, size=(6, n)).astype(np.float32)
    with MicroBatcher(proj, n, BatcherConfig(max_batch=8)) as mb:
        got = [mb.submit(w, c).result(timeout=30) for w, c in _docs(X)]
    want = proj.project(X).numpy()
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **TOL)


def test_batcher_propagates_projection_errors_to_futures():
    class Boom:
        def project(self, X):
            raise RuntimeError("kernel exploded")

    mb = MicroBatcher(Boom(), 50, BatcherConfig(max_batch=2, max_wait_ms=0.5))
    mb._thread = threading.Thread(target=mb._serve_loop, daemon=True)
    mb._thread.start()  # bypass start()'s warm-up (it would raise here)
    f = mb.submit([1, 2], [1.0, 1.0])
    with pytest.raises(RuntimeError, match="kernel exploded"):
        f.result(timeout=30)
    mb.stop()


def test_batcher_survives_malformed_request():
    n = 120
    with MicroBatcher(_projector(n, 2, 4), n,
                      BatcherConfig(max_batch=4, max_wait_ms=0.5)) as mb:
        with pytest.raises(IndexError):
            mb.submit([n + 5], [1.0]).result(timeout=30)
        with pytest.raises(IndexError):
            mb.submit([-1], [1.0]).result(timeout=30)
        assert mb.submit([3, 4], [1.0, 2.0]).result(timeout=30).shape == (2,)


def test_batcher_sheds_over_capacity_submits():
    n = 60
    mb = MicroBatcher(_projector(n, 2, 4), n,
                      BatcherConfig(max_batch=4, max_queue=2))
    with metrics.use_registry() as reg:
        f1 = mb.submit([1], [1.0])
        f2 = mb.submit([2], [1.0])
        f3 = mb.submit([3], [1.0])     # queue at capacity: shed at the door
        assert not f1.done() and not f2.done()
        with pytest.raises(RequestShed):
            f3.result(timeout=1)
        assert reg.value("serve.shed") == 1
    assert mb.snapshot()["shed"] == 1
    with mb:
        assert f1.result(timeout=30).shape == (2,)
        assert f2.result(timeout=30).shape == (2,)
    assert mb.snapshot()["shed"] == 1 and mb.snapshot()["timeouts"] == 0


def test_batcher_expires_requests_past_deadline():
    n = 60
    mb = MicroBatcher(_projector(n, 2, 4), n,
                      BatcherConfig(max_batch=4, max_wait_ms=0.5,
                                    deadline_ms=50.0))
    with metrics.use_registry() as reg:
        stale1 = mb.submit([1], [1.0])
        stale2 = mb.submit([2], [1.0])
        time.sleep(0.1)
        with mb:
            with pytest.raises(RequestTimeout):
                stale1.result(timeout=30)
            with pytest.raises(RequestTimeout):
                stale2.result(timeout=30)
            assert mb.submit([3, 4], [1.0, 1.0]).result(
                timeout=30).shape == (2,)
        assert reg.value("serve.timeouts") == 2
    snap = mb.snapshot()
    assert snap["timeouts"] == 2 and snap["shed"] == 0
    assert snap["count"] == 1


def test_batcher_stop_fails_stranded_requests():
    n = 80
    mb = MicroBatcher(_projector(n, 2, 4), n, BatcherConfig(max_batch=4))
    mb.start()
    mb.stop()
    r = _Request([1], [1.0])
    mb._q.put(r)
    mb.stop()
    with pytest.raises(RuntimeError, match="batcher stopped"):
        r.future.result(timeout=5)
    with pytest.raises(RuntimeError, match="stopped"):
        mb.submit([1], [1.0])


def test_batcher_snapshot_and_serve_span():
    """snapshot() holds the overload picture; each batch is one
    ``serve.batch`` span on the server thread's own timeline."""
    from repro_torch.obs import trace

    n = 60
    mb = MicroBatcher(_projector(n, 2, 4), n,
                      BatcherConfig(max_batch=4, max_wait_ms=0.5,
                                    deadline_ms=75.0, max_queue=16))
    snap = mb.snapshot()
    assert snap["queue_depth"] == 0
    assert snap["max_queue"] == 16 and snap["deadline_ms"] == 75.0
    with metrics.use_registry() as reg, trace.enable() as tr:
        with mb:
            assert mb.submit([1, 2], [1.0, 1.0]).result(
                timeout=30).shape == (2,)
        assert reg.value("serve.queue_depth", default=None) == 0
    spans = tr.find("serve.batch")
    assert len(spans) == mb.batches_served >= 1
    assert spans[0].attrs["batch"] == 1


# ------------------------------------------------------------------- drift
def _zipf_screen(n_docs=600, n_words=800, seed=0):
    corpus = make_corpus(n_docs, n_words, topics=None, seed=seed)
    mean, var = corpus.column_stats_exact()
    return (corpus,
            Screen(variances=torch.from_numpy(var),
                   means=torch.from_numpy(mean), count=n_docs),
            JScreen(variances=jnp.asarray(var), means=jnp.asarray(mean),
                    count=jnp.asarray(n_docs)))


def _same_report(a, b):
    assert a.triggered == b.triggered
    assert a.docs_seen == b.docs_seen
    assert a.n_offending == b.n_offending
    np.testing.assert_array_equal(a.offending, b.offending)
    assert a.max_ratio == pytest.approx(b.max_ratio, rel=1e-5)


@pytest.mark.parametrize("shift", [False, True])
def test_drift_monitor_matches_reference(shift):
    """In distribution (quiet) and with tail words boosted (fires): the
    same verdict, docs, offending ids and max_ratio as the reference."""
    corpus, screen, jscreen = _zipf_screen()
    n = corpus.n_words
    lam = float(np.sort(np.asarray(jscreen.variances))[::-1][30])
    lams = np.array([lam, 2 * lam])
    port = DriftMonitor(screen, lams, min_docs=100)
    ref = JDriftMonitor(jscreen, lams, min_docs=100)
    assert port.device.type == "cpu"
    rng = np.random.default_rng(7)
    fresh = make_corpus(400, n, topics=None, seed=99)
    hot = np.arange(n - 4, n)
    for X in fresh.batches(128):
        X = X.copy()
        if shift:
            X[:, hot] += rng.poisson(3.0, size=(X.shape[0], hot.size))
        port.observe(X)
        ref.observe(X)
    rep, jrep = port.check(), ref.check()
    _same_report(rep, jrep)
    assert rep.triggered == shift
    if shift:
        assert set(hot) <= set(rep.offending.tolist())


def test_drift_watches_every_components_threshold():
    n = 50
    train = np.full(n, 0.1)
    train[7] = 1.0
    screen = Screen(variances=torch.from_numpy(train),
                    means=torch.zeros(n, dtype=torch.float64), count=1000)
    mon = DriftMonitor(screen, np.array([0.5, 2.0]), min_docs=1)
    rng = np.random.default_rng(11)
    X = rng.normal(scale=np.sqrt(0.05), size=(4000, n)).astype(np.float32)
    X[:, 7] = rng.normal(scale=np.sqrt(10.0), size=4000)
    mon.observe(X)
    rep = mon.check()
    assert rep.triggered and 7 in rep.offending.tolist()
    mon_min = DriftMonitor(screen, 0.5, min_docs=1)
    mon_min.observe(X)
    assert 7 not in mon_min.check().offending.tolist()


def test_drift_respects_min_docs_and_resets():
    _, screen, _ = _zipf_screen(n_docs=200, n_words=300)
    lam = float(np.sort(screen.variances.numpy())[::-1][10])
    mon = DriftMonitor(screen, lam, min_docs=500)
    X = np.zeros((100, 300), np.float32)
    X[:, 299] = 50.0 * np.arange(100)
    mon.observe(X)
    assert not mon.check().triggered
    for _ in range(4):
        mon.observe(X)
    assert mon.check().triggered and mon.docs_seen == 500
    mon.reset()
    assert mon.docs_seen == 0 and not mon.check()


def test_drift_check_mirrors_verdict_into_gauges():
    corpus, screen, _ = _zipf_screen()
    n = corpus.n_words
    lam = float(np.sort(screen.variances.numpy())[::-1][30])
    with metrics.use_registry() as reg:
        mon = DriftMonitor(screen, lam, min_docs=100)
        fresh = make_corpus(400, n, topics=None, seed=99)
        for X in fresh.batches(128):
            mon.observe(X)
        assert not mon.check().triggered
        assert reg.value("serve.drift.triggered") == 0.0
        assert reg.value("serve.drift.docs_seen") == 400
        rng = np.random.default_rng(7)
        hot = np.arange(n - 4, n)
        for X in fresh.batches(128):
            X = X.copy()
            X[:, hot] += rng.poisson(3.0, size=(X.shape[0], hot.size))
            mon.observe(X)
        rep = mon.check()
        assert rep.triggered
        assert reg.value("serve.drift.triggered") == 1.0
        assert reg.value("serve.drift.max_ratio") == pytest.approx(
            rep.max_ratio)
        assert reg.value("serve.drift.offending") == rep.n_offending


def test_end_to_end_register_serve_drift_matches_reference():
    """One packed model served through registry, batcher and drift
    monitor in both packages: the same scores and the same verdict."""
    corpus, screen, jscreen = _zipf_screen(n_docs=400, n_words=300, seed=2)
    n = corpus.n_words
    res = _fake_components(n, 3, 4, seed=6, lam=float(
        np.sort(screen.variances.numpy())[::-1][20]))
    jres = _fake_components(n, 3, 4, seed=6, cls=JPCResult,
                            lam=res[0].lam)
    fresh = make_corpus(300, n, topics=None, seed=5)
    rows = np.concatenate(list(fresh.batches(300)))
    with tempfile.TemporaryDirectory() as d:
        out = []
        for Reg, Mon, Mb, r, s, kw in (
                (ModelRegistry, DriftMonitor, MicroBatcher, res, screen,
                 {"device": "cpu"}),
                (JModelRegistry, JDriftMonitor, JMicroBatcher, jres, jscreen,
                 {"impl": "ref"})):
            reg = Reg(os.path.join(d, Reg.__module__), **kw)
            mv = reg.register(r, s, n_features=n)
            mon = Mon(mv.screen, mv.lams, min_docs=64)
            with Mb(mv.projector, n, BatcherConfig(max_batch=32),
                    observer=mon.observe) as mb:
                futs = [mb.submit(w, c) for w, c in _docs(rows)]
                scores = np.stack([f.result(timeout=60) for f in futs])
            assert mv.projector.trace_count == 1
            out.append((scores, mon.check()))
    np.testing.assert_allclose(out[0][0], out[1][0], **TOL)
    _same_report(out[0][1], out[1][1])
