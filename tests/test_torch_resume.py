"""Kill-and-resume of the port's streaming passes (``repro_torch.sparse.
resume`` wired into ``sparse.engine``) on the CPU, and pass checkpoints
crossing between the port and the reference (``repro.sparse.resume``)
both ways.

Tolerances, each for its reason:
  * a pass killed by an injected read fault (or its watchdog) and resumed
    in the port equals the port's uninterrupted pass EXACTLY — the
    accumulator state (``sum``/``sumsq``, ``g``/``err``) and what the pass
    returns: the resumed pass restores the saved state unchanged and folds
    the remaining megabatches in the same order;
  * across packages, the resumed pass is held to the other package's
    uninterrupted pass with the CSR bars of tests/test_torch_streaming.py:
    the screen to 1e-12 relative (integer counts, exact float32 sums, one
    float64 division), the Gram to 1e-6 of its largest entry (the
    per-megabatch B^T B is a float32 product in another order there).
The reference runs under the tests' x64, so the port's side of a
cross-package pass accumulates in float64 (``acc_dtype``) to carry the
same accumulator signature.
"""
import glob
import os
import shutil

import numpy as np
import pytest
import torch

from repro import testing as jt
from repro.data.corpus import make_corpus
from repro.sparse import SparseCorpus as JStore
from repro.sparse import engine as jengine
from repro.sparse import resume as jresume
from repro.sparse import write_corpus
from repro_torch import testing as tt
from repro_torch.data import bow as tbow
from repro_torch.obs import health, metrics
from repro_torch.sparse import SparseCorpus as TStore
from repro_torch.sparse import engine as tengine
from repro_torch.sparse import resume as tresume

TOPICS = {"t0": ["w0", "w1"], "t1": ["w2", "w3"], "t2": ["w4", "w5"]}
GEOM = dict(chunk_nnz=512, chunk_rows=64, megabatch=2)
ACC = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    c = make_corpus(300, 400, topics=TOPICS, seed=0)
    path = str(tmp_path_factory.mktemp("resume") / "store")
    write_corpus(c, path, shard_nnz=1500)
    assert JStore.open(path).n_shards >= 4
    return path


@pytest.fixture(scope="module")
def support(store_path):
    var = np.asarray(jengine.sparse_feature_variances(
        JStore.open(store_path), **GEOM).variances)
    return np.sort(np.argsort(-var, kind="stable")[:40])


def _tpass(kind, store, support, acc, **kw):
    """One pass of the port: the screen's (variances, means) or the Gram's
    Sigma_hat, as host float64 arrays."""
    kw = dict(GEOM, device="cpu", acc_dtype=acc, **kw)
    if kind == "screen":
        s = tengine.sparse_feature_variances(store, **kw)
        return np.stack([s.variances.numpy(), s.means.numpy()]).astype(
            np.float64)
    return tengine.sparse_reduced_covariance(
        store, support, means=_means(store), **kw).numpy().astype(np.float64)


def _means(store):
    return tengine.sparse_feature_variances(
        store, device="cpu", acc_dtype=torch.float64, **GEOM).means.numpy()


def _state(rd, kind):
    """The pass's complete checkpoint: its final accumulator state."""
    (d,) = glob.glob(os.path.join(rd, f"pass_{kind}_*"))
    with np.load(os.path.join(d, tresume.STATE_NAME)) as z:
        return {k: z[k] for k in z.files}


def _reads(kind, store, support, acc):
    probe = tt.FaultInjector()
    with tt.install(probe):
        _tpass(kind, store, support, acc)
    return probe.reads


@pytest.mark.parametrize("acc", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["screen", "gram"])
def test_killed_pass_resumes_to_the_uninterrupted_state_exactly(
        store_path, support, tmp_path, kind, acc):
    acc = ACC[acc]
    store = TStore.open(store_path)
    clean_ctr: dict = {}
    rd0 = str(tmp_path / "clean")
    clean = _tpass(kind, store, support, acc, counters=clean_ctr,
                   resume_dir=rd0, checkpoint_every=1)
    # means are read in the Gram case: land the kill halfway into the
    # pass's own reads, after them
    extra = _reads("screen", store, support, acc) if kind == "gram" else 0
    kill_at = extra + (_reads(kind, store, support, acc) - extra) // 2
    rd = str(tmp_path / "resume")
    store.set_io_policy(io_retries=0)
    kill = tt.FaultInjector(tt.fail_nth_read(kill_at, match="*.npy",
                                             times=10**9))
    with tt.install(kill), pytest.raises(OSError, match="injected"):
        _tpass(kind, store, support, acc, resume_dir=rd, checkpoint_every=1)
    ctr: dict = {}
    with metrics.use_registry() as reg:
        got = _tpass(kind, store, support, acc, counters=ctr, resume_dir=rd,
                     checkpoint_every=1)
        assert reg.value("ingest.resume.loads") >= 1
        assert reg.value("ingest.resume.megabatches_skipped") \
            == ctr["resumed_megabatches"]
    assert ctr["resumed_megabatches"] > 0
    assert ctr["chunks"] < clean_ctr["chunks"]
    np.testing.assert_array_equal(got, clean)
    want, have = _state(rd0, kind), _state(rd, kind)
    assert sorted(have) == sorted(want)
    for k in want:
        assert have[k].dtype == want[k].dtype
        np.testing.assert_array_equal(have[k], want[k])


def test_pass_deadline_fires_at_a_resumable_boundary(store_path, tmp_path):
    store = TStore.open(store_path)
    clean = _tpass("screen", store, None, torch.float32)
    rd = str(tmp_path / "resume")
    with metrics.use_registry() as reg:
        with pytest.raises(health.PassDeadlineError) as ei:
            _tpass("screen", store, None, torch.float32, pass_deadline_s=0.0,
                   resume_dir=rd, checkpoint_every=1)
        assert reg.value("watchdog.expired") == 1
    assert "screen pass" in ei.value.what
    ctr: dict = {}
    got = _tpass("screen", store, None, torch.float32, counters=ctr,
                 resume_dir=rd, checkpoint_every=1)
    assert ctr["resumed_megabatches"] == 1
    np.testing.assert_array_equal(got, clean)


def test_completed_passes_resume_with_zero_streaming(store_path, support,
                                                     tmp_path):
    store = TStore.open(store_path)
    kw = dict(**GEOM, device="cpu", resume_dir=str(tmp_path / "r"),
              checkpoint_every=4)
    v0, build0 = tengine.sparse_stats(store, **kw)
    G0 = build0(support).numpy()
    ctr: dict = {}
    with metrics.use_registry() as reg:
        v1, build1 = tengine.sparse_stats(store, counters=ctr, **kw)
        G1 = build1(support).numpy()
        assert reg.value("kernel.launches.csr_column_stats") == 0
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_array_equal(G1, G0)
    assert ctr.get("chunks", 0) == 0 and ctr["resumed_megabatches"] > 0


def test_geometry_change_falls_back_to_a_clean_pass(store_path, tmp_path):
    store = TStore.open(store_path)
    rd = str(tmp_path / "r")
    tengine.sparse_feature_variances(store, **GEOM, device="cpu",
                                     resume_dir=rd, checkpoint_every=2)
    ctr: dict = {}
    got = tengine.sparse_feature_variances(
        store, chunk_nnz=1024, chunk_rows=64, megabatch=2, device="cpu",
        counters=ctr, resume_dir=rd, checkpoint_every=2)
    assert ctr.get("resumed_megabatches", 0) == 0
    clean = tengine.sparse_feature_variances(
        store, chunk_nnz=1024, chunk_rows=64, megabatch=2, device="cpu")
    np.testing.assert_array_equal(got.variances.numpy(),
                                  clean.variances.numpy())


def test_checkpointer_atomicity_and_fingerprint_guard(store_path, tmp_path):
    store = TStore.open(store_path)
    ck = tresume.PassCheckpointer(str(tmp_path / "ck"), every=2)
    acc = tbow.StreamingStats(store.n_cols, device="cpu")
    fp = tresume.pass_fingerprint(
        "screen", store, chunk_nnz=512, chunk_rows=64, megabatch=2,
        host_id=0, num_hosts=1, signature=acc.state_signature())
    acc.sum[:] = 1.5
    acc.count = 42
    ck.save(fp, 7, acc.state_dict())
    cursor, state, complete = ck.load(fp)
    assert (cursor, complete) == (7, False) and int(state["count"]) == 42
    np.testing.assert_array_equal(state["sum"], acc.sum.numpy())
    assert ck.load(dict(fp, chunk_nnz=1024)) is None
    d = ck._dir(fp)
    tt.truncate_file(os.path.join(d, tresume.STATE_NAME), frac=0.3)
    assert ck.load(fp) is None
    ck.save(fp, 9, acc.state_dict())
    tt.truncate_file(os.path.join(d, tresume.META_NAME), frac=0.3)
    assert ck.load(fp) is None
    ck.save(fp, 11, acc.state_dict(), complete=True)
    os.makedirs(d + ".tmp", exist_ok=True)
    assert ck.load(fp)[::2] == (11, True)
    ck.clear(fp)
    assert ck.load(fp) is None and not os.path.exists(d + ".tmp")


@pytest.mark.parametrize("kind", ["screen", "gram"])
def test_fingerprints_and_directories_match_the_reference(store_path,
                                                          support, kind):
    jstore, tstore = JStore.open(store_path), TStore.open(store_path)
    if kind == "screen":
        sig_t = tbow.StreamingStats(tstore.n_cols, device="cpu")
        from repro.data.bow import StreamingStats as JStats
        sig_j = JStats(jstore.n_cols)
    else:
        from repro.data.bow import StreamingGram as JGram
        sig_t = tbow.StreamingGram(support, device="cpu",
                                   acc_dtype=torch.float64)
        sig_j = JGram(support, chunk_rows=64)
    kw = dict(chunk_nnz=512, chunk_rows=64, megabatch=2, host_id=0,
              num_hosts=1)
    fj = jresume.pass_fingerprint(kind, jstore,
                                  signature=sig_j.state_signature(), **kw)
    ft = tresume.pass_fingerprint(kind, tstore,
                                  signature=sig_t.state_signature(), **kw)
    assert ft == fj
    assert tresume._digest(ft) == jresume._digest(fj)
    assert tresume.PassCheckpointer("r")._dir(ft) \
        == jresume.PassCheckpointer("r")._dir(fj)


def _jpass(kind, store, support, means, **kw):
    if kind == "screen":
        s = jengine.sparse_feature_variances(store, **GEOM, **kw)
        return np.stack([np.asarray(s.variances), np.asarray(s.means)])
    return np.asarray(jengine.sparse_reduced_covariance(
        store, support, means=means, **GEOM, **kw))


def _hold(kind, got, want):
    tol = 1e-12 if kind == "screen" else 1e-6
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("kind", ["screen", "gram"])
def test_reference_checkpoint_resumes_in_the_port(store_path, support,
                                                  tmp_path, kind):
    jstore = JStore.open(store_path)
    means = np.asarray(jengine.sparse_feature_variances(jstore,
                                                        **GEOM).means)
    clean = _jpass(kind, jstore, support, means)
    probe = jt.FaultInjector()
    with jt.install(probe):
        _jpass(kind, jstore, support, means)
    rd = str(tmp_path / "r")
    jstore.set_io_policy(io_retries=0)
    kill = jt.FaultInjector(jt.fail_nth_read(probe.reads // 2, match="*.npy",
                                             times=10**9))
    with jt.install(kill), pytest.raises(OSError):
        _jpass(kind, jstore, support, means, resume_dir=rd,
               checkpoint_every=1)
    assert glob.glob(os.path.join(rd, f"pass_{kind}_*"))
    ctr: dict = {}
    tstore = TStore.open(store_path)
    kw = dict(GEOM, device="cpu", acc_dtype=torch.float64, counters=ctr,
              resume_dir=rd, checkpoint_every=1)
    if kind == "screen":
        s = tengine.sparse_feature_variances(tstore, **kw)
        got = np.stack([s.variances.numpy(), s.means.numpy()])
    else:
        got = tengine.sparse_reduced_covariance(tstore, support, means=means,
                                                **kw).numpy()
    assert ctr["resumed_megabatches"] > 0
    assert ctr["chunks"] < tstore.n_chunks(512, 64)
    _hold(kind, got, clean)


@pytest.mark.parametrize("kind", ["screen", "gram"])
def test_port_checkpoint_resumes_in_the_reference(store_path, support,
                                                  tmp_path, kind):
    tstore = TStore.open(store_path)
    jstore = JStore.open(store_path)
    means = np.asarray(jengine.sparse_feature_variances(jstore,
                                                        **GEOM).means)
    clean = _jpass(kind, jstore, support, means)
    kw = dict(GEOM, device="cpu", acc_dtype=torch.float64)
    run = (lambda **k: tengine.sparse_feature_variances(tstore, **kw, **k)) \
        if kind == "screen" else (
        lambda **k: tengine.sparse_reduced_covariance(
            tstore, support, means=means, **kw, **k))
    probe = tt.FaultInjector()
    with tt.install(probe):
        run()
    rd = str(tmp_path / "r")
    tstore.set_io_policy(io_retries=0)
    kill = tt.FaultInjector(tt.fail_nth_read(probe.reads // 2, match="*.npy",
                                             times=10**9))
    with tt.install(kill), pytest.raises(OSError):
        run(resume_dir=rd, checkpoint_every=1)
    ctr: dict = {}
    got = _jpass(kind, jstore, support, means, counters=ctr, resume_dir=rd,
                 checkpoint_every=1)
    assert ctr["resumed_megabatches"] > 0
    _hold(kind, got, clean)


def test_kill_leaves_no_prefetch_thread_behind(store_path, tmp_path):
    """A pass that dies on its watchdog (raised in the consumer while the
    prefetch thread is still reading) stops that thread before the error
    leaves the engine."""
    import threading

    store = TStore.open(store_path)
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(health.PassDeadlineError):
        tengine.sparse_feature_variances(store, **GEOM, device="cpu",
                                         pass_deadline_s=0.0)
    left = [t for t in threading.enumerate()
            if t.ident not in before and t.is_alive()]
    assert left == []


def test_store_copy_resumes_from_the_same_checkpoint(store_path, tmp_path):
    """A checkpoint is keyed to the store's identity, not its path: the
    same store bytes at another path resume it."""
    store = TStore.open(store_path)
    rd = str(tmp_path / "r")
    with pytest.raises(health.PassDeadlineError):
        tengine.sparse_feature_variances(store, **GEOM, device="cpu",
                                         pass_deadline_s=0.0, resume_dir=rd,
                                         checkpoint_every=1)
    copy = str(tmp_path / "copy")
    shutil.copytree(store_path, copy)
    ctr: dict = {}
    tengine.sparse_feature_variances(TStore.open(copy), **GEOM, device="cpu",
                                     counters=ctr, resume_dir=rd,
                                     checkpoint_every=1)
    assert ctr["resumed_megabatches"] == 1
