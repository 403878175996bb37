"""The port's fault injection (``repro_torch.testing.faults``) against the
reference's (``repro.testing.faults``) on the CPU.

Each package's injector is installed into its own store seam
(``sparse.store.FILE_IO``) or solver seam (``kernels.ops.SOLVER_FAULTS``)
and given the same schedule on the same store and the same solves: the
rules must fire at the same occurrences (the same read and call counts,
the same ``injected`` tallies, the same files hit).  The port's store
must catch what the reference's catches: bit flips, truncation and torn
writes.  Results that survive a fault are held to the reference's:
screens to 1e-12 relative (integer counts, exact float32 sums, one
float64 division), solver objectives exactly where the fault poisons
them.
"""
import os

import numpy as np
import pytest
import torch

from repro import testing as jt
from repro.data.corpus import make_corpus
from repro.sparse import SparseCorpus as JStore
from repro.sparse import engine as jengine
from repro.sparse import write_corpus as jwrite
from repro.sparse.store import MANIFEST_NAME
from repro_torch import testing as tt
from repro_torch.core import bcd as tbcd
from repro_torch.kernels import ops as tops
from repro_torch.obs import metrics as tmetrics
from repro_torch.sparse import ShardCorruptionError, SparseCorpus as TStore
from repro_torch.sparse import engine as tengine
from repro_torch.sparse import write_corpus as twrite

TOPICS = {"t0": ["w0", "w1"], "t1": ["w2", "w3"], "t2": ["w4", "w5"]}
GEOM = dict(chunk_nnz=512, chunk_rows=64, megabatch=2)


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    c = make_corpus(300, 400, topics=TOPICS, seed=0)
    path = str(tmp_path_factory.mktemp("faults") / "store")
    jwrite(c, path, shard_nnz=2500)
    return path


def _screens(path, jinj, tinj, *, io_retries):
    """The screen pass of each package under its own injector; returns
    ((reference variances or the exception), (port's ...))."""
    out = []
    for eng, store, inj, install in (
            (jengine, JStore.open(path), jinj, jt.install),
            (tengine, TStore.open(path), tinj, tt.install)):
        store.set_io_policy(io_retries=io_retries, io_backoff_s=0.0)
        kw = {} if eng is jengine else dict(device="cpu",
                                            acc_dtype=torch.float64)
        ctr: dict = {}
        try:
            with install(inj):
                scr = eng.sparse_feature_variances(store, counters=ctr,
                                                   **GEOM, **kw)
            out.append((np.asarray(scr.variances, np.float64), ctr))
        except OSError as e:
            out.append((type(e).__name__ + ": " + str(e), ctr))
    return out


@pytest.mark.parametrize("n,times,match,retries", [
    (0, 1, "*.npy", 2),                    # absorbed by the retry policy
    (2, 2, "*.values.npy", 3),             # absorbed, values files only
    (3, 10**9, "*.npy", 0),                # a kill: every read from 3 on
    (1, 10**9, "*.col_ids.npy", 2),        # retries exhausted
])
def test_fail_nth_read_fires_at_the_same_reads(store_path, n, times, match,
                                              retries):
    jinj = jt.FaultInjector(jt.fail_nth_read(n, match=match, times=times))
    tinj = tt.FaultInjector(tt.fail_nth_read(n, match=match, times=times))
    (jres, jctr), (tres, tctr) = _screens(store_path, jinj, tinj,
                                          io_retries=retries)
    assert tinj.reads == jinj.reads and tinj.injected == jinj.injected
    assert tinj.injected["read_fail"] >= 1
    assert tctr.get("io_retries", 0) == jctr.get("io_retries", 0)
    if isinstance(jres, str):
        assert tres == jres                 # the same file, the same error
        assert "injected read failure" in tres
    else:
        np.testing.assert_allclose(tres, jres, rtol=1e-12, atol=0)


def test_slow_reads_only_slow(store_path):
    jinj = jt.FaultInjector(jt.slow_read(0.0005, match="*.col_ids.npy"))
    tinj = tt.FaultInjector(tt.slow_read(0.0005, match="*.col_ids.npy"))
    (jres, _), (tres, _) = _screens(store_path, jinj, tinj, io_retries=0)
    assert tinj.injected == jinj.injected and tinj.injected["slow"] > 0
    np.testing.assert_allclose(tres, jres, rtol=1e-12, atol=0)


@pytest.mark.parametrize("match,frac", [(MANIFEST_NAME + "*", 0.5),
                                        ("*.values.npy*", 0.3)])
def test_torn_write_is_never_published(tmp_path, match, frac):
    c = make_corpus(120, 150, topics=TOPICS, seed=0)
    seen = {}
    for name, write, inj, install in (
            ("ref", jwrite, jt.FaultInjector(jt.torn_write(match=match,
                                                           frac=frac)),
             jt.install),
            ("port", twrite, tt.FaultInjector(tt.torn_write(match=match,
                                                            frac=frac)),
             tt.install)):
        path = str(tmp_path / name)
        with install(inj), pytest.raises(OSError, match="torn write"):
            write(c, path, shard_nnz=2000)
        published = sorted(f for f in os.listdir(path)
                           if not f.endswith(".tmp"))
        seen[name] = (inj.writes, inj.injected, published)
        assert not os.path.exists(os.path.join(path, MANIFEST_NAME))
        with pytest.raises(FileNotFoundError):
            TStore.open(path)
    assert seen["port"] == seen["ref"]


def test_flip_after_write_is_caught_by_the_ports_store(tmp_path):
    c = make_corpus(120, 150, topics=TOPICS, seed=0)
    names = {}
    for name, write, inj, install in (
            ("ref", jwrite, jt.FaultInjector(jt.flip_bytes(
                match="*.col_ids.npy*", n_flips=3), seed=11), jt.install),
            ("port", twrite, tt.FaultInjector(tt.flip_bytes(
                match="*.col_ids.npy*", n_flips=3), seed=11), tt.install)):
        path = str(tmp_path / name)
        with install(inj):
            write(c, path, shard_nnz=2000)
        assert inj.injected["flip"] == 1
        with pytest.raises(ShardCorruptionError) as ei:
            TStore.open(path).verify()
        names[name] = ei.value.shard
        # the same seeded flips land on the same bytes
        with open(os.path.join(path, ei.value.shard), "rb") as f:
            names[name + "_bytes"] = f.read()
    assert names["port"] == names["ref"]
    assert names["port_bytes"] == names["ref_bytes"]


@pytest.mark.parametrize("damage", ["corrupt", "truncate"])
@pytest.mark.parametrize("which", ["values", "col_ids", "row_ptr"])
def test_damaged_shard_is_refused_by_name_and_never_retried(
        store_path, tmp_path, damage, which):
    import shutil

    path = str(tmp_path / "copy")
    shutil.copytree(store_path, path)
    store = TStore.open(path)
    name = store.manifest["shards"][1]["files"][which]
    if damage == "corrupt":
        tt.corrupt_file(os.path.join(path, name), n_flips=3, seed=7)
    else:
        tt.truncate_file(os.path.join(path, name), frac=0.4)
    fresh = TStore.open(path, io_retries=5, io_backoff_s=0.001)
    with tmetrics.use_registry() as reg:
        with pytest.raises(ShardCorruptionError) as ei:
            tengine.sparse_feature_variances(fresh, device="cpu", **GEOM)
        assert reg.value("ingest.retries") == 0
    assert ei.value.shard == name
    with pytest.raises(Exception) as je:     # the reference refuses it too
        JStore.open(path).verify()
    assert type(je.value).__name__ == "ShardCorruptionError"


def test_on_disk_helpers_damage_the_same_bytes(tmp_path):
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, size=4096, dtype=np.uint8).tobytes()
    got = []
    for helper in (jt, tt):
        p = str(tmp_path / f"{helper.__name__}.bin")
        with open(p, "wb") as f:
            f.write(payload)
        helper.corrupt_file(p, n_flips=5, seed=3)
        helper.truncate_file(p, frac=0.75)
        got.append(open(p, "rb").read())
    assert got[0] == got[1] and len(got[1]) == 3072
    assert got[1] != payload[:3072]


# ------------------------------------------------------------ solver seam


def _sigma(n=24, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((3 * n, n))
    return B.T @ B / (3 * n)


def _solve_objs(inj, install, solve, S, k=4):
    objs, sweeps = [], []
    with install(inj):
        for _ in range(k):
            r = solve(S)
            o = r.kernel_obj if r.kernel_obj is not None else r.obj
            objs.append(float(np.asarray(o)))
            sweeps.append(int(np.asarray(r.sweeps)))
    return objs, sweeps


@pytest.mark.parametrize("rule,n,times", [("nonfinite_solve", 1, 2),
                                          ("stalled_solve", 0, 1),
                                          ("stalled_solve", 2, 2)])
def test_solver_rules_fire_at_the_same_solves(rule, n, times):
    from repro.core import bcd as jbcd

    S = _sigma()
    jinj = jt.SolverFaultInjector(getattr(jt, rule)(n, match="bcd_solve",
                                                    times=times))
    tinj = tt.SolverFaultInjector(getattr(tt, rule)(n, match="bcd_solve",
                                                    times=times))
    jo, js = _solve_objs(jinj, jt.install_solver, lambda S: jbcd.solve_bcd(
        S, 0.1, max_sweeps=6, solver_impl="fused_ref"), S)
    to, ts = _solve_objs(tinj, tt.install_solver, lambda S: tbcd.solve_bcd(
        torch.from_numpy(S), 0.1, max_sweeps=6, solver_impl="fused_ref"), S)
    assert tinj.injected == jinj.injected and tinj.calls == jinj.calls
    hit = [n <= i < n + times for i in range(4)]
    assert [not np.isfinite(o) for o in to] == [not np.isfinite(o)
                                                for o in jo]
    if rule == "nonfinite_solve":
        assert [not np.isfinite(o) for o in to] == hit
    else:
        assert [s == 6 for s, h in zip(ts, hit) if h] == [True] * times
        assert [s == 6 for s in ts] == [s == 6 for s in js]


def test_batched_poison_and_dispatch_error_are_site_scoped():
    S = torch.from_numpy(_sigma())
    inj = tt.SolverFaultInjector(
        tt.nonfinite_solve(0, match="bcd_solve_batched", problem=1),
        tt.dispatch_error(1, match="bcd_solve_batched"))
    with tt.install_solver(inj):
        tbcd.solve_bcd(S, 0.1, max_sweeps=4, solver_impl="fused_ref")
        out = tbcd.solve_bcd_many([S, S, S], [0.1, 0.15, 0.2], max_sweeps=4)
        with pytest.raises(tt.InjectedDispatchError):
            tbcd.solve_bcd_many([S, S], [0.1, 0.2], max_sweeps=4)
    assert inj.calls == {"bcd_solve": 1, "bcd_solve_batched": 2}
    assert inj.injected == {"nonfinite": 1, "stall": 0, "dispatch": 1}
    objs = [float(r.kernel_obj if r.kernel_obj is not None else r.obj)
            for r in out]
    assert [np.isfinite(o) for o in objs] == [True, False, True]
    assert isinstance(tt.InjectedDispatchError("x"), RuntimeError)


def test_perturbed_results_stay_tensors_on_their_device():
    S = torch.from_numpy(_sigma())
    out = tops.bcd_solve(S, 0.1, 0.01, max_sweeps=4, impl="ref")
    inj = tt.SolverFaultInjector(tt.nonfinite_solve(0), tt.stalled_solve(0))
    X, obj, sweeps, hist = inj.after("bcd_solve", out, max_sweeps=4)
    assert isinstance(obj, torch.Tensor) and obj.device == out[1].device
    assert isinstance(sweeps, torch.Tensor) and int(sweeps) == 4
    assert torch.isnan(obj) and torch.isfinite(out[1])   # a copy, not in place
    assert X is out[0] and hist is out[3]


def test_install_restores_the_seams():
    from repro_torch.sparse import store as tstore

    prev_io, prev_solver = tstore.FILE_IO, tops.SOLVER_FAULTS
    with tt.install(tt.FaultInjector()) as inj, \
            tt.install_solver(tt.SolverFaultInjector()) as sinj:
        assert tstore.FILE_IO is inj and tops.SOLVER_FAULTS is sinj
    assert tstore.FILE_IO is prev_io and tops.SOLVER_FAULTS is prev_solver
