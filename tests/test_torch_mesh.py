"""The lane mesh of the port (``repro_torch.launch.mesh``,
``core.distributed``, ``sparse.mesh_engine``, the device grid of
``kernels.ops.bcd_solve_batched`` / ``core.bcd.solve_bcd_many``) on four
forced ``cpu`` lanes (``REPRO_TORCH_FORCE_LANES=4``), against the port's
single-device engine and against ``repro``.

Tolerances, each for its reason:
  * mesh passes against the port's engine and a repeated mesh pass: 0 or
    1e-9 (integer counts: every float32 partial is exact, and the float64
    folds of exact values are exact in any order);
  * against the reference: the CSR bars of tests/test_torch_streaming.py
    (screen 1e-9, Gram 1e-6 of its largest entry: the reference's
    per-megabatch B^T B is a float32 product in another order);
  * the distributed dense statistics against the reference: 1e-9 (x64);
  * the device grid against one lane: exactly equal (each problem's solve
    does not depend on its lane).
The reference runs under the tests' x64, so the port's side of a
cross-package pass accumulates in float64 (``acc_dtype``) to carry the
same accumulator signature.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import elimination as jelim
from repro.data.corpus import make_corpus
from repro.launch.mesh import make_data_mesh as jmesh
from repro.sparse import SparseCorpus as JStore
from repro.sparse import engine as jengine
from repro.sparse import write_corpus
from repro_torch import testing as tt
from repro_torch.core import SPCAConfig, fit_components
from repro_torch.core import bcd as tbcd
from repro_torch.core import distributed as tdist
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import spca_run as trun
from repro_torch.obs import metrics, trace
from repro_torch.sparse import SparseCorpus as TStore
from repro_torch.sparse import engine as tengine
from repro_torch.sparse import mesh_engine as tmeshe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPICS = {"t0": ["w0", "w1"], "t1": ["w2", "w3"], "t2": ["w4", "w5"]}
GEOM = dict(chunk_nnz=512, chunk_rows=64, megabatch=2)
F64 = dict(acc_dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True)
def four_lanes(monkeypatch):
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "4")


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    c = make_corpus(300, 400, topics=TOPICS, seed=0)
    path = str(tmp_path_factory.mktemp("mesh") / "store")
    write_corpus(c, path, shard_nnz=1500)
    return path


@pytest.fixture(scope="module")
def n_mega(store_path):
    return -(-TStore.open(store_path).n_chunks(512, 64) // 2)


@pytest.fixture(scope="module")
def engine_ref(store_path):
    """The port's single-device passes: screen, support, Gram."""
    scr = tengine.sparse_feature_variances(TStore.open(store_path), **GEOM,
                                           **F64)
    var = scr.variances.numpy()
    sup = np.sort(np.argsort(-var, kind="stable")[:40])
    G = tengine.sparse_reduced_covariance(TStore.open(store_path), sup,
                                          means=scr.means.numpy(), **GEOM,
                                          **F64)
    return scr, sup, G.numpy()


# -- the mesh itself ----------------------------------------------------


def test_make_data_mesh_needs_forced_lanes(monkeypatch):
    monkeypatch.delenv(tmesh.FORCE_LANES_ENV)
    assert len(tmesh.make_data_mesh(0, device="cpu")) == 1
    with pytest.raises(RuntimeError, match=tmesh.FORCE_LANES_ENV):
        tmesh.make_data_mesh(4, device="cpu")
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "4")
    mesh = tmesh.make_data_mesh(4, device="cpu")
    assert len(mesh) == 4
    assert all(lane.device.type == "cpu" and lane.stream is None
               for lane in mesh)
    assert len(tmesh.make_data_mesh(0, device="cpu")) == 4
    with pytest.raises(RuntimeError, match="need 5 lanes"):
        tmesh.make_data_mesh(5, device="cpu")
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "four")
    with pytest.raises(ValueError, match="not an integer"):
        tmesh.lanes_available("cpu")


# -- pooled dense statistics ------------------------------------------


def test_psum_partials_matches_combine_screens():
    """Pooling stacked per-lane moments equals the reference's host-side
    `combine_screens` of the same shards."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 10))
    mesh = tmesh.make_data_mesh(4, device="cpu")
    shards = np.split(A, 4)
    s, ss, cnt = tdist.psum_partials((
        torch.tensor(np.stack([a.sum(0) for a in shards])),
        [torch.tensor((a * a).sum(0)) for a in shards],
        np.array([[16.0]] * 4)), mesh)
    mean = s / cnt
    var = ss / cnt - mean * mean
    want = jelim.combine_screens([jelim.feature_variances(jnp.asarray(a))
                                  for a in shards])
    np.testing.assert_allclose(mean.numpy(), np.asarray(want.means), atol=1e-12)
    np.testing.assert_allclose(var.numpy(), np.asarray(want.variances),
                               atol=1e-12)
    with pytest.raises(ValueError, match="3 partials for 4 lanes"):
        tdist.psum_partials(([torch.zeros(2)] * 3,), mesh)


def test_distributed_statistics_match_reference():
    rng = np.random.default_rng(1)
    n = 60
    u = np.zeros(n)
    u[[3, 7, 11]] = 1 / np.sqrt(3)
    X = rng.normal(size=(402, n)) + 4.0 * rng.normal(size=(402, 1)) * u
    mesh, jm = tmesh.make_data_mesh(4, device="cpu"), jmesh(1)
    got = tdist.distributed_variances(torch.tensor(X), mesh)
    want = jdist.distributed_variances(jnp.asarray(X), jm)
    np.testing.assert_allclose(got.variances.numpy(),
                               np.asarray(want.variances), atol=1e-9)
    assert got.count == 402
    G = tdist.distributed_gram(X[:, :12], mesh, means=got.means[:12])
    Gj = jdist.distributed_gram(jnp.asarray(X[:, :12]), jm,
                                means=want.means[:12])
    np.testing.assert_allclose(G.numpy(), np.asarray(Gj), atol=1e-9)
    S, sup, scr = tdist.distributed_screen_and_gram(X, mesh, lam=2.0)
    Sj, supj, _ = jdist.distributed_screen_and_gram(jnp.asarray(X), jm,
                                                    lam=2.0)
    np.testing.assert_array_equal(sup, np.asarray(supj))
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), atol=1e-9)
    one = tdist.distributed_screen_and_gram(
        X, tmesh.make_data_mesh(1, device="cpu"), lam=2.0)
    np.testing.assert_array_equal(one[1], sup)


# -- mesh passes --------------------------------------------------------


def test_mesh_passes_match_engine_and_reference(store_path, engine_ref,
                                                n_mega):
    scr_e, sup, G_e = engine_ref
    c = {}
    scr = tmeshe.mesh_feature_variances(TStore.open(store_path), devices=4,
                                        counters=c, **GEOM, **F64)
    np.testing.assert_allclose(scr.variances.numpy(), scr_e.variances.numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(scr.means.numpy(), scr_e.means.numpy(),
                               atol=1e-9)
    assert scr.count == scr_e.count == 300
    G = tmeshe.mesh_reduced_covariance(TStore.open(store_path), sup,
                                       devices=4, means=scr.means.numpy(),
                                       counters=c, **GEOM, **F64)
    np.testing.assert_allclose(G.numpy(), G_e, atol=1e-9)
    jscr = jengine.sparse_feature_variances(JStore.open(store_path), **GEOM)
    np.testing.assert_allclose(scr.variances.numpy(),
                               np.asarray(jscr.variances), atol=1e-9)
    jG = np.asarray(jengine.sparse_reduced_covariance(
        JStore.open(store_path), sup, means=np.asarray(jscr.means), **GEOM))
    np.testing.assert_allclose(G.numpy(), jG, atol=1e-6 * np.abs(jG).max())
    # economics: ceil(B/D) dispatches a pass, 1 + 1 passes
    assert c["screen_launches"] == c["gram_launches"] == -(-n_mega // 4)
    assert c["screen_passes"] == c["gram_passes"] == 1
    # a repeated pass is the same bits
    again = tmeshe.mesh_feature_variances(TStore.open(store_path), devices=4,
                                          **GEOM, **F64)
    assert torch.equal(again.variances, scr.variances)


def test_mesh_pass_float32_is_compensated(store_path, engine_ref):
    """The reference launcher's arithmetic (x64 off): float32 lanes with
    a Neumaier slot each, the result rounded to float32."""
    scr_e, sup, G_e = engine_ref
    scr = tmeshe.mesh_feature_variances(TStore.open(store_path), devices=4,
                                        **GEOM, device="cpu")
    assert scr.variances.dtype == torch.float32
    np.testing.assert_allclose(scr.variances.numpy(),
                               scr_e.variances.numpy().astype(np.float32),
                               rtol=1e-6)
    G = tmeshe.mesh_reduced_covariance(TStore.open(store_path), sup,
                                       devices=4, means=scr_e.means.numpy(),
                                       **GEOM, device="cpu")
    assert G.dtype == torch.float32
    np.testing.assert_allclose(G.numpy(), G_e, atol=1e-6 * np.abs(G_e).max())


def test_spans_gauge_and_lane_counters(store_path, n_mega):
    metrics.reset()
    tr = trace.install(trace.Tracer())
    try:
        tmeshe.mesh_feature_variances(TStore.open(store_path), devices=4,
                                      **GEOM, **F64)
    finally:
        trace.install(None)
    txt = tr.tree_str()
    assert "ingest.screen_pass" in txt and "ingest.shard_pass" in txt
    assert metrics.gauge("mesh.devices").value == 4.0
    chunks = TStore.open(store_path).n_chunks(512, 64)
    assert metrics.counter("ingest.shard.chunks").value == chunks
    assert metrics.counter("ingest.chunks").value == chunks
    assert metrics.counter("ingest.shard.nnz").value == \
        TStore.open(store_path).nnz
    assert metrics.counter("ingest.screen_launches").value == -(-n_mega // 4)


def test_degrade_ladder_and_corruption(store_path, engine_ref, tmp_path):
    scr_e, sup, G_e = engine_ref
    metrics.reset()
    ctr = {}
    inj = tt.SolverFaultInjector(tt.dispatch_error(n=0, match="mesh.screen"))
    with tt.install_solver(inj):
        scr = tmeshe.mesh_feature_variances(TStore.open(store_path),
                                            devices=4, counters=ctr, **GEOM,
                                            **F64)
    assert ctr["mesh_degraded"] == 1
    assert metrics.counter("mesh.degraded").value == 1.0
    assert metrics.gauge("mesh.devices").value == 2.0
    np.testing.assert_allclose(scr.variances.numpy(), scr_e.variances.numpy(),
                               atol=1e-9)
    # two failures: 4 -> 2 -> 1, the engine
    ctr2 = {}
    inj2 = tt.SolverFaultInjector(tt.dispatch_error(n=0, match="mesh.gram",
                                                    times=2))
    with tt.install_solver(inj2):
        G = tmeshe.mesh_reduced_covariance(
            TStore.open(store_path), sup, devices=4,
            means=scr_e.means.numpy(), counters=ctr2, **GEOM, **F64)
    assert ctr2["mesh_degraded"] == 2
    np.testing.assert_allclose(G.numpy(), G_e, atol=1e-9)
    # min_devices stops the ladder
    inj3 = tt.SolverFaultInjector(tt.dispatch_error(n=0, match="mesh.screen"))
    with pytest.raises(tt.InjectedDispatchError), tt.install_solver(inj3):
        tmeshe.mesh_feature_variances(TStore.open(store_path), devices=4,
                                      min_devices=4, **GEOM, **F64)
    # corruption propagates untouched
    import shutil

    bad = str(tmp_path / "bad")
    shutil.copytree(store_path, bad)
    st = TStore.open(bad)
    tt.corrupt_file(os.path.join(bad, st.manifest["shards"][0]["files"]
                                 ["values"]), n_flips=3, seed=7)
    before = metrics.counter("mesh.degraded").value
    from repro_torch.sparse import ShardCorruptionError

    with pytest.raises(ShardCorruptionError):
        tmeshe.mesh_feature_variances(TStore.open(bad), devices=4, **GEOM,
                                      **F64)
    assert metrics.counter("mesh.degraded").value == before


def test_is_dispatch_error_classifies():
    from repro_torch.kernels._build import KernelUnavailable
    from repro_torch.sparse import ShardCorruptionError

    yes = [tt.InjectedDispatchError("x"), torch.cuda.OutOfMemoryError("oom"),
           RuntimeError("csr_stats launch failed: too many resources"),
           RuntimeError("CUDA error: an illegal memory access")]
    no = [ShardCorruptionError("bad bytes"), KernelUnavailable("nvcc"),
          tbcd.SolverDivergenceError("nan"), RuntimeError("shape mismatch"),
          ValueError("CUDA error"), OSError("read")]
    assert all(tbcd.is_dispatch_error(e) for e in yes)
    assert not any(tbcd.is_dispatch_error(e) for e in no)


def test_resume_at_the_same_lanes_only(store_path, tmp_path, n_mega):
    """A mesh pass killed mid-pass resumes at D 4 to the uninterrupted
    state bit for bit; a D 4 checkpoint is not restored at D 2."""
    rd = str(tmp_path / "ckpt")
    clean = tmeshe.MeshStats(400, devices=4, **F64)
    tmeshe._mesh_drain(TStore.open(store_path), clean, devices=4,
                       prefetch_depth=2, host_id=0, num_hosts=1,
                       counters=None, launch_key="screen_launches",
                       kind="screen", chunk_nnz=512, chunk_rows=64,
                       megabatch=2)
    inj = tt.FaultInjector(tt.fail_nth_read(9, match="*.values.npy",
                                            times=10**9))
    with pytest.raises(OSError), tt.install(inj):
        tmeshe.mesh_feature_variances(
            TStore.open(store_path), devices=4, resume_dir=rd,
            checkpoint_every=2, io_retries=0, **GEOM, **F64)
    c1 = {}
    got = tmeshe.mesh_feature_variances(
        TStore.open(store_path), devices=4, counters=c1, resume_dir=rd,
        checkpoint_every=2, **GEOM, **F64)
    assert 0 < c1["resumed_megabatches"] < n_mega
    s, ss = clean._pooled("sum", "sumsq")
    m = clean.count
    np.testing.assert_array_equal(got.variances.numpy(),
                                  np.maximum(ss / m - (s / m) ** 2, 0.0))
    c2 = {}
    tmeshe.mesh_feature_variances(TStore.open(store_path), devices=2,
                                  counters=c2, resume_dir=rd,
                                  checkpoint_every=2, **GEOM, **F64)
    assert c2.get("resumed_megabatches", 0) == 0
    assert c2["screen_launches"] == -(-n_mega // 2)


def test_state_dict_is_the_stacked_reference_layout(store_path):
    acc = tmeshe.MeshGram(np.arange(8), devices=4, **F64)
    st = acc.state_dict()
    assert sorted(st) == ["count", "err", "g"]
    assert st["g"].shape == (4, 8, 8) and st["g"].dtype == np.float64
    assert acc.state_signature() == {
        "acc": "mesh_gram", "n_hat": 8,
        "support_crc": acc.state_signature()["support_crc"], "devices": 4,
        "dtype": "float64"}
    s = tmeshe.MeshStats(5, devices=4, device="cpu")
    assert sorted(s.state_dict()) == ["count", "err_sum", "err_sumsq", "sum",
                                      "sumsq"]
    assert s.state_signature()["dtype"] == "float32"


# -- the device grid ------------------------------------------------------


def _grid_problems(B=5, n=16):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(B, n, n))
    S = torch.tensor(A @ A.transpose(0, 2, 1) / n)
    X0 = torch.eye(n, dtype=torch.float64).expand(B, n, n).clone()
    return S, np.geomspace(0.05, 0.5, B), np.full(B, 1e-3), X0, [n] * B


def test_device_grid_pads_clamps_and_counts_one_launch():
    S, lams, betas, X0, nv = _grid_problems()
    key = "kernel.launches.bcd_solve_batched"
    c0 = metrics.counter(key).value
    one = ops.bcd_solve_batched(S, lams, betas, X0, nv, max_sweeps=4)
    two = ops.bcd_solve_batched(S, lams, betas, X0, nv, max_sweeps=4,
                                devices=2)
    assert metrics.counter(key).value == c0 + 2
    assert metrics.gauge("mesh.devices").value == 2.0
    for a, b in zip(one, two):
        assert a.shape == b.shape
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    eight = ops.bcd_solve_batched(S, lams, betas, X0, nv, max_sweeps=4,
                                  devices=8)
    assert metrics.gauge("mesh.devices").value == 4.0     # the lanes
    assert torch.equal(eight[0], one[0])
    one_b = ops.bcd_solve_batched(S[:1], lams[:1], betas[:1], X0[:1], nv[:1],
                                  max_sweeps=4, devices=4)   # B clamps D
    assert torch.equal(one_b[0][0], one[0][0])


def test_solve_bcd_many_device_grid_ladder():
    S, lams, _, _, _ = _grid_problems()
    Sigmas = [S[k, :12 + k, :12 + k] for k in range(5)]
    base = tbcd.solve_bcd_many(Sigmas, lams, max_sweeps=4)
    tr = trace.install(trace.Tracer())
    try:
        got = tbcd.solve_bcd_many(Sigmas, lams, max_sweeps=4, devices=4)
    finally:
        trace.install(None)
    assert "solver.device_grid" in tr.tree_str()
    for a, b in zip(base, got):
        assert torch.equal(a.X, b.X) and int(a.sweeps) == int(b.sweeps)
    metrics.reset()
    ctr = {}
    inj = tt.SolverFaultInjector(tt.dispatch_error(n=0,
                                                   match="bcd_solve_batched"))
    with tt.install_solver(inj):
        got = tbcd.solve_bcd_many(Sigmas, lams, max_sweeps=4, devices=4,
                                  counters=ctr)
    assert ctr["mesh_degraded"] == 1
    assert metrics.counter("mesh.degraded").value == 1.0
    assert all(torch.equal(a.X, b.X) for a, b in zip(base, got))
    inj = tt.SolverFaultInjector(tt.dispatch_error(n=0,
                                                   match="bcd_solve_batched"))
    with pytest.raises(tt.InjectedDispatchError), tt.install_solver(inj):
        tbcd.solve_bcd_many(Sigmas, lams, max_sweeps=4, devices=4,
                            min_devices=4)


# -- the fit and the launcher ------------------------------------------


def test_mesh_fit_equals_single_device_fit(store_path, n_mega):
    """A 4-lane fit widens each round to B*4 evaluations, so its
    single-device twin is batch_evals = B*4 with the mesh off."""
    base = dict(max_sweeps=4, lam_search_evals=8, chunk_nnz=512,
                chunk_rows=64, megabatch_chunks=2)
    d0, d4 = {}, {}
    r0 = fit_components(TStore.open(store_path), 1, target_card=3,
                        cfg=SPCAConfig(**base, batch_evals=8),
                        diagnostics=d0, device="cpu")
    r4 = fit_components(TStore.open(store_path), 1, target_card=3,
                        cfg=SPCAConfig(**base, batch_evals=2, mesh_devices=4),
                        diagnostics=d4, device="cpu")
    for a, b in zip(r0, r4):
        assert np.array_equal(a.support, b.support)
        assert a.lam == b.lam
        assert a.variance == pytest.approx(b.variance, rel=1e-6)
    assert d4["corpus_passes"] == 2 and d4["mesh_degraded"] == 0
    assert d4["ingest"]["screen_launches"] == -(-n_mega // 4)
    for comp in d4["components"]:
        assert comp["devices"] == 4 and comp["solve_launches"] == 1


def test_store_fit_with_two_lanes(store_path):
    """A store handle with ``mesh_devices=2`` fits through the mesh passes
    to the single-device fit's supports."""
    cfg = dict(max_sweeps=3, lam_search_evals=3, chunk_nnz=512,
               chunk_rows=64, megabatch_chunks=2)
    d1, d2 = {}, {}
    r1 = fit_components(TStore.open(store_path), 1, target_card=3,
                        cfg=SPCAConfig(**cfg), diagnostics=d1, device="cpu")
    r2 = fit_components(TStore.open(store_path), 1, target_card=3,
                        cfg=SPCAConfig(**cfg, mesh_devices=2),
                        diagnostics=d2, device="cpu")
    assert np.array_equal(r1[0].support, r2[0].support)
    assert d2["corpus_passes"] == 2
    assert d2["ingest"]["screen_launches"] == \
        -(-d1["ingest"]["screen_launches"] // 2)


def _fit_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith(("PC", "   "))]


def test_launcher_devices_matches_single_device(capsys):
    args = ["--streaming", "--docs", "300", "--words", "500",
            "--components", "2", "--target-card", "3", "--device", "cpu",
            "--chunk-nnz", "512", "--chunk-rows", "64", "--megabatch", "2"]
    trun.main(args)
    one = capsys.readouterr().out
    _, _, diag = trun.main(args + ["--devices", "4"])
    four = capsys.readouterr().out
    assert "sharding passes across 4 lane(s)" in four
    assert _fit_lines(four) == _fit_lines(one)
    n1 = int(one.split("ingest launches: ")[1].split()[0])
    n4 = int(four.split("ingest launches: ")[1].split()[0])
    assert n4 < n1 and diag["corpus_passes"] == 2


def test_launcher_falls_back_to_the_lanes_there_are(monkeypatch, capsys):
    monkeypatch.delenv(tmesh.FORCE_LANES_ENV)
    trun.main(["--docs", "200", "--words", "300", "--components", "1",
               "--target-card", "3", "--device", "cpu", "--devices", "4"])
    assert "falling back to 1" in capsys.readouterr().out


# -- across packages: the reference's mesh at 4 forced host devices ----

_REF = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from repro.obs import metrics
from repro.sparse import SparseCorpus
from repro.sparse.mesh_engine import (
    mesh_feature_variances, mesh_reduced_covariance)
path, ref_dir, port_dir, out = sys.argv[1:5]
geo = dict(chunk_nnz=512, chunk_rows=64, megabatch=2)
c = {}
s = mesh_feature_variances(SparseCorpus.open(path), devices=4, counters=c,
                           resume_dir=ref_dir, checkpoint_every=2, **geo)
sup = np.sort(np.argsort(-np.asarray(s.variances), kind="stable")[:40])
G = mesh_reduced_covariance(SparseCorpus.open(path), sup, devices=4,
                            means=np.asarray(s.means), counters=c,
                            resume_dir=ref_dir, checkpoint_every=2, **geo)
cp = {}
sp = mesh_feature_variances(SparseCorpus.open(path), devices=4, counters=cp,
                            resume_dir=port_dir, checkpoint_every=2, **geo)
np.savez(out, var=np.asarray(s.variances), mean=np.asarray(s.means),
         G=np.asarray(G), sup=sup, var_from_port=np.asarray(sp.variances))
names = ("ingest.shard.chunks", "ingest.shard.nnz", "ingest.screen_launches",
         "ingest.gram_launches", "ingest.chunks", "mesh.devices")
print(json.dumps({"counters": {k: v for k, v in c.items()
                               if not k.startswith("prefetch")},
                  "port_counters": {k: v for k, v in cp.items()
                                    if not k.startswith("prefetch")},
                  "registry": {k: metrics.get_registry().value(k)
                               for k in names}}))
"""


def test_mesh_pass_crosses_packages_both_ways(store_path, tmp_path):
    """The reference's mesh pass at 4 forced host devices (in a child, as
    its own tests run it): the port's 4-lane pass equals its moments and
    diagnostics, resumes from its pass checkpoints, and the reference
    resumes from the port's."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    metrics.reset()
    c = {}
    scr = tmeshe.mesh_feature_variances(
        TStore.open(store_path), devices=4, counters=c, resume_dir=port_dir,
        checkpoint_every=2, **GEOM, **F64)
    tregistry = {k: metrics.get_registry().value(k) for k in (
        "ingest.shard.chunks", "ingest.shard.nnz", "ingest.screen_launches",
        "ingest.chunks", "mesh.devices")}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    out = str(tmp_path / "ref.npz")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF),
                        store_path, ref_dir, port_dir, out],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    want = np.load(out)
    np.testing.assert_allclose(scr.variances.numpy(), want["var"], atol=1e-9)
    np.testing.assert_allclose(scr.means.numpy(), want["mean"], atol=1e-9)
    # the reference resumed the port's complete checkpoint: nothing streamed
    assert ref["port_counters"].get("screen_launches", 0) == 0
    assert ref["port_counters"]["resumed_megabatches"] > 0
    np.testing.assert_allclose(want["var_from_port"], want["var"], atol=1e-9)
    # diagnostics and lane counters: the child ran a screen and a Gram pass
    # of equal economics, the port a screen pass
    mine = {k: v for k, v in c.items() if not k.startswith("prefetch")}
    assert sorted(mine) == ["chunks", "resume_checkpoints", "screen_launches",
                            "screen_passes"]
    for k in ("screen_launches", "screen_passes"):
        assert mine[k] == ref["counters"][k], k
    for k in ("chunks", "resume_checkpoints"):
        assert 2 * mine[k] == ref["counters"][k], k
    assert ref["counters"]["gram_launches"] == mine["screen_launches"]
    for k, v in tregistry.items():
        want_v = ref["registry"][k]
        if k in ("ingest.shard.chunks", "ingest.shard.nnz", "ingest.chunks"):
            want_v /= 2      # the child ran a screen and a Gram pass
        assert v == want_v, k
    # the port resumes the reference's checkpoints with nothing streamed
    c2 = {}
    got = tmeshe.mesh_feature_variances(
        TStore.open(store_path), devices=4, counters=c2, resume_dir=ref_dir,
        checkpoint_every=2, **GEOM, **F64)
    assert c2.get("screen_launches", 0) == 0 and c2["resumed_megabatches"] > 0
    np.testing.assert_allclose(got.variances.numpy(), want["var"], atol=1e-9)
    G = tmeshe.mesh_reduced_covariance(
        TStore.open(store_path), want["sup"], devices=4, means=want["mean"],
        counters=c2, resume_dir=ref_dir, checkpoint_every=2, **GEOM, **F64)
    assert c2.get("gram_launches", 0) == 0
    np.testing.assert_allclose(G.numpy(), want["G"],
                               atol=1e-6 * np.abs(want["G"]).max())
