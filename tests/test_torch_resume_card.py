"""Kill-and-resume on the card: the streaming passes through kernels K2
and K3 and the lambda search through K1, killed by an injected fault and
resumed in the same process, against uninterrupted runs on the card.

This file imports no jax, so it runs on a machine with a card and no jax
(``pytest --noconftest -m gpu tests/test_torch_resume_card.py``); without
a card its tests skip.  Tolerance: exact.  A resumed pass restores its
saved state to the device unchanged and folds the remaining megabatches
through the same kernels in the same order, and K2 and K3 are run-to-run
deterministic (K2 adds in float64 and rounds once, K3 sums its partials
in a fixed order), so ``sum``/``sumsq`` and ``g``/``err`` must equal the
uninterrupted pass's bit for bit; a kill leaves the kernels' per-stream
workspaces at rest, so a later clean pass equals the first.
"""
import glob
import os

import numpy as np
import pytest
import torch

from repro_torch.data.corpus import make_corpus
from repro_torch.sparse import SparseCorpus, engine, resume, write_corpus
from repro_torch.testing import FaultInjector, fail_nth_read, install

GEOM = dict(chunk_nnz=2048, chunk_rows=128, megabatch=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.fixture
def store(tmp_path):
    c = make_corpus(3000, 2000, topics={"t": ["a", "b", "c"]}, seed=5)
    write_corpus(c, str(tmp_path / "store"), shard_nnz=20_000)
    s = SparseCorpus.open(str(tmp_path / "store"))
    assert s.n_shards >= 4
    return s


def _pass(kind, store, dev, support=None, means=None, **kw):
    if kind == "screen":
        s = engine.sparse_feature_variances(store, device=dev, **GEOM, **kw)
        return torch.stack([s.variances, s.means]).cpu().numpy()
    return engine.sparse_reduced_covariance(store, support, means=means,
                                            device=dev, **GEOM,
                                            **kw).cpu().numpy()


def _state(rd, kind):
    (d,) = glob.glob(os.path.join(rd, f"pass_{kind}_*"))
    with np.load(os.path.join(d, resume.STATE_NAME)) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["screen", "gram"])
def test_pass_killed_on_card_resumes_bit_for_bit(cuda, store, tmp_path, kind):
    scr = engine.sparse_feature_variances(store, device=cuda, **GEOM)
    var, means = scr.variances.cpu().numpy(), scr.means.cpu().numpy()
    support = np.sort(np.argsort(-var, kind="stable")[:200])
    kw = dict(support=support, means=means)
    rd0 = str(tmp_path / "clean")
    clean = _pass(kind, store, cuda, resume_dir=rd0, checkpoint_every=1,
                  **kw)
    probe = FaultInjector()
    with install(probe):
        _pass(kind, store, cuda, **kw)
    rd = str(tmp_path / "resume")
    store.set_io_policy(io_retries=0)
    kill = FaultInjector(fail_nth_read(probe.reads // 2, match="*.npy",
                                       times=10**9))
    with install(kill), pytest.raises(OSError, match="injected"):
        _pass(kind, store, cuda, resume_dir=rd, checkpoint_every=1, **kw)
    ctr: dict = {}
    got = _pass(kind, store, cuda, resume_dir=rd, checkpoint_every=1,
                counters=ctr, **kw)
    assert ctr["resumed_megabatches"] > 0
    np.testing.assert_array_equal(got, clean)
    want, have = _state(rd0, kind), _state(rd, kind)
    assert sorted(have) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k])
    # the kill left the kernels' workspaces at rest: a clean pass now
    # equals the first one
    np.testing.assert_array_equal(_pass(kind, store, cuda, **kw), clean)


@pytest.mark.gpu
def test_pass_deadline_on_card_resumes_to_the_same_screen(cuda, store,
                                                          tmp_path):
    from repro_torch.obs.health import PassDeadlineError

    clean = _pass("screen", store, cuda)
    rd = str(tmp_path / "r")
    with pytest.raises(PassDeadlineError):
        _pass("screen", store, cuda, pass_deadline_s=0.0, resume_dir=rd,
              checkpoint_every=1)
    np.testing.assert_array_equal(
        _pass("screen", store, cuda, resume_dir=rd, checkpoint_every=1),
        clean)


@pytest.mark.gpu
def test_fit_killed_mid_search_on_card_resumes_identically(cuda, tmp_path):
    from repro_torch.core import SPCAConfig, fit_components
    from repro_torch.testing import (
        InjectedDispatchError, SolverFaultInjector, dispatch_error,
        install_solver)

    rng = np.random.default_rng(0)
    A = rng.standard_normal((400, 60))
    A[:, :6] += 3 * rng.standard_normal((400, 1))
    A = torch.tensor(A, dtype=torch.float32, device=cuda)
    cfg = dict(max_sweeps=8, lam_search_evals=6)
    d0: dict = {}
    clean = fit_components(A, 3, target_card=5, cfg=SPCAConfig(**cfg),
                           diagnostics=d0)
    rd = str(tmp_path / "r")
    inj = SolverFaultInjector(dispatch_error(
        n=d0["components"][0]["evals"] + 1, match="bcd_solve"))
    with install_solver(inj), pytest.raises(InjectedDispatchError):
        fit_components(A, 3, target_card=5,
                       cfg=SPCAConfig(resume_dir=rd, **cfg))
    diag: dict = {}
    got = fit_components(A, 3, target_card=5, diagnostics=diag,
                         cfg=SPCAConfig(resume_dir=rd, **cfg))
    assert diag["fit_resume"]["components_restored"] == 1
    for r1, r0 in zip(got, clean):
        np.testing.assert_array_equal(r1.support, r0.support)
        assert (r1.lam, r1.variance) == (r0.lam, r0.variance)
