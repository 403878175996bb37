"""The lane mesh on the card: the device grid of kernel K1 and a 2-lane
mesh pass through kernels K2 and K3, on lanes forced onto the cards there
are (``REPRO_TORCH_FORCE_LANES``).

This file imports no jax, so it runs on a machine with a card and no jax
(``pytest --noconftest -m gpu tests/test_torch_mesh_card.py``); without a
card its tests skip.  Tolerance: exact.  K1 solves each problem in its
own CTA, so a problem's bits do not depend on the lane that solved it;
K2 and K3 are run-to-run deterministic and the lane partials meet in
lane order, so a repeated mesh pass is the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bcd
from repro_torch.data.corpus import make_corpus
from repro_torch.kernels import bcd_fused, csr_gram, csr_stats, ops
from repro_torch.launch.mesh import FORCE_LANES_ENV
from repro_torch.sparse import SparseCorpus, mesh_engine, write_corpus
from repro_torch.testing import covariance_problems

GEOM = dict(chunk_nnz=2048, chunk_rows=128, megabatch=2)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    monkeypatch.setenv(FORCE_LANES_ENV, "4")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_grid_is_bit_equal_to_one_launch(cuda, dtype):
    """Spiked covariances (BCD converges on them) at the dense fit's
    sizes: 4 lanes give one launch's bits for every result, NaN included
    where float32 ends non-finite on one of them."""
    rng = np.random.default_rng(0)
    sizes = [48, 96, 128, 192, 64]
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    S, X0, lams, betas = covariance_problems(rng, sizes, 192, np_dtype,
                                             spike=True)
    Sigmas = [torch.tensor(S[b, :n, :n], device=cuda)
              for b, n in enumerate(sizes)]
    one = bcd.solve_bcd_many(Sigmas, lams, max_sweeps=6)
    k1 = bcd_fused.launches
    four = bcd.solve_bcd_many(Sigmas, lams, max_sweeps=6, devices=4)
    assert bcd_fused.launches - k1 == 4           # one K1 launch a lane

    def same(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)

    for a, b in zip(one, four):
        same(a.X, b.X)
        same(a.kernel_obj, b.kernel_obj)
        same(a.history, b.history)
        assert int(a.sweeps) == int(b.sweeps)
    S_t, X0_t = (torch.tensor(x, device=cuda) for x in (S, X0))
    eight = ops.bcd_solve_batched(S_t, lams, betas, X0_t, sizes,
                                  max_sweeps=6, devices=8)
    ref = ops.bcd_solve_batched(S_t, lams, betas, X0_t, sizes, max_sweeps=6)
    for a, b in zip(eight, ref):
        same(a, b)


@pytest.mark.gpu
def test_two_lane_pass_repeats_bit_for_bit(cuda, tmp_path):
    c = make_corpus(3000, 2000, topics={"t": ["a", "b", "c"]}, seed=5)
    write_corpus(c, str(tmp_path / "store"), shard_nnz=20_000)
    store = SparseCorpus.open(str(tmp_path / "store"))
    k2, k3 = csr_stats.launches, csr_gram.launches
    runs = []
    for _ in range(2):
        scr = mesh_engine.mesh_feature_variances(store, devices=2,
                                                 device=cuda, **GEOM)
        sup = np.sort(np.argsort(-scr.variances.cpu().numpy(),
                                 kind="stable")[:96])
        G = mesh_engine.mesh_reduced_covariance(
            store, sup, devices=2, means=scr.means.cpu().numpy(),
            device=cuda, **GEOM)
        runs.append((scr.variances.cpu(), scr.means.cpu(), G.cpu()))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    n_mega = -(-store.n_chunks(2048, 128) // 2)
    assert csr_stats.launches - k2 == 2 * n_mega     # one a real lane
    assert csr_gram.launches - k3 == 2 * n_mega
