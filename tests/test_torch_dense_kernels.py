"""The port's dense-block kernels' wrappers (``ops.column_stats``,
``ops.column_variances``, ``ops.gram``: K5 and K6) and the per-row
box-QP wrapper (``ops.qp_sweeps``: K7) against the reference's Pallas
kernels run in interpret mode and its ``repro.kernels.ref`` oracles, on
the same numpy inputs, on the CPU (where the wrappers run the kernels'
plain versions; the kernels themselves are held to those on the card by
the ``gpu`` tests of ``test_torch_package.py`` and by ``chip_smoke.py``).

Tolerances, each for its reason:
  * column stats and Gram of integer counts: exact (every partial sum is
    an integer below 2^24, so float32 adds it exactly in any order);
  * of random floats: elementwise 2 gamma_m |A|^T|A| (Gram) or 2 gamma_m
    sum |a| and sum a^2 (stats), gamma_m = m 2^-24 / (1 - m 2^-24): the
    bound on two float32 sums of the same m terms in any two orders;
  * the box QP in float64, 1e-13 of the largest |value|: the same scalar
    steps, w = Y u0 and R2 = u.w reduced in another order;
  * in float32, 1e-4 of the largest |value|: those reductions' order moves
    w0 and R2 by ~n 2^-24 relative, and the clipped steps carry that on.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bcd_sweep import qp_sweep_pallas
from repro.kernels.gram import gram_pallas
from repro.kernels.variance import column_stats_pallas
from repro_torch.kernels import bcd_sweep, gram, ops, ref, variance
from repro_torch.obs import metrics
from repro_torch.testing.tf32 import gram_3xtf32, split_tf32

U32 = 2.0 ** -24


def _gamma(m):
    return m * U32 / (1 - m * U32)


def _block(shape, kind, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if kind == "counts":     # a bag-of-words block: sparse integer counts
        A = rng.poisson(0.3, size=shape) * rng.integers(1, 9, size=shape)
    else:
        A = rng.normal(size=shape) * rng.lognormal(size=shape[1])
    return A.astype(dtype)


def _close(got, want, bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= bound), float(
        np.max(np.abs(got - want) - bound))


SHAPES = [(37, 300), (256, 513), (1, 7), (130, 129)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind,dtype", [("counts", np.float32),
                                        ("floats", np.float32),
                                        ("floats", np.float64)])
def test_column_stats_matches_reference(shape, kind, dtype):
    A = _block(shape, kind, seed=shape[0] * shape[1], dtype=dtype)
    got = ops.column_stats(torch.from_numpy(A))
    pallas = column_stats_pallas(jnp.asarray(A), interpret=True)
    oracle = jref.column_stats_ref(jnp.asarray(A))
    A32 = A.astype(np.float32).astype(np.float64)
    bounds = (2 * _gamma(shape[0]) * np.abs(A32).sum(0),
              2 * _gamma(shape[0] + 1) * (A32 * A32).sum(0))
    for k in range(2):
        assert got[k].dtype == torch.float32 and got[k].shape == (shape[1],)
        for want in (pallas[k], oracle[k]):
            if kind == "counts":
                assert np.array_equal(got[k].numpy(), np.asarray(want))
            else:
                _close(got[k].numpy(), want, bounds[k])


@pytest.mark.parametrize("shape", [(37, 45), (256, 130), (5, 1), (129, 33)])
@pytest.mark.parametrize("kind", ["counts", "floats"])
def test_gram_matches_reference(shape, kind):
    A = _block(shape, kind, seed=7 * shape[0] + shape[1])
    got = ops.gram(torch.from_numpy(A))
    assert got.dtype == torch.float32 and got.shape == (shape[1],) * 2
    A64 = np.abs(A.astype(np.float64))
    bound = 2 * _gamma(shape[0] + 1) * (A64.T @ A64)
    for want in (gram_pallas(jnp.asarray(A), interpret=True),
                 jref.gram_ref(jnp.asarray(A))):
        if kind == "counts":
            assert np.array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got.numpy(), want, bound)


@pytest.mark.parametrize("m,n,split,slab_rows,blocks", [
    (256, 500, 8, 32, 36 * 8),      # the path's block: 36 tiles, rows split
    (256, 2048, 1, 256, 528),       # 528 tiles fill the card: no split
    (37, 1, 2, 32, 2),              # one tile, two panels of rows
])
def test_plan_gram_splits_rows_only_where_tiles_leave_sms_idle(m, n, split,
                                                               slab_rows,
                                                               blocks):
    plan = gram.plan_gram(m, n)
    n_tiles = -(-n // 64)
    assert (plan.tile, plan.n_tiles) == (64, n_tiles)
    assert plan.tiles == n_tiles * (n_tiles + 1) // 2
    assert (plan.split, plan.slab_rows, plan.blocks) == (split, slab_rows,
                                                         blocks)
    assert plan.split * plan.slab_rows >= m > (plan.split - 1) * plan.slab_rows
    assert plan.smem_bytes == 3 * 2 * 32 * 64 * 4
    assert gram.plan_gram(0, 5).split == 1
    with pytest.raises(ValueError):
        gram.plan_gram(4, 0)


def test_tf32_split_is_exact_on_counts_up_to_2048():
    """(a) Integer counts up to 2048 have at most 11 significant bits: the
    split leaves lo = 0 and the emulated tensor-core Gram equals the
    plain version exactly (every partial sum an integer below 2^24)."""
    rng = np.random.default_rng(15)
    A = _block((256, 500), "counts", seed=15)
    rows = rng.choice(256, size=60, replace=False)
    cols = rng.choice(500, size=60, replace=False)
    A[rows, cols] = rng.choice([2048, 2047, 1025, 1023, 513], size=60)
    ints = torch.arange(2049, dtype=torch.float32)
    hi, lo = split_tf32(ints)
    assert torch.equal(hi, ints) and not lo.any()
    At = torch.from_numpy(A)
    assert float((At.double().T @ At.double()).abs().max()) < 2 ** 24
    for slab_rows in (None, gram.plan_gram(*A.shape).slab_rows):
        assert torch.equal(gram_3xtf32(At, slab_rows), ref.gram_ref(At))


@pytest.mark.parametrize("shape", [(256, 500), (48, 500), (37, 1), (65, 33)])
def test_tf32_split_gram_within_the_card_bar(shape):
    """(b) On random normal blocks the emulated 3xTF32 Gram lies within
    2 gamma_(m+1) |A|^T |A| of the plain version, the bar the card's K6
    is held to; and it is exactly symmetric."""
    A = torch.from_numpy(np.random.default_rng(shape[0] + shape[1]).normal(
        size=shape).astype(np.float32))
    got = gram_3xtf32(A, gram.plan_gram(*shape).slab_rows)
    Ad = A.double().abs()
    bound = 2 * _gamma(shape[0] + 1) * (Ad.T @ Ad)
    _close(got.numpy(), ref.gram_ref(A).numpy(), bound.numpy())
    assert torch.equal(got, got.T)


def test_column_variances_matches_reference():
    A = _block((90, 61), "counts", seed=3)
    mean, var = ops.column_variances(torch.from_numpy(A))
    jmean, jvar = jops.column_variances(jnp.asarray(A), impl="ref")
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5,
                               atol=1e-6)
    assert float(var.min()) >= 0.0


def _qp_case(n, j, seed, dtype):
    """A row update's box QP: Y = X with row/col j zeroed (X symmetric
    PSD, as the BCD iterate), s = Sigma[:, j] masked, u0 = s."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n + 7, n))
    X = F.T @ F / (n + 7) + 0.1 * np.eye(n)
    G = rng.normal(size=(n + 3, n))
    S = G.T @ G / (n + 3)
    m = np.ones(n)
    m[j] = 0.0
    Y = (X * m[:, None] * m[None, :]).astype(dtype)
    s = (S[:, j] * m).astype(dtype)
    lam = 0.4 * float(np.abs(s).max())
    return Y, s, lam


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,j,sweeps", [(9, 0, 1), (24, 5, 4), (40, 39, 3)])
def test_qp_sweeps_matches_reference(dtype, n, j, sweeps):
    Y, s, lam = _qp_case(n, j, seed=n + j, dtype=dtype)
    got = ops.qp_sweeps(torch.from_numpy(Y), torch.from_numpy(s), lam,
                        torch.from_numpy(s), j, sweeps=sweeps)
    args = (jnp.asarray(Y), jnp.asarray(s), lam, jnp.asarray(s), j)
    rtol = 1e-13 if dtype == np.float64 else 1e-4
    for want in (qp_sweep_pallas(*args, sweeps=sweeps, interpret=True),
                 jref.qp_sweep_ref(*args, sweeps)):
        for g, w in zip(got, want):
            assert g.dtype == torch.from_numpy(Y).dtype
            w = np.asarray(w)
            assert g.shape == w.shape
            scale = max(1.0, float(np.abs(w).max()))
            assert float(np.abs(g.numpy() - w).max()) <= rtol * scale
    assert float(got[0][j]) == float(s[j]) == 0.0     # pinned coordinate
    box = np.abs(got[0].numpy().astype(np.float64) - s) <= lam * (1 + 1e-6)
    assert box.all()


def test_wrappers_refuse_cuda_on_cpu_and_count_dispatches():
    A = torch.ones((4, 6))
    Y, s, lam = _qp_case(6, 2, seed=0, dtype=np.float64)
    Y, s = torch.from_numpy(Y), torch.from_numpy(s)
    with pytest.raises(ValueError, match="CUDA"):
        ops.column_stats(A, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.gram(A, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.qp_sweeps(Y, s, lam, s, 2, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.gram(A, impl="pallas")
    before = (variance.launches, gram.launches, bcd_sweep.launches)
    with metrics.use_registry() as reg:
        ops.column_stats(A)
        ops.column_stats(A.numpy(), device="cpu")
        ops.column_variances(A, impl="ref")
        ops.gram(A)
        ops.gram(A.double().numpy(), device="cpu")
        ops.qp_sweeps(Y, s, lam, s, 2, sweeps=2)
        assert reg.value("kernel.launches.column_stats") == 3
        assert reg.value("kernel.launches.gram") == 2
        assert reg.value("kernel.launches.qp_sweeps") == 1
    # on the CPU the plain versions run: no kernel launched
    assert (variance.launches, gram.launches, bcd_sweep.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    A = torch.ones((4, 6))
    with pytest.raises(ValueError, match="CUDA"):
        variance.column_stats_cuda(A)
    with pytest.raises(ValueError, match="CUDA"):
        gram.gram_cuda(A)
    Y = torch.eye(5, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        bcd_sweep.qp_sweep_cuda(Y, Y[0], 0.1, Y[0], 0, 2)


@pytest.mark.parametrize("n,itemsize,scheme,slots,threads", [
    (224, 4, "warp", 7, 32), (225, 4, "block", 0, 256),
    (160, 8, "warp", 5, 32), (161, 8, "block", 0, 192),
    (1, 4, "warp", 1, 32), (1, 8, "warp", 1, 32),
    (19_365, 4, "block", 0, 512), (9_680, 8, "block", 0, 512)])
def test_plan_qp_sweep_picks_the_scheme_by_size(n, itemsize, scheme, slots,
                                                threads):
    """K7's plan: one warp with Y in shared memory up to n_pad 224
    (float32) / 160 (float64), the block-wide CTA beyond, up to the n
    whose u, w and s fit shared memory (19,365 / 9,680)."""
    plan = bcd_sweep.plan_qp_sweep(n, itemsize)
    assert (plan.scheme, plan.slots, plan.threads) == (scheme, slots, threads)
    assert plan.n_pad == max(32, -(-n // 32) * 32)
    assert plan.smem_bytes <= bcd_sweep.SMEM_LIMIT_BYTES
    assert bcd_sweep.plan_qp_sweep(n, itemsize, scheme) == plan
    if scheme == "warp":
        assert plan.smem_bytes == (plan.n_pad ** 2 + plan.n_pad + 32) \
            * itemsize + 16
        assert bcd_sweep.plan_qp_sweep(n, itemsize, "block").threads \
            == plan.n_pad
    else:
        with pytest.raises(ValueError, match="shared memory"):
            bcd_sweep.plan_qp_sweep(n, itemsize, "warp")


@pytest.mark.parametrize("n,itemsize,scheme", [
    (19_366, 4, "auto"), (9_681, 8, "block"), (225, 4, "warp"),
    (8, 4, "global")])
def test_plan_qp_sweep_refuses_what_does_not_fit(n, itemsize, scheme):
    with pytest.raises(ValueError, match="shared memory|unknown scheme"):
        bcd_sweep.plan_qp_sweep(n, itemsize, scheme)
