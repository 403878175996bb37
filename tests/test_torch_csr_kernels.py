"""The port's CSR kernels K2 (column stats) and K3 (gather-Gram): their plain
versions (``repro_torch.kernels.ref``) and wrappers (``kernels.ops``)
against the reference's oracles (``repro.kernels.ref``) and its Pallas
kernels in interpret mode, on the same seeded numpy inputs, at the chunk
edge cases the store produces: padding (value 0, col 0, seg 0), off-support
sentinels, a ragged megabatch with empty slots, an empty support.

Tolerance: relative to the largest entry of the result, 1e-5.  Both sides
round to float32, but in other orders (the reference's oracle scatters in
float32, the port's stats accumulate in float64; Pallas contracts one-hot
tiles; the Gram's B^T B runs in another BLAS); a float32 sum of k terms
moves by up to ~k * 6e-8 of its largest term, and columns here collect up
to ~150 terms.  Never bit-equality (ROADMAP queue 3: the reference's own
``atol=0`` bars fail).  The kernels themselves run only on a card:
``tests/test_torch_package.py`` holds them to the plain versions there
(``gpu``-marked, in a file that imports no jax).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.csr_gram import csr_gram_batched_pallas, csr_gram_pallas
from repro.kernels.csr_stats import csr_column_stats_pallas
from repro_torch.kernels import csr_gram as tgram
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.obs import metrics

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _megabatch(C, E, R, n, *, nnz, seed, n_sentinel=0):
    """C padded chunks in the store's layout: chunk c holds ``nnz[c]`` real
    entries at distinct (row, col) in [0, R) x [0, n + n_sentinel) (the
    columns >= n are off-support sentinels), rows unsorted, then padding
    (value 0, col 0, seg 0)."""
    rng = np.random.default_rng(seed)
    vals = np.zeros((C, E), np.float32)
    cols = np.zeros((C, E), np.int32)
    segs = np.zeros((C, E), np.int32)
    for c, k in enumerate(nnz):
        cells = rng.choice(R * (n + n_sentinel), size=k, replace=False)
        vals[c, :k] = rng.normal(size=k)
        segs[c, :k] = cells // (n + n_sentinel)
        cols[c, :k] = cells % (n + n_sentinel)
    return vals, cols, segs


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------ K2 column stats

@pytest.mark.parametrize("C,E,n,nnz", [
    (1, 512, 300, [512]),            # one full chunk
    (3, 384, 129, [384, 200, 7]),    # ragged chunks
    (4, 256, 50, [256, 100, 0, 0]),  # ragged batch: empty slots at the end
    (2, 1000, 200, [0, 0]),          # all padding
])
def test_csr_stats_plain_matches_reference(C, E, n, nnz):
    vals, cols, _ = _megabatch(C, E, 8, n, nnz=nnz, seed=C * E + n)
    s_t, ss_t = tref.csr_column_stats_batched_ref(*_t(vals, cols), n)
    s_j, ss_j = jref.csr_column_stats_batched_ref(jnp.asarray(vals),
                                                  jnp.asarray(cols), n)
    s_p, ss_p = csr_column_stats_pallas(jnp.asarray(vals), jnp.asarray(cols),
                                        n, block_e=128, interpret=True)
    assert s_t.dtype == ss_t.dtype == torch.float32
    for got, want in ((s_t, s_j), (ss_t, ss_j), (s_t, s_p), (ss_t, ss_p)):
        _close(got.numpy(), want)
    # one chunk's flat form is the same reduction
    s1, ss1 = tref.csr_column_stats_ref(*_t(vals[0], cols[0]), n)
    s1_j, ss1_j = jref.csr_column_stats_ref(jnp.asarray(vals[0]),
                                            jnp.asarray(cols[0]), n)
    _close(s1.numpy(), s1_j)
    _close(ss1.numpy(), ss1_j)


def test_csr_stats_drops_columns_past_n():
    vals = np.array([1.0, 2.0, 4.0, 8.0], np.float32)
    cols = np.array([0, 5, 6, 9], np.int32)
    s, ss = tref.csr_column_stats_ref(*_t(vals, cols), 6)
    s_j, ss_j = jref.csr_column_stats_ref(jnp.asarray(vals),
                                          jnp.asarray(cols), 6)
    np.testing.assert_array_equal(s.numpy(), [1, 0, 0, 0, 0, 2])
    _close(s.numpy(), s_j)
    _close(ss.numpy(), ss_j)


# ----------------------------------------------------------- K3 gather-Gram

@pytest.mark.parametrize("C,E,R,n_hat,nnz", [
    (1, 128, 8, 7, [100]),             # tiny support, one chunk
    (3, 256, 16, 100, [256, 90, 0]),   # sentinels dropped; empty slot
    (4, 512, 32, 130, [512, 512, 300, 1]),  # n_hat past a 128 tile
    (2, 64, 5, 40, [60, 0]),           # R not a multiple of 8
])
def test_csr_gram_plain_matches_reference(C, E, R, n_hat, nnz):
    vals, cols, segs = _megabatch(C, E, R, n_hat, nnz=nnz, seed=C + E + R,
                                  n_sentinel=25)
    G_t = tref.csr_gram_batched_ref(*_t(vals, cols, segs), R, n_hat)
    args = [jnp.asarray(a) for a in (vals, cols, segs)]
    G_j = jref.csr_gram_batched_ref(*args, R, n_hat)
    G_p = csr_gram_batched_pallas(*args, R, n_hat, interpret=True)
    assert G_t.dtype == torch.float32 and G_t.shape == (n_hat, n_hat)
    _close(G_t.numpy(), G_j)
    _close(G_t.numpy(), G_p)
    # the single-chunk Gram (TPU kernel _kernel) is the same function at C=1
    for c in range(C):
        one = [a[c] for a in (vals, cols, segs)]
        G1 = tref.csr_gram_ref(*_t(*one), R, n_hat)
        _close(G1.numpy(), csr_gram_pallas(*[jnp.asarray(a) for a in one], R,
                                           n_hat, interpret=True))
        _close(G1.numpy(), jref.csr_gram_ref(*[jnp.asarray(a) for a in one],
                                             R, n_hat))


def test_csr_gram_padding_never_clobbers_row0_col0():
    """A padded slot points at (seg 0, col 0), a real cell: it must add 0,
    not overwrite the real entry there."""
    vals = np.array([3.0, 2.0, 0.0, 0.0], np.float32)
    cols = np.array([0, 1, 0, 0], np.int32)
    segs = np.array([0, 0, 0, 0], np.int32)
    G = tref.csr_gram_ref(*_t(vals, cols, segs), 4, 2)
    np.testing.assert_array_equal(G.numpy(), [[9, 6], [6, 4]])


def test_csr_gram_plain_drops_rows_past_n_rows():
    vals = np.array([1.0, 5.0], np.float32)
    cols = np.array([0, 0], np.int32)
    segs = np.array([[1, 4]], np.int32)
    G = tref.csr_gram_batched_ref(*_t(vals[None], cols[None], segs), 4, 1)
    np.testing.assert_array_equal(G.numpy(), [[1.0]])


def test_empty_support_gives_an_empty_gram():
    vals, cols, segs = _megabatch(2, 64, 8, 10, nnz=[30, 5], seed=3)
    local = np.zeros_like(cols)          # every entry is the sentinel 0 >= 0
    G = ops.csr_gram_batched(vals, local, segs, n_rows=8, n_hat=0,
                             device="cpu")
    G_j = jref.csr_gram_batched_ref(jnp.asarray(vals), jnp.asarray(local),
                                    jnp.asarray(segs), 8, 0)
    assert G.shape == (0, 0) == tuple(G_j.shape)
    assert tref.csr_gram_ref(*_t(vals[0], local[0], segs[0]), 8, 0).shape \
        == (0, 0)


# ---------------------------------------------------------------- wrappers

def test_ops_wrappers_take_host_arrays_and_count_launches():
    vals, cols, segs = _megabatch(3, 128, 16, 40, nnz=[128, 50, 0], seed=5)
    nnz = np.array([128, 50, 0])
    with metrics.use_registry() as reg:
        s, ss = ops.csr_column_stats(vals, cols, n=40, nnz=nnz, device="cpu")
        G = ops.csr_gram_batched(vals, cols, segs, n_rows=16, n_hat=40,
                                 nnz=nnz, device="cpu")
        G1 = ops.csr_gram(vals[1], cols[1], segs[1], n_rows=16, n_hat=40,
                          nnz=50, device="cpu")
        ops.csr_gram(vals[1], cols[1], segs[1], n_rows=16, n_hat=40,
                     device="cpu")
        assert reg.value("kernel.launches.csr_column_stats") == 1
        assert reg.value("kernel.launches.csr_gram_batched") == 1
        assert reg.value("kernel.launches.csr_gram") == 2
    assert s.device.type == G.device.type == "cpu"
    s_j, ss_j = jref.csr_column_stats_batched_ref(jnp.asarray(vals),
                                                  jnp.asarray(cols), 40)
    _close(s.numpy(), s_j)
    _close(ss.numpy(), ss_j)
    _close(G.numpy(), jref.csr_gram_batched_ref(
        *[jnp.asarray(a) for a in (vals, cols, segs)], 16, 40))
    _close(G1.numpy(), jref.csr_gram_ref(
        *[jnp.asarray(a[1]) for a in (vals, cols, segs)], 16, 40))


def test_ops_padding_contract_asserted():
    v = np.zeros((2, 64), np.float32)
    c = np.zeros((2, 64), np.int32)
    s = np.zeros((2, 64), np.int32)
    v[1, 7] = 3.0                       # slot past nnz[1] = 0
    with pytest.raises(ValueError, match="padding contract"):
        ops.csr_column_stats(v, c, n=10, nnz=np.array([64, 0]), device="cpu")
    with pytest.raises(ValueError, match="padding contract"):
        ops.csr_gram_batched(v, c, s, n_rows=4, n_hat=10,
                             nnz=np.array([64, 0]), device="cpu")
    with pytest.raises(ValueError, match="padding contract"):
        ops.csr_gram(torch.from_numpy(v[1]), c[1], s[1], n_rows=4, n_hat=10,
                     nnz=0)
    v[1, 7] = 0.0
    v[0, :5] = 1.0
    s_out, _ = ops.csr_column_stats(v, c, n=10, nnz=np.array([5, 0]),
                                    device="cpu")
    assert float(s_out[0]) == 5.0


def test_impl_cuda_on_cpu_tensors_raises():
    vals, cols, segs = _t(*_megabatch(1, 32, 4, 8, nnz=[10], seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        ops.csr_column_stats(vals, cols, n=8, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.csr_gram_batched(vals, cols, segs, n_rows=4, n_hat=8,
                             impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.csr_gram(vals[0], cols[0], segs[0], n_rows=4, n_hat=8,
                     impl="cuda")


def test_gram_plan_has_no_support_cap_but_a_row_cap():
    budget = tgram.SMEM_LIMIT_BYTES - tgram.STATIC_RESERVE
    # the streaming fit's megabatch: 128-wide tiles, 4 interleaved row
    # slabs of 128 rows, a CTA per (tile, chunk, slab) and a chunk per
    # CTA: 3 x 8 x 4 = 96 CTAs of one per SM, so one wave on 132 SMs
    plan = tgram.plan_csr_gram(220, 512, 8)
    assert (plan.tile, plan.n_tiles, plan.tiles) == (128, 2, 3)
    assert (plan.slabs, plan.panel_rows) == (4, 128)
    assert (plan.groups, plan.chunks_per_group, plan.parts) == (8, 1, 32)
    assert plan.blocks == 96 <= tgram.SMS
    assert plan.smem_bytes == 2 * 128 * 128 * 4 + tgram.STAGING_BYTES <= budget
    assert 2 * plan.smem_bytes > tgram.SMEM_LIMIT_BYTES   # one CTA an SM
    # a lone chunk takes more slabs while the card has SMs to spare
    assert tgram.plan_csr_gram(220, 512, 1).slabs == 8
    # no support cap: any n_hat takes one launch
    big = tgram.plan_csr_gram(2048, 512, 8)
    assert big.n_tiles == 16 and big.blocks == 16 * 17 // 2 * 8 * 4
    assert tgram.plan_csr_gram(1, 1).blocks == 8
    # the PR 12 kernel's largest R still fits; many chunks are grouped in
    # order so a tile's chunk groups stay one cluster
    assert tgram.plan_csr_gram(100, 908, 8).slabs == 8
    many = tgram.plan_csr_gram(100, 512, 20)
    assert (many.groups, many.chunks_per_group) == (7, 3)
    assert many.groups <= tgram.MAX_CLUSTER
    assert many.groups * many.chunks_per_group >= 20
    assert (many.groups - 1) * many.chunks_per_group < 20
    # the row cap: 8 slabs of 152 rows
    assert tgram.plan_csr_gram(100, 1216, 8).slabs == 8
    with pytest.raises(ValueError, match="shared memory"):
        tgram.plan_csr_gram(100, 1217)


@pytest.mark.parametrize("entries,n,blocks,slots", [
    (8 * 16384, 102_660, 128, 2048),   # the streaming fit's megabatch
    (16384, 102_660, 26, 2048),        # one chunk: the finish sets the grid
    (40 * 16384, 700_000, 132, 4096),  # one CTA an SM; the table clamped
    (0, 5, 1, 256),                    # an empty megabatch still writes zeros
    (3, 10, 1, 256),
])
def test_csr_stats_plan_sizes_grid_and_table(entries, n, blocks, slots):
    """K2's plan: CTAs for the entries (one a thread) or the finish (four
    columns a thread), at most one an SM; a table of twice a CTA's share
    of the entries, a power of two in [256, 4096], 20 bytes a slot."""
    from repro_torch.kernels import csr_stats

    plan = csr_stats.plan_csr_stats(entries, n)
    assert (plan.blocks, plan.table_slots) == (blocks, slots)
    assert plan.share == -(-entries // blocks)
    assert plan.table_slots & (plan.table_slots - 1) == 0
    assert plan.table_slots >= min(2 * plan.share, csr_stats.MAX_SLOTS)
    assert plan.smem_bytes == 20 * plan.table_slots
    with pytest.raises(ValueError):
        csr_stats.plan_csr_stats(entries, 0)


def test_csr_stats_workspace_is_kept_per_stream_and_grown():
    """The accumulator is made zeroed once per (device, stream), reused,
    and replaced by a larger zeroed one when a call needs more columns."""
    from repro_torch.kernels import csr_stats

    dev = torch.device("cpu")
    saved = dict(csr_stats._scratch)
    try:
        csr_stats._scratch.clear()
        a = csr_stats.workspace(dev, 7, 1000)
        assert a.dtype == torch.float64 and a.numel() >= 2000
        assert int(torch.count_nonzero(a)) == 0
        assert csr_stats.workspace(dev, 7, 1000) is a
        assert csr_stats.workspace(dev, 8, 1000) is not a
        big = csr_stats.workspace(dev, 7, 400_000)
        assert big is not a and big.numel() >= 800_000
        assert csr_stats.workspace(dev, 7, 1000) is big
    finally:
        csr_stats._scratch.clear()
        csr_stats._scratch.update(saved)
