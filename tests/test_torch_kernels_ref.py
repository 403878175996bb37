"""The port's BCD oracles (``repro_torch.kernels.ref``) and solver wrappers
against the reference's, on the same numpy inputs, in float64.

Tolerance 1e-12: both sides run the same IEEE operations in the same
order except the reductions (trace, matvec, u.w, F), whose order differs
between XLA and torch by a few ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bcd_fused import bcd_solve_pallas
from repro_torch.kernels import bcd_fused, ops
from repro_torch.kernels import ref as tref
from repro_torch.testing import CHAOTIC, covariance_problems

TOL = 1e-12


def _problem(n, n_valid, seed):
    """Zero-padded (n, n) covariance and identity start on the leading
    ``n_valid`` coordinates."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n_valid + 12, n_valid))
    S = np.zeros((n, n))
    S[:n_valid, :n_valid] = F.T @ F / (n_valid + 12)
    X0 = np.diag((np.arange(n) < n_valid).astype(float))
    lam = 0.3 * float(S.diagonal().max())
    beta = 1e-4 * float(np.trace(S)) / n_valid
    return S, X0, lam, beta


def _close(torch_out, jax_out):
    for t, j in zip(torch_out, jax_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("n", [16, 40])
def test_bcd_solve_ref_matches_reference(n):
    S, X0, lam, beta = _problem(n, n, seed=n)
    kw = dict(max_sweeps=3, qp_sweeps=2)
    _close(tref.bcd_solve_ref(torch.tensor(S), lam, beta, torch.tensor(X0),
                              -1.0, **kw),
           jref.bcd_solve_ref(jnp.asarray(S), lam, beta, jnp.asarray(X0),
                              -1.0, **kw))


@pytest.mark.parametrize("n,n_valid,tol", [(16, 11, -1.0), (40, 33, -1.0),
                                           (40, 29, 1e-4)])
def test_bcd_solve_masked_ref_matches_reference(n, n_valid, tol):
    S, X0, lam, beta = _problem(n, n_valid, seed=n + n_valid)
    kw = dict(max_sweeps=3, qp_sweeps=2)
    out = tref.bcd_solve_masked_ref(torch.tensor(S), lam, beta,
                                    torch.tensor(X0), tol, n_valid, **kw)
    _close(out, jref.bcd_solve_masked_ref(jnp.asarray(S), lam, beta,
                                          jnp.asarray(X0), tol, n_valid,
                                          **kw))
    # coordinates at or beyond n_valid stay exactly zero
    assert not out[0][n_valid:].any() and not out[0][:, n_valid:].any()


@pytest.mark.parametrize("n", [16, 40])
def test_bcd_solve_batched_ref_matches_reference(n):
    sizes = [n, n - 5, n // 2]
    probs = [_problem(n, nv, seed=10 * n + nv) for nv in sizes]
    S = np.stack([p[0] for p in probs])
    X0 = np.stack([p[1] for p in probs])
    lams = np.array([p[2] for p in probs])
    betas = np.array([p[3] for p in probs])
    kw = dict(max_sweeps=2, qp_sweeps=2)
    _close(tref.bcd_solve_batched_ref(torch.tensor(S), lams, betas,
                                      torch.tensor(X0), -1.0, sizes, **kw),
           jref.bcd_solve_batched_ref(jnp.asarray(S), jnp.asarray(lams),
                                      jnp.asarray(betas), jnp.asarray(X0),
                                      -1.0, jnp.asarray(sizes), **kw))


def test_qp_sweep_ref_matches_reference():
    S, _, lam, _ = _problem(16, 16, seed=3)
    j = 5
    mask = np.ones(16)
    mask[j] = 0
    Y = S * mask[:, None] * mask[None, :] + np.eye(16) * mask * 0.5
    s = S[:, j] * mask
    _close(tref.qp_sweep_ref(torch.tensor(Y), torch.tensor(s), lam,
                             torch.tensor(s), j, 3),
           jref.qp_sweep_ref(jnp.asarray(Y), jnp.asarray(s), lam,
                             jnp.asarray(s), j, 3))


@pytest.mark.parametrize("n_valid", [None, 12])
def test_ops_bcd_solve_ref_matches_interpret_kernel(n_valid):
    """The port's CPU dispatch (plain version) against the reference's
    Pallas kernel in interpret mode, as tests/test_bcd_fused.py runs it."""
    S, X0, lam, beta = _problem(16, n_valid or 16, seed=7)
    kw = dict(max_sweeps=3, qp_sweeps=2)
    got = ops.bcd_solve(torch.tensor(S), lam, beta, torch.tensor(X0),
                        tol=-1.0, n_valid=n_valid, **kw)
    want = bcd_solve_pallas(jnp.asarray(S), lam, beta, jnp.asarray(X0), -1.0,
                            n_valid=n_valid, interpret=True, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-10)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-10)
    assert int(got[2]) == int(want[2]) == 3


def test_float32_oracle_stays_float32():
    S, X0, lam, beta = _problem(16, 12, seed=1)
    X, F, k, hist = tref.bcd_solve_masked_ref(
        torch.tensor(S, dtype=torch.float32), lam, beta,
        torch.tensor(X0, dtype=torch.float32), 1e-7, 12, max_sweeps=3,
        qp_sweeps=2)
    assert X.dtype == F.dtype == hist.dtype == torch.float32
    jX, jF, _, _ = jref.bcd_solve_masked_ref(
        jnp.asarray(S, jnp.float32), jnp.float32(lam), jnp.float32(beta),
        jnp.asarray(X0, jnp.float32), jnp.float32(1e-7), 12, max_sweeps=3,
        qp_sweeps=2)
    # float32 reductions in another order: F is a difference of O(1) sums
    # over n^2 terms, each carrying ~n float32 roundings
    assert float(F) == pytest.approx(float(jF), abs=1e-5 * (1 + abs(float(jF))))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), atol=1e-5)


@pytest.mark.parametrize("n,itemsize,scheme", [
    (40, 4, "smem"), (224, 4, "smem"), (225, 4, "global"), (512, 4, "global"),
    (160, 8, "smem"), (161, 8, "global"),
])
def test_plan_fused_solve_schemes(n, itemsize, scheme):
    """One CTA a problem: one warp with X's n_pad^2 words and a slack row
    in shared memory (``smem``), or min(n_pad, 512) threads with 3 n_pad
    words of vectors and a partial sum a warp (``global``)."""
    plan = ops.plan_fused_solve(n, itemsize)
    assert plan.scheme == scheme
    assert plan.n_pad % 32 == 0 and plan.n_pad >= n
    if scheme == "smem":       # the kernel's register slots: 1-7 f32, 1-5 f64
        assert plan.slots == plan.n_pad // 32
        assert 1 <= plan.slots <= (7 if itemsize == 4 else 5)
        assert plan.threads == 32
        words = plan.n_pad ** 2 + plan.n_pad + 32
    else:
        assert plan.slots == 0
        assert plan.threads == min(plan.n_pad, 512)
        words = 3 * plan.n_pad + 16
    assert plan.smem_bytes == words * itemsize <= bcd_fused.SMEM_LIMIT_BYTES
    assert ops.plan_fused_solve(n, itemsize, scheme="global").scheme == "global"


@pytest.mark.parametrize("n,itemsize,scheme,threads", [
    (1, 4, "smem", 32),         # the smallest problem: one slot
    (33, 4, "smem", 32),        # two slots, a ragged second
    (192, 4, "smem", 32),       # the dense fit's largest n_hat
    (500, 4, "global", 512),    # NYTimes' largest reduced size
    (1000, 8, "global", 512),   # PubMed's, float64: 512 threads own 1024
    (19_360, 4, "global", 512),   # the largest global float32 size
    (9_664, 8, "global", 512),    # the largest global float64 size
    (19_361, 4, None, None),      # beyond: refused
])
def test_plan_fused_solve_sizes_one_cta_a_problem(n, itemsize, scheme,
                                                  threads):
    """The plan has no batch: every problem of a launch is its own CTA
    (grid = (B,)), and ``global`` holds only vectors in shared memory, so
    it runs to n_pad 19,360 (float32) and 9,664 (float64)."""
    if scheme is None:
        with pytest.raises(ValueError, match="shared memory"):
            ops.plan_fused_solve(n, itemsize)
        return
    plan = ops.plan_fused_solve(n, itemsize)
    assert (plan.scheme, plan.threads) == (scheme, threads)
    assert plan.smem_bytes == bcd_fused.smem_bytes(
        scheme, plan.n_pad, itemsize) <= bcd_fused.SMEM_LIMIT_BYTES


def test_plan_refuses_smem_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        ops.plan_fused_solve(256, 4, scheme="smem")
    with pytest.raises(ValueError, match="unknown scheme"):
        ops.plan_fused_solve(64, 4, scheme="tiled")


def test_cuda_impl_on_cpu_tensor_raises():
    S, X0, lam, beta = _problem(16, 16, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.bcd_solve(torch.tensor(S), lam, beta, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.bcd_solve_batched(torch.tensor(S)[None], [lam], [beta],
                              torch.tensor(X0)[None], [16], impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        bcd_fused.launch(torch.zeros(1, 32, 32), torch.zeros(1, 32, 32),
                         torch.zeros(1, 4), plan=ops.plan_fused_solve(32),
                         max_sweeps=1, qp_sweeps=1, tau_iters=1)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.bcd_solve(torch.tensor(S), lam, beta, impl="pallas")


def test_ops_count_launches_per_call():
    from repro_torch.obs import metrics

    S, X0, lam, beta = _problem(16, 12, seed=4)
    with metrics.use_registry() as reg:
        ops.bcd_solve(torch.tensor(S), lam, beta, n_valid=12, max_sweeps=1,
                      qp_sweeps=1)
        ops.bcd_solve_batched(torch.tensor(S)[None].repeat(2, 1, 1),
                              [lam, lam], [beta, beta],
                              torch.tensor(X0)[None].repeat(2, 1, 1),
                              [12, 10], max_sweeps=1, qp_sweeps=1)
        assert reg.value("kernel.launches.bcd_solve") == 1
        assert reg.value("kernel.launches.bcd_solve_batched") == 1


def test_unstructured_early_exit_case_is_chaotic():
    """The unstructured early-exit case (``testing.bcd_problems.CHAOTIC``)
    that chip_smoke.py holds the kernel to: the reference's oracle and the
    port's plain version, both float64, agree in F over the first
    ``agree_sweeps`` sweeps and then drift apart, as the kernel and the
    plain version do on the card.  The cause is the problem, not either
    implementation: F is not monotone (the inexact box QPs make BCD no
    ascent method here), and the plain version alone moves as far when
    Sigma is perturbed by one ulp."""
    c = CHAOTIC
    S, X0, lams, betas = covariance_problems(
        np.random.default_rng(c["seed"]), c["sizes"], c["n_pad"])
    S, X0, lam, beta, nv = S[0], X0[0], lams[0], betas[0], c["sizes"][0]
    kw = dict(max_sweeps=c["max_sweeps"], qp_sweeps=c["qp_sweeps"])

    def port(Sx):
        X, _, k, h = tref.bcd_solve_masked_ref(
            torch.tensor(Sx), lam, beta, torch.tensor(X0), c["tol"], nv, **kw)
        return X.numpy(), int(k), h.numpy()

    jX, _, jk, jh = (np.asarray(o) for o in jref.bcd_solve_masked_ref(
        jnp.asarray(S), lam, beta, jnp.asarray(X0), c["tol"], nv, **kw))
    tX, tk, th = port(S)
    a = c["agree_sweeps"]
    assert jk == tk == c["max_sweeps"]
    np.testing.assert_allclose(th[:a], jh[:a], rtol=c["agree_rtol"])
    assert (np.diff(jh) < 0).any()                     # F is not monotone
    assert np.abs(tX - jX).max() > 1e-3
    noise = np.random.default_rng(1).choice([-1.0, 1.0], size=S.shape)
    Sp = S * (1 + np.finfo(np.float64).eps * (noise + noise.T) / 2)
    pX, _, ph = port(Sp)
    np.testing.assert_allclose(ph[:a], th[:a], rtol=c["agree_rtol"])
    assert np.abs(pX - tX).max() > 1e-3


def test_float32_blowup_is_the_reference_oracles():
    """On some unstructured problems a float32 solve blows up in its first
    sweep (an X_jj = c + tau cancels) and ends NaN: the reference's oracle
    and the port's plain version alike, so chip_smoke.py requires the
    kernel to end non-finite there too.  In float64 both solve it."""
    S, X0, lams, betas = covariance_problems(np.random.default_rng(4), [40],
                                             40, np.float32)
    S, X0, lam, beta = S[0], X0[0], lams[0], betas[0]
    kw = dict(max_sweeps=3, qp_sweeps=2)
    jh = np.asarray(jref.bcd_solve_masked_ref(
        jnp.asarray(S), np.float32(lam), np.float32(beta), jnp.asarray(X0),
        np.float32(-1.0), 40, **kw)[3])
    th = tref.bcd_solve_masked_ref(torch.tensor(S), lam, beta,
                                   torch.tensor(X0), -1.0, 40, **kw)[3]
    for h in (jh, th.numpy()):
        assert h[0] < -1e8 and np.isnan(h[1:]).all()
    S64, X064 = S.astype(np.float64), X0.astype(np.float64)
    _close(tref.bcd_solve_masked_ref(torch.tensor(S64), lam, beta,
                                     torch.tensor(X064), -1.0, 40, **kw),
           jref.bcd_solve_masked_ref(jnp.asarray(S64), lam, beta,
                                     jnp.asarray(X064), -1.0, 40, **kw))


def _solve_tau_fixed_point(R2, c, beta, tau_iters=80):
    """`ref.solve_tau` with K1's exit: stop once a step leaves (lo, hi)
    unchanged (every later step would repeat it).  Returns (tau, steps)."""
    ft = type(R2)
    one, zero, half = ft(1.0), ft(0.0), ft(0.5)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        hi = max(one, -c) + np.sqrt(max(R2, zero)) + beta + one
        lo = min(beta / (beta + max(-c, zero) + one), hi) * ft(1e-12)
        steps = 0
        while steps < tau_iters:
            steps += 1
            mid = half * (lo + hi)
            g = mid + c - R2 / (mid * mid) - beta / mid
            if g < 0:
                if mid == lo:
                    break
                lo = mid
            else:
                if mid == hi:
                    break
                hi = mid
        return half * (lo + hi), steps


@pytest.mark.parametrize("ft,median_steps", [(np.float32, (24, 40)),
                                             (np.float64, (50, 70))])
def test_tau_fixed_point_exit_is_bit_identical(ft, median_steps):
    """The bisection stopped at its fixed point returns the very bits of
    the 80-step `ref.solve_tau`, on 3,000 seeded draws of (R2, c, beta)
    over 12 decades and on the edges (R2 = 0, c large and negative, NaN
    and inf, which never reach a fixed point or reach it at once); the
    steps taken are held, so the saving is on record."""
    rng = np.random.default_rng(11)
    draws = [(ft(0.0 if rng.random() < 0.1 else 10 ** rng.uniform(-8, 4)),
              ft(rng.normal() * 10 ** rng.uniform(-3, 3)),
              ft(10 ** rng.uniform(-8, 0))) for _ in range(3000)]
    nan, inf = ft(np.nan), ft(np.inf)
    edges = [(ft(0), ft(0.5), ft(1e-4)), (ft(0), ft(-1e6), ft(1e-4)),
             (ft(3.0), ft(-1e30), ft(1e-6)), (nan, ft(1.0), ft(1e-4)),
             (ft(1.0), nan, ft(1e-4)), (ft(1.0), ft(1.0), nan),
             (inf, ft(1.0), ft(1e-4)), (ft(1.0), -inf, ft(1e-4)),
             (ft(1.0), inf, ft(1e-4))]
    steps = []
    for R2, c, beta in draws + edges:
        want = tref.solve_tau(R2, c, beta, 80)
        got, k = _solve_tau_fixed_point(R2, c, beta, 80)
        assert type(got) is type(want) is ft
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), (
            R2, c, beta)
        steps.append(k)
    drawn = np.array(steps[:len(draws)])
    assert median_steps[0] <= np.median(drawn) <= median_steps[1]
    assert 1 <= drawn.min() and drawn.max() <= 80
    assert steps[len(draws) + 3] == 80        # a NaN bracket never settles
    for tau_iters in (0, 1, 5):               # shorter budgets: the same rule
        for R2, c, beta in draws[:200]:
            want = tref.solve_tau(R2, c, beta, tau_iters)
            got, k = _solve_tau_fixed_point(R2, c, beta, tau_iters)
            assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
            assert k <= tau_iters
