"""Plain PyTorch versions of the port's kernels (port of the BCD and CSR
parts of ``repro.kernels.ref``).

These are the kernels' plain versions: the CPU tests run them, `ops` takes
them for a tensor that lies on the CPU (or for ``impl='ref'``), and
``chip_smoke.py`` holds the CUDA kernels against them on the card.  They
run on the device of their inputs.

CSR oracles (kernels K2 and K3): a scatter with the reference's
``mode='drop'`` semantics (a column ``>= n``, a local column ``>= n_hat``
or a row ``>= n_rows`` adds nothing; padded slots carry value 0 and add
nothing wherever they point), then, for the Gram, ``B.T @ B`` in float32
with TF32 off.  The column stats accumulate in float64 and round to
float32 once, as the kernel does (and as the reference's host backend
does); the reference's own oracle scatters in float32, which agrees to
float32 rounding.

The coordinate recursion of the box QP is sequential, so it is a Python
loop: the scalar part of each coordinate step is computed on the host in
numpy scalars of the working dtype (so float32 stays float32), and the
``w += Y[:, i] * (eta - u_i)`` update is one vector op.  Every scalar
operation is the reference's, in the reference's order.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

# IEEE semantics as the reference's jnp scalars have them: overflow to inf,
# inf - inf = nan, no warnings
_IEEE = dict(over="ignore", invalid="ignore", divide="ignore")


def np_scalar(dtype: torch.dtype):
    """The numpy scalar type that computes in ``dtype``."""
    if dtype == torch.float32:
        return np.float32
    if dtype == torch.float64:
        return np.float64
    raise TypeError(f"BCD runs in float32 or float64, not {dtype}")


def solve_tau(R2, c, beta, tau_iters: int = 80):
    """min_{tau>0} R2/tau - beta*log(tau) + (c + tau)^2 / 2 by bisection on
    the strictly increasing derivative.  Scalars are numpy scalars of one
    type; the result has that type."""
    ft = type(R2)
    one, zero, half = ft(1.0), ft(0.0), ft(0.5)
    with np.errstate(**_IEEE):
        hi = max(one, -c) + np.sqrt(max(R2, zero)) + beta + one
        lo = min(beta / (beta + max(-c, zero) + one), hi) * ft(1e-12)
        for _ in range(tau_iters):
            mid = half * (lo + hi)
            g = mid + c - R2 / (mid * mid) - beta / mid
            if g < 0:
                lo = mid
            else:
                hi = mid
        return half * (lo + hi)


def box_qp(Y, s, lam, u0, j: int, sweeps: int, n_active: int | None = None):
    """Box-QP coordinate descent (11) with the closed-form update (13):

      min_u u^T Y u  s.t. ||u - s||_inf <= lam,  u_j = u0_j,

    with Y's row/col j already zeroed.  Coordinates at or beyond
    ``n_active`` (default all) are frozen.  Returns (u, w = Y u, R2 = u^T w)
    with ``R2`` a numpy scalar of the working dtype."""
    ft = np_scalar(Y.dtype)
    n = Y.shape[0]
    n_active = n if n_active is None else int(n_active)
    lam = ft(lam)
    w = Y @ u0
    u = [ft(x) for x in u0.tolist()]
    s_l = [ft(x) for x in s.tolist()]
    diag = [ft(x) for x in Y.diagonal().tolist()]
    # On the CPU the step runs on numpy views of the same memory (a tensor
    # op costs microseconds of dispatch, and the loop is all dispatch); on
    # a card it reads w[i] with one .item() and updates w with tensor ops.
    # Both round exactly as the reference's elementwise ops do.
    on_cpu = w.device.type == "cpu"
    wv = w.numpy() if on_cpu else None
    cols = Y.t().contiguous().numpy() if on_cpu else None
    with np.errstate(**_IEEE):
        _coordinate_sweeps(Y, w, wv, cols, u, s_l, diag, lam, j, sweeps,
                           n_active, ft)
    u_t = torch.tensor([float(x) for x in u], dtype=Y.dtype, device=Y.device)
    return u_t, w, ft(torch.dot(u_t, w).item())


def _coordinate_sweeps(Y, w, wv, cols, u, s_l, diag, lam, j, sweeps,
                       n_active, ft):
    """The coordinate loop of `box_qp`; updates ``w`` and ``u`` in place."""
    for _ in range(sweeps):
        for i in range(n_active):
            if i == j:          # pinned: eta = u_i, w unchanged
                continue
            y1 = diag[i]
            ui = u[i]
            wi = wv[i] if wv is not None else ft(w[i].item())
            g = wi - y1 * ui
            lo = s_l[i] - lam
            hi = s_l[i] + lam
            if y1 > 0:
                eta = -g / y1
                eta = lo if eta < lo else (hi if eta > hi else eta)
            else:
                eta = lo if g > 0 else hi
            d = eta - ui
            if d != 0:          # adding Y[:, i] * 0 leaves w as it is
                if wv is not None:
                    wv += cols[i] * d
                else:
                    w += Y[:, i] * float(d)
                u[i] = eta


def qp_sweep_ref(Y, s, lam, u0, j, sweeps: int):
    """Box-QP coordinate descent, the semantics of ``repro.kernels.ref.
    qp_sweep_ref``: returns (u, w = Y@u, R2 = u^T Y u) as tensors."""
    u, w, R2 = box_qp(Y, s, lam, u0, int(j), sweeps)
    return u, w, torch.tensor(float(R2), dtype=Y.dtype, device=Y.device)


def partial_objective(Sigma, X, lam):
    """F(X) = Tr(Sigma X) - lam ||X||_1 - (Tr X)^2 / 2 (barrier-free)."""
    tr = torch.trace(X)
    return torch.sum(Sigma * X) - lam * torch.sum(torch.abs(X)) - 0.5 * tr * tr


def bcd_solve_masked_ref(
    Sigma, lam, beta, X0, tol, n_valid,
    *, max_sweeps: int = 20, qp_sweeps: int = 4, tau_iters: int = 80,
):
    """Padded/masked whole-solve BCD — the semantics of the fused kernel:
    the problem occupies the leading ``n_valid`` coordinates of a
    zero-padded (n, n) ``Sigma``/``X0`` and coordinates at or beyond
    ``n_valid`` stay zero.  Sweeps run until the barrier-free F(X) is
    sweep-to-sweep stationary (``|dF| <= tol (1 + |F|)``; ``tol < 0``
    never is) or ``max_sweeps`` is hit.  Returns ``(X, obj, sweeps,
    history)``, ``history`` nan-padded to ``(max_sweeps,)``."""
    n = Sigma.shape[0]
    dtype, dev = Sigma.dtype, Sigma.device
    ft = np_scalar(dtype)
    nv = int(n_valid)
    lam_s, beta_s, tol_s = ft(float(lam)), ft(float(beta)), ft(float(tol))
    lam_t = torch.tensor(float(lam_s), dtype=dtype, device=dev)
    idx = torch.arange(n, device=dev)
    valid = idx < nv
    X = X0.to(dtype).clone()
    hist = torch.full((max_sweeps,), float("nan"), dtype=dtype, device=dev)
    prev = obj = ft(-np.inf)
    k = 0
    done = False
    while not done and k < max_sweeps:
        for j in range(nv):
            mf = ((idx != j) & valid).to(dtype)
            Y = X * mf[:, None] * mf[None, :]
            s = Sigma[:, j] * mf
            t = ft(torch.trace(X).item()) - ft(X[j, j].item())
            c = ft(Sigma[j, j].item()) - lam_s - t
            u, w, R2 = box_qp(Y, s, lam_s, s, j, qp_sweeps, nv)
            tau = solve_tau(R2, c, beta_s, tau_iters)
            y = w / float(tau)
            X = Y
            X[j, :] = y
            X[:, j] = y
            X[j, j] = float(c + tau)
        obj = ft(partial_objective(Sigma, X, lam_t).item())
        hist[k] = float(obj)
        with np.errstate(**_IEEE):
            done = bool(abs(obj - prev) <= tol_s * (ft(1.0) + abs(obj)))
        prev = obj
        k += 1
    return (
        X,
        torch.tensor(float(obj), dtype=dtype, device=dev),
        torch.tensor(k, dtype=torch.int32, device=dev),
        hist,
    )


def bcd_solve_ref(
    Sigma, lam, beta, X0, tol,
    *, max_sweeps: int = 20, qp_sweeps: int = 4, tau_iters: int = 80,
):
    """Whole-solve BCD on an unpadded problem: `bcd_solve_masked_ref` with
    every coordinate valid (the masks are then identities)."""
    return bcd_solve_masked_ref(
        Sigma, lam, beta, X0, tol, Sigma.shape[0],
        max_sweeps=max_sweeps, qp_sweeps=qp_sweeps, tau_iters=tau_iters,
    )


def bcd_solve_batched_ref(
    Sigmas, lams, betas, X0s, tol, n_valids,
    *, max_sweeps: int = 20, qp_sweeps: int = 4, tau_iters: int = 80,
):
    """B independent masked solves, one after another — the plain version
    of the batched kernel launch.  Returns ``(X (B,n,n), obj (B,),
    sweeps (B,), history (B, max_sweeps))``."""
    B = Sigmas.shape[0]
    f64 = torch.float64        # a list of floats would default to float32
    lams = torch.as_tensor(lams, dtype=f64).reshape(-1).tolist()
    betas = torch.as_tensor(betas, dtype=f64).reshape(-1).expand(B).tolist()
    n_valids = torch.as_tensor(n_valids).reshape(-1).tolist()
    outs = [
        bcd_solve_masked_ref(
            Sigmas[b], lams[b], betas[b], X0s[b], tol, int(n_valids[b]),
            max_sweeps=max_sweeps, qp_sweeps=qp_sweeps, tau_iters=tau_iters,
        )
        for b in range(B)
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


@contextlib.contextmanager
def full_fp32():
    """Float32 matrix products in full float32 (TF32 off) inside the
    block, whatever the caller set; restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def csr_column_stats_ref(values, col_ids, n: int):
    """Per-column (sum, sumsq), (n,) float32 each, from flat CSR entries:
    a float64 scatter-add rounded to float32 once.  Columns outside
    [0, n) are dropped."""
    v = values.reshape(-1).to(torch.float64)
    c = col_ids.reshape(-1).to(torch.int64)
    keep = (c >= 0) & (c < n)
    v, c = v[keep], c[keep]
    s = torch.zeros(n, dtype=torch.float64, device=v.device)
    ss = torch.zeros(n, dtype=torch.float64, device=v.device)
    s.index_add_(0, c, v)
    ss.index_add_(0, c, v * v)
    return s.to(torch.float32), ss.to(torch.float32)


def csr_column_stats_batched_ref(values, col_ids, n: int):
    """Megabatch oracle: the (C, E) entries of C chunks in ONE scatter
    (the sum of the per-chunk `csr_column_stats_ref`)."""
    return csr_column_stats_ref(values.reshape(-1), col_ids.reshape(-1), n)


def _densify_gram(values, rows, cols, n_rows_total: int, n_hat: int):
    """``B[rows, cols] += values`` on an (n_rows_total, n_hat) float32
    matrix with out-of-range rows/cols dropped, then ``B.T @ B``."""
    v = values.reshape(-1).to(torch.float32)
    r = rows.reshape(-1).to(torch.int64)
    c = cols.reshape(-1).to(torch.int64)
    keep = (c >= 0) & (c < n_hat) & (r >= 0) & (r < n_rows_total)
    B = torch.zeros((n_rows_total, n_hat), dtype=torch.float32,
                    device=v.device)
    B.index_put_((r[keep], c[keep]), v[keep], accumulate=True)
    with full_fp32():
        return B.T @ B


def csr_gram_ref(values, local_cols, seg_ids, n_rows: int, n_hat: int):
    """Chunk gather-Gram oracle: densify the chunk onto the support
    (``B[seg, col] += v``, off-support sentinels ``col >= n_hat``
    dropped) and contract rows: ``G = B^T B``, (n_hat, n_hat) float32."""
    return _densify_gram(values, seg_ids, local_cols, n_rows, n_hat)


def csr_gram_batched_ref(values, local_cols, seg_ids, n_rows: int,
                         n_hat: int):
    """Megabatch gather-Gram oracle: the C chunks of (C, E) entries
    densified into one stacked (C * n_rows, n_hat) matrix (chunk c's rows
    at ``c * n_rows + seg``, so chunks never mix rows), contracted once:
    ``G = sum_c B_c^T B_c``.  A row ``>= n_rows`` is dropped."""
    C = values.shape[0]
    seg = seg_ids.to(torch.int64)
    rows = torch.where((seg >= 0) & (seg < n_rows), seg, C * n_rows) + (
        n_rows * torch.arange(C, device=seg.device)[:, None])
    return _densify_gram(values, rows, local_cols, C * n_rows, n_hat)
