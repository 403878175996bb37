"""Public wrappers of the port's kernels (port of ``repro.kernels.ops``).

Dispatch is by device, not by a fallback: a CUDA tensor goes to the
hand-written kernel (``impl='auto'`` or ``'cuda'``) and a failed build or
launch raises; a CPU tensor goes to the kernel's plain version in
`kernels.ref`.  ``impl='ref'`` forces the plain version on any device,
and ``impl='cuda'`` on a CPU tensor raises.  Every call counts one
``kernel.launches.<op>`` dispatch in the metrics registry.

The CSR and dense-block wrappers also take host arrays (numpy: the
store's megabatches, often views into
`sparse.store.SparseCorpus.iter_megabatches`' buffer ring, or
`data.corpus.Corpus.batches`' row blocks): they go to ``device`` (the
card by default) by a blocking copy that has finished when the wrapper
returns, so the caller may reuse the buffer at once.  The dense wrappers
take no TPU block sizes (``block_m`` ... ``block_k``): the Hopper kernels
tile themselves.
The reference's ``'host'`` numpy/scipy backend has no counterpart: it
exists there only because XLA's CPU scatter is a sequential loop, and
torch's ``index_add_`` on the CPU is not.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor
from ..obs import metrics, profile
from . import bcd_fused, bcd_sweep, csr_gram as csr_gram_kernel, csr_stats
from . import gram as gram_kernel
from . import project, ref, variance
from .bcd_fused import SolvePlan, plan_fused_solve

__all__ = [
    "SOLVER_FAULTS", "SolvePlan", "bcd_solve", "bcd_solve_batched",
    "column_stats", "column_variances", "csr_column_stats", "csr_gram",
    "csr_gram_batched", "gram", "plan_fused_solve", "qp_sweeps",
    "solver_fault_after", "solver_fault_before", "sparse_project",
]

# Solver-fault seam (as in the reference): a test installs an injector
# here to perturb solve results or raise dispatch errors at exact call
# occurrences, by site name ("bcd_solve", "bcd_solve_batched").  ``None``
# (production) costs one attribute check per wrapper call.
SOLVER_FAULTS = None


def solver_fault_before(site: str) -> None:
    """Dispatch-error injection point: an installed injector may raise."""
    if SOLVER_FAULTS is not None:
        SOLVER_FAULTS.before(site)


def solver_fault_after(site: str, out, *, max_sweeps: int):
    """Result-perturbation injection point around a solve's returned
    ``(X, obj, sweeps, history)`` tuple (single or batched)."""
    if SOLVER_FAULTS is not None:
        return SOLVER_FAULTS.after(site, out, max_sweeps=max_sweeps)
    return out


def _launch(op: str):
    """Per-op dispatch accounting at the wrapper boundary: bump the
    ``kernel.launches.<op>`` counter and open an ``ops.<op>`` profiler
    region (a no-op unless profiling is on)."""
    metrics.counter(f"kernel.launches.{op}").inc()
    return profile.annotate(f"ops.{op}")


def use_kernel(impl: str, t: torch.Tensor) -> bool:
    """Whether a call with ``impl`` on tensor ``t`` runs the CUDA kernel."""
    if impl == "ref":
        return False
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown impl {impl!r} (auto | cuda | ref)")
    if t.is_cuda:
        return True
    if impl == "cuda":
        raise ValueError("impl='cuda' needs CUDA tensors; this one is on "
                         f"{t.device}")
    return False


def bcd_solve(Sigma, lam, beta, X0=None, *, max_sweeps: int = 20,
              qp_sweeps: int = 4, tol: float = 1e-7, tau_iters: int = 80,
              n_valid: int | None = None, impl: str = "auto",
              scheme: str = "auto"):
    """Whole-solve fused BCD (Algorithm 1): ONE kernel launch per solve.

    ``scheme`` picks the kernel's scheme ('auto' | 'smem' | 'global', see
    `plan_fused_solve`).  ``n_valid`` restricts the solve to the leading
    principal submatrix of a zero-padded problem.  Returns ``(X, obj,
    sweeps, history)``; ``obj``/``history`` are the barrier-free objective
    of the kernel's early exit.
    """
    n = Sigma.shape[0]
    dtype = Sigma.dtype
    if X0 is None:
        X0 = torch.eye(n, dtype=dtype, device=Sigma.device)
        if n_valid is not None and n_valid < n:
            X0[n_valid:, n_valid:] = 0
    kernel = use_kernel(impl, Sigma)
    with _launch("bcd_solve"):
        solver_fault_before("bcd_solve")
        if kernel:
            out = bcd_fused.bcd_solve_cuda(
                Sigma, lam, beta, X0, tol, max_sweeps=max_sweeps,
                qp_sweeps=qp_sweeps, tau_iters=tau_iters, n_valid=n_valid,
                scheme=scheme,
            )
        else:
            out = ref.bcd_solve_masked_ref(
                Sigma, lam, beta, X0, tol, n if n_valid is None else n_valid,
                max_sweeps=max_sweeps, qp_sweeps=qp_sweeps,
                tau_iters=tau_iters,
            )
    return solver_fault_after("bcd_solve", out, max_sweeps=max_sweeps)


def bcd_solve_batched(Sigmas, lams, betas, X0s, n_valids, *,
                      max_sweeps: int = 20, qp_sweeps: int = 4,
                      tol: float = 1e-7, tau_iters: int = 80,
                      impl: str = "auto", scheme: str = "auto",
                      devices: int = 0):
    """B independent whole solves in ONE launch (one warp a problem).

    ``Sigmas``/``X0s`` are (B, n, n) zero-padded problems occupying their
    leading ``n_valids[b]`` coordinates.  Returns ``(X (B,n,n), obj (B,),
    sweeps (B,), history (B, max_sweeps))``.

    ``devices > 1`` splits the batch across the lanes of the data mesh
    (`launch.mesh.make_data_mesh`): B is padded up to a multiple of D by
    repeating problem 0, each lane solves its B/D slice with one launch on
    its own stream, and lane 0 gathers the results, sliced back to B.
    That still counts ONE ``kernel.launches.bcd_solve_batched`` dispatch
    and sets the ``mesh.devices`` gauge.  D clamps to ``min(devices, B,
    lanes available)``; each problem's bits do not depend on its lane.
    """
    kernel = use_kernel(impl, Sigmas)
    D = 0
    if devices and devices > 1:
        from ..launch.mesh import lanes_available

        D = min(int(devices), Sigmas.shape[0],
                lanes_available(Sigmas.device))
    with _launch("bcd_solve_batched"):
        solver_fault_before("bcd_solve_batched")
        kw = dict(max_sweeps=max_sweeps, qp_sweeps=qp_sweeps,
                  tau_iters=tau_iters)
        if kernel:
            def solve(S, la, be, X0, nv):
                return bcd_fused.bcd_solve_batched_cuda(
                    S, la, be, X0, tol, nv, scheme=scheme, **kw)
        else:
            def solve(S, la, be, X0, nv):
                return ref.bcd_solve_batched_ref(S, la, be, X0, tol, nv, **kw)
        if D > 1:
            out = _device_grid(solve, D, Sigmas, lams, betas, X0s, n_valids)
        else:
            out = solve(Sigmas, lams, betas, X0s, n_valids)
    return solver_fault_after("bcd_solve_batched", out,
                              max_sweeps=max_sweeps)


def _device_grid(solve, D, Sigmas, lams, betas, X0s, n_valids):
    """``solve`` split across D lanes: B padded to a multiple of D with
    copies of problem 0, lane d solving rows [d B/D, (d+1) B/D) on its
    stream, results gathered on the inputs' device and sliced to B.  The
    per-problem scalars stay float64 / int64 host values until the
    solver casts them, as on one lane."""
    from ..launch.mesh import lane_context, make_data_mesh, sync_lanes

    mesh = make_data_mesh(D, device=Sigmas.device)
    metrics.gauge("mesh.devices").set(D)
    B, dev = Sigmas.shape[0], Sigmas.device
    f64 = torch.float64
    lams = torch.as_tensor(lams, dtype=f64).reshape(-1).expand(B)
    betas = torch.as_tensor(betas, dtype=f64).reshape(-1).expand(B)
    n_valids = torch.as_tensor(n_valids).reshape(-1).expand(B)
    per = -(-B // D)
    rows = torch.cat([torch.arange(B),
                      torch.zeros(per * D - B, dtype=torch.int64)])
    parts = []
    for d, lane in enumerate(mesh):
        take = rows[d * per:(d + 1) * per]
        with lane_context(lane):
            on = take.to(dev)
            parts.append(solve(
                Sigmas.index_select(0, on).to(lane.device),
                lams[take], betas[take],
                X0s.index_select(0, on).to(lane.device), n_valids[take]))
    sync_lanes(mesh)
    out = tuple(torch.cat([p[i].to(dev) for p in parts])[:B]
                for i in range(4))
    sync_lanes(mesh)
    return out


def qp_sweeps(Y, s, lam, u0, j, *, sweeps: int = 4, impl: str = "auto"):
    """Box-QP coordinate descent (11)+(13) for one BCD row update, the
    inner loop of the legacy per-row solver (``qp_impl='pallas'``):
    ``(u, w = Y u, R2 = u^T w)`` as tensors.  On the card: ONE launch of
    kernel K7, which takes Y symmetric (see `kernels.bcd_sweep`)."""
    kernel = use_kernel(impl, Y)
    with _launch("qp_sweeps"):
        if kernel:
            return bcd_sweep.qp_sweep_cuda(Y, s, lam, u0, j, sweeps)
        return ref.qp_sweep_ref(Y, s, lam, u0, j, sweeps)


def column_stats(A, *, impl: str = "auto", device=None):
    """``(col_sum, col_sumsq)``, (n,) float32, of a dense (m, n) row block
    (float32 or float64): the dense leg of the Thm 2.1 screen.  On the
    card: ONE launch of kernel K5.  A host array goes to ``device``
    first."""
    A = as_tensor(A, device if not isinstance(A, torch.Tensor) else None)
    kernel = use_kernel(impl, A)
    with _launch("column_stats"):
        if kernel:
            return variance.column_stats_cuda(A)
        return ref.column_stats_ref(A)


def column_variances(A, *, impl: str = "auto", device=None):
    """``(mean, var)`` of a dense (m, n) block from one `column_stats`
    pass."""
    m = A.shape[0]
    s, ss = column_stats(A, impl=impl, device=device)
    mean = s / m
    return mean, torch.clamp(ss / m - mean * mean, min=0.0)


def gram(A, *, impl: str = "auto", device=None):
    """``A^T A``, (n, n) float32, of a dense (m, n) block (cast to
    float32, as the reference's oracle does): the dense leg of the
    reduced Gram.  On the card: ONE launch of kernel K6.  A host array
    goes to ``device`` first."""
    A = as_tensor(A, device if not isinstance(A, torch.Tensor) else None)
    kernel = use_kernel(impl, A)
    with _launch("gram"):
        if kernel:
            return gram_kernel.gram_cuda(A.to(torch.float32))
        return ref.gram_ref(A)


def _assert_csr_padding(values, nnz) -> None:
    """Enforce the store's chunk padding contract on host arrays (numpy or
    CPU tensors): slots at or past ``nnz`` must carry value 0, so their
    col/seg ids are additively harmless for every CSR kernel.  ``nnz`` is
    a scalar for one chunk or a (C,) vector for a megabatch; ``nnz=None``
    and CUDA tensors (a check would stall the stream) skip it."""
    if nnz is None or (isinstance(values, torch.Tensor) and values.is_cuda):
        return
    v = np.asarray(values)
    v = v if v.ndim == 2 else v[None, :]
    k = np.asarray(nnz, np.int64).reshape(-1, 1)
    lane = np.arange(v.shape[1], dtype=np.int64)[None, :]
    if np.any((lane >= k) & (v != 0)):
        raise ValueError(
            "CSR chunk padding contract violated: slots past nnz must "
            "carry value 0 (see sparse.store.CSRChunk)")


def _csr_inputs(device, values, *ids):
    """``values`` as float32 and the id arrays as int32 tensors, on the
    tensors' own device or, for host arrays, on ``device`` (the card by
    default) by a copy that has landed when this returns."""
    out = [as_tensor(values, device if not isinstance(values, torch.Tensor)
                     else None).to(torch.float32)]
    dev = out[0].device
    out += [as_tensor(a, dev).to(torch.int32) for a in ids]
    return out


def csr_column_stats(values, col_ids, *, n: int, impl: str = "auto",
                     nnz=None, device=None):
    """``(col_sum, col_sumsq)``, (n,) float32, from CSR entries: the sparse
    leg of the Thm 2.1 screen.  ``values``/``col_ids`` are (E,) for one
    chunk or (C, E) for a megabatch of C chunks, reduced in ONE launch of
    kernel K2 on the card.  ``nnz`` (scalar or (C,)), with host arrays,
    asserts the ``value 0`` padding contract."""
    _assert_csr_padding(values, nnz)
    values, col_ids = _csr_inputs(device, values, col_ids)
    kernel = use_kernel(impl, values)
    with _launch("csr_column_stats"):
        if kernel:
            return csr_stats.csr_column_stats_cuda(values, col_ids, n)
        return ref.csr_column_stats_ref(values, col_ids, n)


def _gram(op: str, values, local_cols, seg_ids, n_rows, n_hat, impl, nnz,
          device, plain):
    _assert_csr_padding(values, nnz)
    values, local_cols, seg_ids = _csr_inputs(device, values, local_cols,
                                              seg_ids)
    kernel = use_kernel(impl, values)
    with _launch(op):
        if n_hat == 0:
            return torch.zeros((0, 0), dtype=torch.float32,
                               device=values.device)
        if kernel:
            return csr_gram_kernel.csr_gram_cuda(values, local_cols, seg_ids,
                                                 n_rows, n_hat)
        return plain(values, local_cols, seg_ids, n_rows, n_hat)


def csr_gram(values, local_cols, seg_ids, *, n_rows: int, n_hat: int,
             impl: str = "auto", nnz=None, device=None):
    """Chunk gather-Gram ``G = B^T B`` on the post-elimination support,
    (n_hat, n_hat) float32.  ``local_cols`` are support positions, with
    ``>= n_hat`` meaning "drop" (entry off the support); ``seg_ids`` are
    chunk-local rows.  On the card: kernel K3 at C = 1."""
    return _gram("csr_gram", values, local_cols, seg_ids, n_rows, n_hat,
                 impl, nnz, device, ref.csr_gram_ref)


def csr_gram_batched(values, local_cols, seg_ids, *, n_rows: int,
                     n_hat: int, impl: str = "auto", nnz=None, device=None):
    """Megabatch gather-Gram: C chunks' ``sum_c B_c^T B_c`` in ONE launch
    of kernel K3 at any ``n_hat`` (the output is tiled, so there is no
    per-chunk fallback).  Inputs are (C, E); ``nnz`` (C,), with host
    arrays, asserts the ``value 0`` padding contract."""
    return _gram("csr_gram_batched", values, local_cols, seg_ids, n_rows,
                 n_hat, impl, nnz, device, ref.csr_gram_batched_ref)


def sparse_project(X, support_idx, values, *, impl: str = "auto"):
    """(B, k) float32 document -> topic scores through the gather
    representation: the serving hot path (see `serve.projector`).
    ``X`` (B, n) float32, ``support_idx`` (k, cap) int32 and ``values``
    (k, cap) float32 tensors on one device.  On the card: ONE launch of
    kernel K4, reading X where it lies (no transposed copy of the batch,
    which the TPU kernel needs and this one does not)."""
    project.check_inputs(X, support_idx, values)
    kernel = use_kernel(impl, X)
    with _launch("sparse_project"):
        if kernel:
            return project.sparse_project_cuda(X, support_idx, values)
        return ref.sparse_project_ref(X, support_idx, values)
