"""Pooled statistics for sparse PCA over the lanes of a data mesh (port of
``repro.core.distributed``).

The paper notes the screen "only requires the computation of each
feature's variance, and that this task is easy to parallelize".  Here
documents are split into D contiguous row blocks, one per lane of a
`launch.mesh.DataMesh`; each lane reduces its block where it lies, and
`psum_partials` pools the D partials once.  The reduced Gram after
elimination is the same pattern with a local product, so the only
traffic between lanes for the whole preprocessing is two poolings of
size O(n) and O(n_hat^2).

These are plain torch per lane, as the reference's are plain jnp: the
dense product is ``torch.matmul`` (TF32 as the caller set it), as the
reference leaves it to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..launch.mesh import DataMesh, lane_context, sync_lanes
from .elimination import Screen, select_support


def psum_partials(partials, mesh: DataMesh):
    """Pool per-lane partial reductions: THE merge step.

    ``partials`` is a tuple of leaves; each leaf holds one partial a lane,
    as a sequence of D tensors (each on its lane's device) or a stacked
    ``(D, ...)`` tensor or array.  Each leaf's partials are summed on lane
    0 in lane order (one fixed order, so a pooled result is the same bits
    run to run), once every lane's queued work has run; the host waits
    again after the sums, so the caller may drop the partials at once.
    Returns the tuple of sums, the lane axis dropped.  This is the math ``combine_screens`` / ``StreamingGram.merge``
    guarantee; every pooling of lane partials in the port (the dense
    passes below, ``sparse/mesh_engine.py``) goes through here."""
    root = mesh[0].device
    sync_lanes(mesh)
    out = []
    for leaf in partials:
        parts = list(leaf)
        if len(parts) != len(mesh):
            raise ValueError(f"psum_partials: a leaf has {len(parts)} "
                             f"partials for {len(mesh)} lanes")
        acc = torch.as_tensor(parts[0]).to(root, copy=True)
        for p in parts[1:]:
            acc += torch.as_tensor(p).to(root)
        out.append(acc)
    sync_lanes(mesh)
    return tuple(out)


def _row_blocks(A, mesh: DataMesh):
    """Lane d's contiguous row block of ``A`` (numpy or tensor), on its
    lane's device."""
    D = len(mesh)
    bounds = np.linspace(0, A.shape[0], D + 1).round().astype(int)
    for lane, lo, hi in zip(mesh, bounds[:-1], bounds[1:]):
        block = A[lo:hi]
        if not isinstance(block, torch.Tensor):
            block = torch.from_numpy(np.ascontiguousarray(block))
        yield lane, block


def distributed_variances(A, mesh: DataMesh, *, center: bool = True
                          ) -> Screen:
    """Per-feature variances of an (m, n) matrix ``A`` with its documents
    split across the lanes.  Returns a `Screen` on lane 0's device."""
    s_parts, ss_parts, cnt_parts = [], [], []
    for lane, block in _row_blocks(A, mesh):
        with lane_context(lane):
            a = block.to(lane.device)
            s_parts.append(a.sum(0))
            ss_parts.append((a * a).sum(0))
            cnt_parts.append(torch.full((1,), a.shape[0], dtype=a.dtype,
                                        device=lane.device))
    s, ss, cnt = psum_partials((s_parts, ss_parts, cnt_parts), mesh)
    m = cnt[0]
    mean = s / m if center else torch.zeros_like(s)
    var = torch.clamp(ss / m - mean * mean, min=0.0)
    return Screen(variances=var, means=mean, count=int(m))


def distributed_gram(A_red, mesh: DataMesh, *, means=None) -> torch.Tensor:
    """Reduced covariance ``sum_d A_d^T A_d / m`` of the (m, n_hat)
    surviving columns ``A_red`` with documents split across the lanes;
    centred, ``A^T A - m mu mu^T``, when ``means`` is given.  On lane 0's
    device."""
    g_parts, cnt_parts = [], []
    for lane, block in _row_blocks(A_red, mesh):
        with lane_context(lane):
            a = block.to(lane.device)
            g_parts.append(a.T @ a)
            cnt_parts.append(torch.full((1,), a.shape[0], dtype=a.dtype,
                                        device=lane.device))
    g, cnt = psum_partials((g_parts, cnt_parts), mesh)
    m = cnt[0]
    if means is not None:
        mu = torch.as_tensor(means).to(g)
        g = g - m * torch.outer(mu, mu)
    return g / m


def distributed_screen_and_gram(A, mesh: DataMesh, lam: float, *,
                                center: bool = True, max_reduced: int = 2048):
    """The preprocessing end to end: one variance pass, the support chosen
    on the host (tiny), one Gram pass over the support's columns.
    Returns ``(Sigma_hat, support, screen)``, tensors on lane 0."""
    screen = distributed_variances(A, mesh, center=center)
    support = select_support(screen.variances.cpu().numpy(), lam,
                             max_reduced)
    if isinstance(A, torch.Tensor):
        cols = A.index_select(1, torch.as_tensor(support, device=A.device))
    else:
        cols = np.asarray(A)[:, support]
    means = (screen.means.index_select(
        0, torch.as_tensor(support, device=screen.means.device))
        if center else None)
    Sigma_hat = distributed_gram(cols, mesh, means=means)
    return Sigma_hat, support, screen
