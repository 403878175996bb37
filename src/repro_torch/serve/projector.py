"""Pack fitted sparse PCs into a gather representation and serve projections.

Port of ``repro.serve.projector``.  A fitted component is a sparse vector
in R^n (n ~ 10^5) with card ~ 5 nonzeros.  Serving never touches n-sized
dense loadings: `pack_components` extracts each component's (support,
values) pair into padded (k, cap) arrays — ``cap`` is the max cardinality
rounded up, so refits with slightly different cardinalities keep the same
shapes — and `TopicProjector` pushes batches through
``kernels.ops.sparse_project`` (kernel K4 on the card, its plain version
on the CPU).

Sparse PCs double as cluster assigners (Luss & d'Aspremont, 2008), so the
projector also exposes ``assign_topics`` (argmax score) and a
sparse-document path ``project_docs`` that maps raw (word_id, count) pairs
straight into the packed coordinates, O(doc nnz) per document.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..core.spca import PCResult
from ..device import as_tensor, resolve, to_host
from ..kernels import ops


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class ProjectorPack:
    """Gather representation of k sparse components over an n-word vocab.

    ``support_idx[c, j]`` is the word id of component c's j-th loading and
    ``values[c, j]`` its weight; slots past a component's cardinality hold
    (0, 0.0) — index 0 with weight exactly 0.0, so padded slots contribute
    nothing whichever column they gather.
    """

    support_idx: np.ndarray  # (k, cap) int32
    values: np.ndarray       # (k, cap) float32
    n_features: int

    @property
    def k(self) -> int:
        return int(self.support_idx.shape[0])

    @property
    def cap(self) -> int:
        return int(self.support_idx.shape[1])

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.values))


def pack_components(
    results: list[PCResult], *, n_features: int | None = None,
    cap_multiple: int = 8,
) -> ProjectorPack:
    """Pack ``fit_components`` output into a `ProjectorPack`.

    ``cap`` = max cardinality rounded up to ``cap_multiple`` so the packed
    shapes are stable across refits whose cardinalities wobble within the
    slack.
    """
    if not results:
        raise ValueError("cannot pack an empty component list")
    n = n_features if n_features is not None else int(results[0].x.shape[0])
    cap = _round_up(max(max(r.cardinality, 1) for r in results), cap_multiple)
    k = len(results)
    support_idx = np.zeros((k, cap), np.int32)
    values = np.zeros((k, cap), np.float32)
    for c, r in enumerate(results):
        s = np.asarray(r.support, np.int64)
        support_idx[c, : s.size] = s
        values[c, : s.size] = np.asarray(r.x)[s]
    return ProjectorPack(support_idx=support_idx, values=values, n_features=n)


class TopicProjector:
    """Batched document -> topic projection for one packed model, on one
    device (the card unless ``device='cpu'``).

    PyTorch runs eagerly, so nothing is traced or compiled per shape;
    ``trace_count`` keeps the reference's contract under a meaning that
    holds here: the number of distinct input shapes this projector has
    seen.  The microbatcher presents one (max_batch, n) shape forever, so
    it stays at 1 — a caller that starts sending ragged shapes shows up
    in it, as a retrace does in the reference.
    """

    def __init__(self, pack: ProjectorPack, *, impl: str = "auto",
                 device=None):
        idx = np.asarray(pack.support_idx)
        if idx.size and (idx.min() < 0 or idx.max() >= pack.n_features):
            raise ValueError(f"pack indices outside [0, {pack.n_features})")
        self.pack = pack
        self.impl = impl
        self.device = resolve(device)
        self._sidx = as_tensor(np.asarray(idx, np.int32), self.device)
        self._vals = as_tensor(np.asarray(pack.values, np.float32),
                               self.device)
        self._shapes: set[tuple] = set()
        self._shapes_lock = threading.Lock()
        # Word id -> packed slot(s), sorted-CSR style, for the sparse-doc
        # fast path.  A word may own several slots when component supports
        # overlap (Hotelling 'project' deflation does not guarantee the
        # disjoint supports 'remove' deflation produces).
        flat = idx.reshape(-1)
        live = np.flatnonzero(np.asarray(pack.values).reshape(-1) != 0)
        order = np.argsort(flat[live], kind="stable")
        self._sorted_words = flat[live][order]   # (nnz,) ascending word ids
        self._sorted_slots = live[order]         # (nnz,) their flat slots

    @property
    def trace_count(self) -> int:
        return len(self._shapes)

    def project(self, X) -> torch.Tensor:
        """(B, n) counts (numpy or a tensor) -> (B, k) float32 scores, a
        tensor on the projector's device.  Host input goes to the device
        by a copy on the calling thread's current stream; reading the
        result on the host (``.cpu()``) waits for the launch."""
        X = as_tensor(X, self.device, torch.float32)
        with self._shapes_lock:
            self._shapes.add(tuple(X.shape))
        return ops.sparse_project(X.contiguous(), self._sidx, self._vals,
                                  impl=self.impl)

    def project_docs(self, docs) -> np.ndarray:
        """Sparse path: ``docs`` is a list of (word_ids, counts) pairs.

        Work is O(total doc nnz + slot hits): each (word, count) lands in
        *every* packed slot that word owns (supports may overlap under
        'project' deflation) via binary search on the sorted slot table,
        then a (B, k*cap) x (k*cap,) weighted fold produces the scores.
        No n-length buffer anywhere; numpy on the host.
        """
        k, cap = self.pack.k, self.pack.cap
        G = np.zeros((len(docs), k * cap), np.float32)
        for d, (wi, ct) in enumerate(docs):
            wi = np.asarray(wi, np.int64)
            lo = np.searchsorted(self._sorted_words, wi, side="left")
            hi = np.searchsorted(self._sorted_words, wi, side="right")
            reps = hi - lo                      # slots owned per doc word
            if not reps.any():
                continue
            total = int(reps.sum())
            starts = np.cumsum(reps) - reps
            # flat indices [lo_j, hi_j) for every doc word j, concatenated
            r = (np.arange(total) - np.repeat(starts, reps)
                 + np.repeat(lo, reps))
            np.add.at(G[d], self._sorted_slots[r],
                      np.repeat(np.asarray(ct, np.float32), reps))
        g = G.reshape(len(docs), k, cap)
        return np.einsum("bkc,kc->bk", g, self.pack.values)

    def assign_topics(self, scores) -> tuple[np.ndarray, np.ndarray]:
        """Cluster interpretation: (topic id, |score|) per document."""
        s = np.abs(to_host(scores))
        top = np.argmax(s, axis=1)
        return top, s[np.arange(s.shape[0]), top]
