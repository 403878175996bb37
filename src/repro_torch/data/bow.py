"""Streaming bag-of-words statistics (port of ``repro.data.bow``).

The corpora the paper targets do not fit in memory, so both pipeline
passes are streaming, single-pass, batch-at-a-time:

  StreamingStats  — per-word sum/sumsq for the Thm 2.1 variance screen
  StreamingGram   — A_S^T A_S on the post-elimination support

Each accumulator has three input legs sharing one accumulator state,
each through a kernel of `kernels.ops`:

  update(block)           — a dense (rows, n) row block (what
                            `Corpus.batches` yields): ONE launch of the
                            dense kernel K5 (screen) or K6 (Gram);
  update_csr(chunk)       — one `CSRChunk` of the sharded store
                            (`repro_torch.sparse.store`);
  update_csr_batch(mb)    — a `CSRMegaBatch` of C chunks with ONE kernel
                            launch (the out-of-core ingest hot path).

`screen_and_gram_streaming` is the two-pass pipeline over dense row
blocks.

State lives on the accumulator's ``device`` (the card by default): the
screen's sums fold there in float64 (the same IEEE additions the
reference folds on the host), and the Gram accumulates there, so a pass
moves no per-megabatch result to the host; `finalize` makes the one
transfer.  Both accumulators merge across host slices (`merge`, or
`core.elimination.combine_screens` on finalized screens).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from ..core.elimination import Screen, select_support
from ..device import resolve
from ..kernels import ops


def local_support_cols(support: np.ndarray, col_ids: np.ndarray) -> np.ndarray:
    """Map global column ids to support positions (the support is sorted);
    entries off the support get the ``>= n_hat`` sentinel the kernel and
    its plain version drop.  Vectorized over any entry-array shape."""
    support = np.asarray(support)
    k = support.size
    pos = np.searchsorted(support, col_ids)
    pos_c = np.minimum(pos, max(k - 1, 0))
    return np.where(support[pos_c] == col_ids, pos_c, k).astype(np.int32)


class StreamingAccumulator:
    """Shared update/merge/finalize protocol for one-pass reductions.

    Subclasses declare their summed state in ``_acc_fields`` (plus the
    always-present ``count``); ``merge`` is the one shared implementation.
    ``state_dict``/``load_state`` export and restore that state as host
    arrays, and ``state_signature`` is the JSON-able identity a pass
    checkpoint is valid against (same accumulator kind, shape and dtype).
    """

    _acc_fields: tuple[str, ...] = ()

    def update(self, batch) -> "StreamingAccumulator":
        """Fold in a dense (rows, n) row block."""
        raise NotImplementedError

    def update_csr(self, chunk) -> "StreamingAccumulator":
        """Fold in a `sparse.store.CSRChunk` (fixed-shape, padded)."""
        raise NotImplementedError

    def update_csr_batch(self, mb) -> "StreamingAccumulator":
        """Fold in a `sparse.store.CSRMegaBatch` of C chunks with a single
        kernel launch."""
        raise NotImplementedError

    def merge(self, other: "StreamingAccumulator") -> "StreamingAccumulator":
        assert type(self) is type(other), (type(self), type(other))
        self._check_mergeable(other)
        for f in self._acc_fields:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.count += other.count
        return self

    def finalize(self, **kw):
        raise NotImplementedError

    def _check_mergeable(self, other) -> None:
        pass

    def state_dict(self) -> dict:
        """Summed state as np.savez-able host arrays."""
        raise NotImplementedError

    def load_state(self, state: dict) -> "StreamingAccumulator":
        """Restore state produced by an equal-signature ``state_dict``."""
        raise NotImplementedError

    def state_signature(self) -> dict:
        """JSON-able configuration identity."""
        raise NotImplementedError


class StreamingStats(StreamingAccumulator):
    """One-pass per-column mean/variance accumulator: float64 sums on
    ``device`` of the kernel's float32 per-megabatch sums."""

    _acc_fields = ("sum", "sumsq")

    def __init__(self, n_features: int, *, impl: str = "auto", device=None):
        self.n = n_features
        self.impl = impl
        self.device = resolve(device)
        self.sum = torch.zeros(n_features, dtype=torch.float64,
                               device=self.device)
        self.sumsq = torch.zeros_like(self.sum)
        self.count = 0

    def _fold(self, values, col_ids, nnz) -> None:
        s, ss = ops.csr_column_stats(values, col_ids, n=self.n,
                                     impl=self.impl, nnz=nnz,
                                     device=self.device)
        self.sum += s.to(torch.float64)
        self.sumsq += ss.to(torch.float64)

    def update(self, batch) -> "StreamingStats":
        """A dense (rows, n) block (numpy or tensor) -> ONE launch of K5;
        its float32 sums fold into the float64 state as the CSR legs'
        do."""
        s, ss = ops.column_stats(batch, impl=self.impl, device=self.device)
        self.sum += s.to(device=self.device, dtype=torch.float64)
        self.sumsq += ss.to(device=self.device, dtype=torch.float64)
        self.count += batch.shape[0]
        return self

    def update_csr(self, chunk) -> "StreamingStats":
        self._fold(chunk.values, chunk.col_ids, chunk.nnz)
        self.count += chunk.n_rows   # empty rows count, padded slots don't
        return self

    def update_csr_batch(self, mb) -> "StreamingStats":
        """C chunks -> ONE kernel launch (and one float64 fold)."""
        self._fold(mb.values, mb.col_ids, mb.nnz)
        self.count += int(np.sum(mb.n_rows))
        return self

    def _check_mergeable(self, other) -> None:
        assert self.n == other.n

    def state_dict(self) -> dict:
        return {"sum": self.sum.cpu().numpy().copy(),
                "sumsq": self.sumsq.cpu().numpy().copy(),
                "count": np.asarray(self.count, np.int64)}

    def load_state(self, state: dict) -> "StreamingStats":
        # torch.tensor copies: the state may be a read-only view (e.g. of
        # a jax array)
        self.sum = torch.tensor(np.asarray(state["sum"]), dtype=torch.float64,
                                device=self.device)
        self.sumsq = torch.tensor(np.asarray(state["sumsq"]),
                                  dtype=torch.float64, device=self.device)
        self.count = int(state["count"])
        return self

    def state_signature(self) -> dict:
        return {"acc": "stats", "n": int(self.n)}

    def finalize(self, *, center: bool = True,
                 dtype=torch.float64) -> Screen:
        """Means and variances on ``device``, computed in float64 and
        rounded to ``dtype`` (float32 is what the reference returns with
        x64 off); the count is the true row count (an empty accumulator
        pools with weight 0)."""
        m = max(self.count, 1)   # guards the division only
        mean = self.sum / m if center else torch.zeros_like(self.sum)
        var = torch.clamp(self.sumsq / m - mean ** 2, min=0.0)
        return Screen(variances=var.to(dtype), means=mean.to(dtype),
                      count=int(self.count))


class StreamingGram(StreamingAccumulator):
    """One-pass reduced Gram accumulator over the surviving columns.

    The summed state ``g`` lives on ``device``: every update and every
    `merge` is an elementwise add there, and `finalize` makes the one host
    transfer.  ``acc_dtype`` float64 accumulates plainly; float32 (the
    default, the reference launcher's, which runs with x64 off) carries
    Neumaier compensation in ``_err``, so the error bound does not grow
    with the number of megabatches either way.
    """

    def __init__(self, support: np.ndarray, *, impl: str = "auto",
                 chunk_rows: int = 512, acc_dtype=torch.float32,
                 device=None):
        self.support = np.asarray(support)
        k = self.support.size
        self.device = resolve(device)
        if acc_dtype not in (torch.float32, torch.float64):
            raise TypeError(f"acc_dtype must be torch.float32 or "
                            f"torch.float64, got {acc_dtype}")
        self.g = torch.zeros((k, k), dtype=acc_dtype, device=self.device)
        self._err = (torch.zeros_like(self.g) if acc_dtype == torch.float32
                     else None)
        self.count = 0
        self.impl = impl
        self.chunk_rows = chunk_rows

    def _acc(self, delta) -> None:
        """Fold one partial Gram into ``g``, compensated when float32."""
        delta = torch.as_tensor(delta).to(device=self.g.device,
                                          dtype=self.g.dtype)
        if self._err is None:
            self.g = self.g + delta
            return
        t = self.g + delta
        big = self.g.abs() >= delta.abs()
        self._err = self._err + torch.where(big, (self.g - t) + delta,
                                            (delta - t) + self.g)
        self.g = t

    def update(self, batch) -> "StreamingGram":
        """A dense (rows, n) block (numpy or tensor) -> ONE launch of K6 on
        its support columns.  Those are gathered where the block lies: a
        host block before its copy (rows x n_hat values, not the block), a
        tensor by ``index_select`` on its device; the values are the
        reference's device-side gather's either way."""
        if self.support.size:
            if isinstance(batch, torch.Tensor):
                idx = torch.as_tensor(self.support, device=batch.device)
                cols = batch.index_select(1, idx)
            else:
                cols = np.ascontiguousarray(np.asarray(batch)[:, self.support])
            self._acc(ops.gram(cols, impl=self.impl, device=self.device))
        self.count += batch.shape[0]
        return self

    def _local_cols(self, col_ids: np.ndarray) -> np.ndarray:
        return local_support_cols(self.support, col_ids)

    def _check_rows(self, n_rows: int) -> None:
        if n_rows > self.chunk_rows:
            raise ValueError(
                f"chunk has {n_rows} rows > chunk_rows={self.chunk_rows}; "
                "iterate the store with chunk_rows <= the accumulator's")

    def update_csr(self, chunk) -> "StreamingGram":
        self._check_rows(chunk.n_rows)
        if self.support.size:
            self._acc(ops.csr_gram(
                chunk.values, self._local_cols(chunk.col_ids), chunk.seg_ids,
                n_rows=self.chunk_rows, n_hat=self.support.size,
                impl=self.impl, nnz=chunk.nnz, device=self.device))
        self.count += chunk.n_rows
        return self

    def update_csr_batch(self, mb) -> "StreamingGram":
        """C chunks -> ONE kernel launch, accumulated on the device."""
        self._check_rows(int(np.max(mb.n_rows, initial=0)))
        if self.support.size:
            self._acc(ops.csr_gram_batched(
                mb.values, self._local_cols(mb.col_ids), mb.seg_ids,
                n_rows=self.chunk_rows, n_hat=self.support.size,
                impl=self.impl, nnz=mb.nnz, device=self.device))
        self.count += int(np.sum(mb.n_rows))
        return self

    def merge(self, other: "StreamingGram") -> "StreamingGram":
        # the compensated fold routes the other partial's Gram through _acc
        assert type(self) is type(other), (type(self), type(other))
        self._check_mergeable(other)
        if self._err is not None:       # dtypes match, so _err does too
            self._err = self._err + other._err
        self._acc(other.g)
        self.count += other.count
        return self

    def _check_mergeable(self, other) -> None:
        assert np.array_equal(self.support, other.support)
        # mixed dtypes would silently downcast one partial (and drop its
        # compensation): fail loudly like every other mismatch
        assert self.g.dtype == other.g.dtype, (self.g.dtype, other.g.dtype)

    def state_dict(self) -> dict:
        d = {"g": self.g.cpu().numpy().copy(),
             "count": np.asarray(self.count, np.int64)}
        if self._err is not None:
            d["err"] = self._err.cpu().numpy().copy()
        return d

    def load_state(self, state: dict) -> "StreamingGram":
        self.g = torch.tensor(np.asarray(state["g"]), dtype=self.g.dtype,
                              device=self.device)
        if self._err is not None:
            self._err = (torch.tensor(np.asarray(state["err"]),
                                      dtype=self.g.dtype, device=self.device)
                         if "err" in state else torch.zeros_like(self.g))
        self.count = int(state["count"])
        return self

    def state_signature(self) -> dict:
        return {
            "acc": "gram",
            "n_hat": int(self.support.size),
            "support_crc": int(zlib.crc32(
                np.ascontiguousarray(self.support).tobytes()) & 0xFFFFFFFF),
            "dtype": str(self.g.dtype).replace("torch.", ""),
        }

    def finalize(self, *, means: np.ndarray | None = None) -> np.ndarray:
        """Sigma_hat = (G - m mu mu^T) / m as a float64 host array (the
        ONE host transfer; the compensation is re-injected first)."""
        m = max(self.count, 1)
        g = self.g.cpu().numpy().astype(np.float64)
        if self._err is not None:
            g = g + self._err.cpu().numpy().astype(np.float64)
        if means is not None:
            mu = np.asarray(means)[self.support]
            g = g - m * np.outer(mu, mu)
        return g / m


def screen_and_gram_streaming(batches, n_features: int, lam: float, *,
                              center: bool = True, impl: str = "auto",
                              max_reduced: int = 2048,
                              acc_dtype=torch.float32, device=None):
    """Two-pass pipeline over a re-iterable source of dense row blocks
    (``batches()`` yields (rows, n_features) numpy arrays or tensors, e.g.
    ``lambda: corpus.batches(256)``): pass 1 the variance screen (one K5
    launch a block), then `select_support` at ``lam``, pass 2 the reduced
    Gram on the support (one K6 launch a block).  Returns ``(Sigma_hat,
    support, screen)``: Sigma_hat a float64 host array, the screen's
    tensors on ``device`` (the card by default).

    ``acc_dtype`` stands in for the reference's global x64 flag, as in
    `sparse.engine`: float32 (the default) gives the screen in float32 and
    a compensated float32 Gram, as the reference with x64 off; float64
    gives both in float64, as the reference under x64."""
    stats = StreamingStats(n_features, impl=impl, device=device)
    for b in batches():
        stats.update(b)
    screen = stats.finalize(center=center, dtype=acc_dtype)
    support = select_support(screen.variances.cpu().numpy(), lam,
                             max_reduced)
    gram = StreamingGram(support, impl=impl, acc_dtype=acc_dtype,
                         device=device)
    for b in batches():
        gram.update(b)
    Sigma_hat = gram.finalize(
        means=screen.means.cpu().numpy() if center else None)
    return Sigma_hat, support, screen
