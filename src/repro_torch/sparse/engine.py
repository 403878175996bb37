"""Streaming screen/Gram over a sharded CSR store — the out-of-core leg
of the sparse-PCA preprocessing (port of ``repro.sparse.engine``).

  pass 1  sparse_feature_variances — per-column sum/sumsq through kernel
          K2, one partial `Screen` per host slice, pooled with
          `core.elimination.combine_screens`;
  pass 2  sparse_reduced_covariance — gather-Gram on the post-elimination
          support through kernel K3, never materialising an (m, n) array.

Each pass drains the store's megabatch iterator (C chunks packed into a
ring of reusable (C, chunk_nnz) host buffers) through
`data.pipeline.prefetch`, so the mmap read and pad of batch i+1 overlap
the copy and the launch of batch i.  Each megabatch is ONE kernel launch
(`update_csr_batch`), so a pass costs ceil(chunks / C) launches.

``counters`` (a plain dict) tallies the pass economics `core.spca`
surfaces via ``fit_components(diagnostics=...)``: ``screen_passes`` /
``gram_passes`` (corpus passes), ``screen_launches`` / ``gram_launches``
(ingest launches), ``chunks`` streamed, ``io_retries`` and the prefetch
queue's ``prefetch_consumer_stall_s`` / ``prefetch_producer_stall_s``.
The registry gets the same under ``ingest.*`` and ``ingest.prefetch.*``.

`sparse_stats` packages the two passes as the ``(variances, build)``
pair `core.spca` drives the lambda search with; its cross-component
covariance cache calls ``build`` ONCE per fit, so a
K-component fit costs 1 + 1 corpus passes.

Pass checkpoints (``resume_dir``) and the pass watchdog
(``pass_deadline_s``) are not ported yet (ROADMAP queue 1 item 8): the
arguments are kept, and setting one raises `NotImplementedError`
(``checkpoint_every`` comes with them).

``acc_dtype`` stands in for the reference's global x64 flag.  float32
(the default) is the reference launcher's arithmetic, x64 off: the
screen's moments are rounded to float32 and the Gram accumulates in
float32 with Neumaier compensation.  float64 is the reference's with x64
on (its tests).  The screen sums fold in float64 either way, and the
reduced covariance comes back in ``acc_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.elimination import Screen, combine_screens, select_support
from ..data.bow import StreamingGram, StreamingStats
from ..data.pipeline import prefetch
from ..device import resolve
from ..obs import metrics, trace
from .store import DEFAULT_CHUNK_NNZ, DEFAULT_CHUNK_ROWS, SparseCorpus

DEFAULT_MEGABATCH = 8
DEFAULT_PREFETCH = 2


def _not_ported(resume_dir, pass_deadline_s) -> None:
    for name, on in (("resume_dir", resume_dir),
                     ("pass_deadline_s", pass_deadline_s is not None)):
        if on:
            raise NotImplementedError(
                f"{name} (pass checkpoints / watchdog) is not ported yet: "
                "ROADMAP queue 1 item 8 (reliability)")


def _bump(counters: dict | None, **deltas) -> None:
    for k, d in deltas.items():
        metrics.counter(f"ingest.{k}").inc(d)
    if counters is None:
        return
    for k, d in deltas.items():
        counters[k] = counters.get(k, 0) + d


def _count(counters: dict | None, key: str, delta) -> None:
    """Diagnostics-dict side only (registry names off the flat
    ``ingest.<key>`` scheme)."""
    if counters is not None:
        counters[key] = counters.get(key, 0) + delta


def _stream_prefetch_stats(pstats: dict, prev: dict) -> None:
    """Push the prefetch pipeline's stall/occupancy accounting into the
    registry incrementally (delta since the previous megabatch), so a
    scrape mid-pass sees live read-bound/reduce-bound attribution."""
    if not pstats:
        return
    dc = pstats.get("consumer_stall_s", 0.0) - prev.get("consumer_stall_s", 0.0)
    dp = pstats.get("producer_stall_s", 0.0) - prev.get("producer_stall_s", 0.0)
    if dc > 0:
        metrics.counter("ingest.prefetch.consumer_stall_s").inc(dc)
        prev["consumer_stall_s"] = pstats.get("consumer_stall_s", 0.0)
    if dp > 0:
        metrics.counter("ingest.prefetch.producer_stall_s").inc(dp)
        prev["producer_stall_s"] = pstats.get("producer_stall_s", 0.0)
    items = pstats.get("items", 0)
    di = items - prev.get("items", 0)
    if di > 0:
        occ = (pstats.get("occupancy_sum", 0)
               - prev.get("occupancy_sum", 0)) / di
        metrics.histogram("ingest.prefetch.occupancy").observe(occ)
        metrics.gauge("ingest.prefetch.queue_depth").set(occ)
        prev["items"] = items
        prev["occupancy_sum"] = pstats.get("occupancy_sum", 0)


def _drain(store: SparseCorpus, acc, *, chunk_nnz, chunk_rows, megabatch,
           prefetch_depth, host_id, num_hosts, counters, launch_key):
    """One streaming pass of ``acc`` over this host's shard slice: packed
    megabatches, prefetched ``prefetch_depth`` batches ahead, one launch
    per batch.  Each megabatch gets an ``ingest.megabatch`` span (synced
    on the accumulator state while tracing, so it measures the reduction,
    not only its launch); transient-read retries absorbed by the store
    land in ``counters['io_retries']``; the prefetch queue's stall
    accounting lands in ``counters`` and ``ingest.prefetch.*`` (consumer
    stall: the pass is read-bound; producer stall: reduce-bound)."""
    retries0 = getattr(store, "io_retry_count", 0)
    it = store.iter_megabatches(
        chunk_nnz=chunk_nnz, chunk_rows=chunk_rows, megabatch=megabatch,
        host_id=host_id, num_hosts=num_hosts,
        ring=max(2, prefetch_depth + 2))
    pstats: dict = {}
    pprev: dict = {}
    if prefetch_depth > 0:
        it = prefetch(it, size=prefetch_depth, stats=pstats)
    for mb in it:
        with trace.span("ingest.megabatch", kind=launch_key,
                        chunks=int(mb.n_chunks)):
            acc.update_csr_batch(mb)
            trace.device_sync(tuple(getattr(acc, f)
                                    for f in acc._acc_fields))
        _bump(counters, **{launch_key: 1, "chunks": mb.n_chunks})
        _stream_prefetch_stats(pstats, pprev)
    dr = getattr(store, "io_retry_count", 0) - retries0
    if dr:
        _count(counters, "io_retries", dr)
    if pstats:
        _stream_prefetch_stats(pstats, pprev)
        if counters is not None:
            for k in ("consumer_stall_s", "producer_stall_s"):
                counters[f"prefetch_{k}"] = (counters.get(f"prefetch_{k}", 0.0)
                                             + pstats.get(k, 0.0))
    return acc


def _io_policy(store: SparseCorpus, io_retries, io_backoff_s) -> None:
    if io_retries is not None or io_backoff_s is not None:
        store.set_io_policy(io_retries=io_retries, io_backoff_s=io_backoff_s)


def sparse_feature_variances(
    store: SparseCorpus,
    *,
    center: bool = True,
    impl: str = "auto",
    chunk_nnz: int = DEFAULT_CHUNK_NNZ,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    megabatch: int = DEFAULT_MEGABATCH,
    prefetch_depth: int = DEFAULT_PREFETCH,
    num_hosts: int = 1,
    counters: dict | None = None,
    io_retries: int | None = None,
    io_backoff_s: float | None = None,
    resume_dir: str | None = None,
    pass_deadline_s: float | None = None,
    acc_dtype=torch.float32,
    device=None,
) -> Screen:
    """One streaming pass: the Thm 2.1 screen from CSR chunks, as
    ``acc_dtype`` tensors on ``device`` (the card by default).

    ``num_hosts > 1`` emulates the multi-host layout in one process: each
    host slice reduces its own shards into a partial Screen, pooled
    through `combine_screens`."""
    _not_ported(resume_dir, pass_deadline_s)
    _io_policy(store, io_retries, io_backoff_s)
    device = resolve(device)
    partials = []
    with trace.span("ingest.screen_pass", nnz=int(store.nnz),
                    num_hosts=num_hosts, megabatch=megabatch):
        for h in range(num_hosts):
            acc = StreamingStats(store.n_cols, impl=impl, device=device)
            _drain(store, acc, chunk_nnz=chunk_nnz, chunk_rows=chunk_rows,
                   megabatch=megabatch, prefetch_depth=prefetch_depth,
                   host_id=h, num_hosts=num_hosts, counters=counters,
                   launch_key="screen_launches")
            partials.append(acc.finalize(center=center, dtype=acc_dtype))
        _bump(counters, screen_passes=1)
        if len(partials) == 1:
            return partials[0]
        return combine_screens(partials)


def sparse_reduced_covariance(
    store: SparseCorpus,
    support: np.ndarray,
    *,
    means: np.ndarray | None = None,
    impl: str = "auto",
    chunk_nnz: int = DEFAULT_CHUNK_NNZ,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    megabatch: int = DEFAULT_MEGABATCH,
    prefetch_depth: int = DEFAULT_PREFETCH,
    num_hosts: int = 1,
    counters: dict | None = None,
    io_retries: int | None = None,
    io_backoff_s: float | None = None,
    resume_dir: str | None = None,
    pass_deadline_s: float | None = None,
    acc_dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """One streaming pass: Sigma_hat = A_S^T A_S / m (centred when
    ``means`` is given) on the surviving columns, straight from chunks, as
    an ``acc_dtype`` tensor on ``device``.  The host slices' partial Grams
    pool on the device; `finalize` is the one host transfer."""
    _not_ported(resume_dir, pass_deadline_s)
    _io_policy(store, io_retries, io_backoff_s)
    device = resolve(device)
    support = np.asarray(support)
    accs = []
    with trace.span("ingest.gram_pass", n_hat=int(support.size),
                    num_hosts=num_hosts, megabatch=megabatch):
        for h in range(num_hosts):
            acc = StreamingGram(support, impl=impl, chunk_rows=chunk_rows,
                                acc_dtype=acc_dtype, device=device)
            _drain(store, acc, chunk_nnz=chunk_nnz, chunk_rows=chunk_rows,
                   megabatch=megabatch, prefetch_depth=prefetch_depth,
                   host_id=h, num_hosts=num_hosts, counters=counters,
                   launch_key="gram_launches")
            accs.append(acc)
        _bump(counters, gram_passes=1)
        acc = accs[0]
        for other in accs[1:]:
            acc.merge(other)
        out = torch.as_tensor(acc.finalize(means=means), dtype=acc.g.dtype,
                              device=device)
        trace.device_sync(out)
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sparse_stats(
    store: SparseCorpus,
    *,
    center: bool = True,
    impl: str = "auto",
    chunk_nnz: int = DEFAULT_CHUNK_NNZ,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    megabatch: int = DEFAULT_MEGABATCH,
    prefetch_depth: int = DEFAULT_PREFETCH,
    num_hosts: int = 1,
    counters: dict | None = None,
    io_retries: int | None = None,
    io_backoff_s: float | None = None,
    resume_dir: str | None = None,
    pass_deadline_s: float | None = None,
    acc_dtype=torch.float32,
    device=None,
):
    """The ``(variances, build)`` pair `core.spca` drives the lambda search
    with, computed out-of-core: the screen pass runs now, and
    ``build(support)`` is one more streaming pass (`core.spca`'s covariance
    cache calls it ONCE per fit, so a K-component fit costs 1 + 1
    passes).  ``variances`` is an ``acc_dtype`` host array."""
    kw = dict(impl=impl, chunk_nnz=chunk_nnz, chunk_rows=chunk_rows,
              megabatch=megabatch, prefetch_depth=prefetch_depth,
              num_hosts=num_hosts, counters=counters, io_retries=io_retries,
              io_backoff_s=io_backoff_s, resume_dir=resume_dir,
              pass_deadline_s=pass_deadline_s, device=device)
    screen = sparse_feature_variances(store, center=center,
                                      acc_dtype=acc_dtype, **kw)
    means = _host(screen.means) if center else None

    def build(support):
        return sparse_reduced_covariance(store, np.asarray(support),
                                         means=means, acc_dtype=acc_dtype,
                                         **kw)

    return _host(screen.variances), build


def screen_and_gram_sparse(
    store: SparseCorpus,
    lam: float,
    *,
    center: bool = True,
    impl: str = "auto",
    max_reduced: int = 2048,
    chunk_nnz: int = DEFAULT_CHUNK_NNZ,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    megabatch: int = DEFAULT_MEGABATCH,
    prefetch_depth: int = DEFAULT_PREFETCH,
    num_hosts: int = 1,
    counters: dict | None = None,
    io_retries: int | None = None,
    io_backoff_s: float | None = None,
    resume_dir: str | None = None,
    pass_deadline_s: float | None = None,
    acc_dtype=torch.float32,
    device=None,
):
    """Two-pass out-of-core pipeline at a fixed lambda.  Returns
    (Sigma_hat, support, screen)."""
    kw = dict(impl=impl, chunk_nnz=chunk_nnz, chunk_rows=chunk_rows,
              megabatch=megabatch, prefetch_depth=prefetch_depth,
              num_hosts=num_hosts, counters=counters, io_retries=io_retries,
              io_backoff_s=io_backoff_s, resume_dir=resume_dir,
              pass_deadline_s=pass_deadline_s, device=device)
    screen = sparse_feature_variances(store, center=center,
                                      acc_dtype=acc_dtype, **kw)
    support = select_support(_host(screen.variances), lam, max_reduced)
    Sigma_hat = sparse_reduced_covariance(
        store, support, means=_host(screen.means) if center else None,
        acc_dtype=acc_dtype, **kw)
    return Sigma_hat, support, screen
