"""Streaming passes across the lanes of the data mesh: the data-parallel
leg of the out-of-core pipeline (port of ``repro.sparse.mesh_engine``).

`engine.py` drains the megabatch stream into ONE accumulator on ONE
device.  This module partitions the same stream across the lanes of a
`launch.mesh.DataMesh`: D consecutive megabatches are packed into a
(D, C, chunk_nnz) *superbatch*, and one dispatch folds it, lane ``d``
taking megabatch ``d`` into its own accumulator on its own device and
stream, through kernel K2 (screen) or K3 (Gram) as the single-device
passes do.  Nothing crosses lanes during the pass; the (D, ...) partial
moments meet once at finalize through `core.distributed.psum_partials`
(summed on lane 0 in lane order), the math `combine_screens` /
`StreamingGram.merge` guarantee, so a D-lane pass reproduces the
single-device moments to roundoff, and a repeated pass bit for bit.

Pass economics: a pass over B megabatches costs ceil(B/D) dispatches
(``screen_launches`` / ``gram_launches``) instead of B, each running one
kernel launch a lane that holds a megabatch; corpus passes stay 1 + 1
for a K-component fit (`mesh_sparse_stats` mirrors `engine.sparse_stats`'
``(variances, build)`` contract).

Accumulators are the reference's: ``acc_dtype`` (float32 by default, the
reference with x64 off; float64, the reference under x64) with a
Neumaier compensation slot a lane, folded where the lane's partial
lands, so the error bound does not grow with the chunk count or D.

Host buffers: each lane's inputs go to its device by a blocking copy
that has landed when the lane's launch is queued, so a superbatch's
ring slot is free again as soon as its dispatch returns; the ring keeps
``prefetch_depth + 2`` slots for the prefetch thread, as the engine's.

Observability: the drain runs under an ``ingest.shard_pass`` span
(child of the usual ``ingest.screen_pass`` / ``ingest.gram_pass``), the
``mesh.devices`` gauge records the lane count, and per-lane counters
(``ingest.shard.chunks`` / ``ingest.shard.nnz``) accumulate in per-lane
registries merged into the global one at pass end (`Registry.merge`).
Counters, spans and ``diagnostics=`` keys are the reference's.

Resume: checkpoints hold the stacked (D, ...) per-lane moments at
superbatch boundaries, in the reference's keys and layout, so a mesh
pass checkpoint crosses packages; `pass_fingerprint` carries
``n_devices``, so a cursor written at one D never restores at another.

Degraded mode: a pass that dies with a dispatch error
(`core.bcd.is_dispatch_error`: a failed launch, an out-of-memory error,
the injected double) is retried WHOLE at half the lanes, down to
``min_devices`` and finally to the single-device engine, counting
``mesh.degraded`` (registry and ``counters``).  Corruption
(`store.ShardCorruptionError`) propagates untouched.
"""
from __future__ import annotations

import functools
import zlib
from typing import NamedTuple

import numpy as np
import torch

from ..core.distributed import psum_partials
from ..core.elimination import Screen, combine_screens
from ..data.bow import local_support_cols
from ..data.pipeline import prefetch
from ..device import resolve
from ..kernels import csr_gram as csr_gram_kernel
from ..kernels import csr_stats as csr_stats_kernel
from ..kernels import ops as kernel_ops
from ..kernels import ref
from ..launch.mesh import (
    DataMesh, forced_lanes, lane_context, make_data_mesh, sync_lanes,
)
from ..obs import health, metrics, trace
from .engine import (
    DEFAULT_MEGABATCH, DEFAULT_PREFETCH, _bump, _count, _host, _reliability,
    _stream_prefetch_stats,
)
from .resume import DEFAULT_CHECKPOINT_EVERY, pass_fingerprint
from .store import DEFAULT_CHUNK_NNZ, DEFAULT_CHUNK_ROWS, SparseCorpus

# ---------------------------------------------------------------------------
# superbatches: D megabatches in one host-side package


class CSRSuperBatch(NamedTuple):
    """D megabatches stacked a lane each: what ONE dispatch consumes.
    Lane ``d`` holds megabatch ``b*D + d`` of the pass and obeys the
    `CSRMegaBatch` padding contract slot by slot; a ragged final
    superbatch leaves its empty lanes zero-filled.  The arrays are views
    into the packer's buffer ring, valid until ``ring`` more superbatches
    are drawn."""

    values: np.ndarray    # (D, C, chunk_nnz) float32
    col_ids: np.ndarray   # (D, C, chunk_nnz) int32, global column ids
    seg_ids: np.ndarray   # (D, C, chunk_nnz) int32, chunk-local row ids
    n_rows: np.ndarray    # (D, C) int32 real rows a slot
    nnz: np.ndarray       # (D, C) int64 real entries a slot
    lanes: int            # real megabatches packed (<= D)
    n_chunks: int         # real chunks across lanes
    lane_chunks: tuple    # real chunks a lane
    lane_nnz: tuple       # real nnz a lane


def _iter_superbatches(store: SparseCorpus, *, devices: int, chunk_nnz: int,
                       chunk_rows: int, megabatch: int, host_id: int,
                       num_hosts: int, ring: int, start_batch: int):
    """Pack D consecutive megabatches a yield into a rotating ring of
    (D, C, chunk_nnz) host buffers.  The megabatch views are copied into
    the superbatch at once, so the store iterator needs only its minimal
    ring; ``start_batch`` is in megabatches (the resume cursor): lane
    assignment after a mid-pass resume may differ from the original run,
    which the final moments do not see (the merge is a sum)."""
    D = int(devices)
    it = store.iter_megabatches(
        chunk_nnz=chunk_nnz, chunk_rows=chunk_rows, megabatch=megabatch,
        host_id=host_id, num_hosts=num_hosts, ring=2,
        start_batch=start_batch)
    bufs = [dict(values=np.zeros((D, megabatch, chunk_nnz), np.float32),
                 col_ids=np.zeros((D, megabatch, chunk_nnz), np.int32),
                 seg_ids=np.zeros((D, megabatch, chunk_nnz), np.int32),
                 n_rows=np.zeros((D, megabatch), np.int32),
                 nnz=np.zeros((D, megabatch), np.int64))
            for _ in range(max(2, ring))]
    slot = 0
    done = False
    while not done:
        b = bufs[slot]
        lane_chunks, lane_nnz = [], []
        for d in range(D):
            mb = next(it, None)
            if mb is None:
                done = True
                break
            for k in b:
                b[k][d] = getattr(mb, k)
            lane_chunks.append(int(mb.n_chunks))
            lane_nnz.append(int(np.sum(mb.nnz)))
        lanes = len(lane_chunks)
        if lanes == 0:
            return
        for k in b:                  # ragged tail: zero the stale lanes
            b[k][lanes:] = 0
        yield CSRSuperBatch(**b, lanes=lanes, n_chunks=sum(lane_chunks),
                            lane_chunks=tuple(lane_chunks),
                            lane_nnz=tuple(lane_nnz))
        slot = (slot + 1) % len(bufs)


# ---------------------------------------------------------------------------
# per-lane accumulators


@functools.lru_cache(maxsize=None)
def _cached_mesh(devices: int, device: str, forced: int) -> DataMesh:
    """One mesh (one stream a lane) per lane count, device and forcing,
    kept for the process, so K2's and K3's per-stream workspaces are
    reused pass after pass."""
    return make_data_mesh(devices, device=device)


def _data_mesh(devices: int, device) -> DataMesh:
    dev = resolve(device)
    return _cached_mesh(int(devices), str(dev), forced_lanes())


def _comp_add(acc, delta, err):
    """Neumaier-compensated ``acc + delta``: the sum and the new error
    slot (the reference's sharded fold, elementwise)."""
    t = acc + delta
    big = acc.abs() >= delta.abs()
    return t, err + torch.where(big, (acc - t) + delta, (delta - t) + acc)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


class _MeshAccumulator:
    """Per-lane state: for each summed field one tensor a lane, each on
    its lane's device, with a Neumaier error slot (``_err_<field>``);
    ``_state_keys`` maps the reference's ``state_dict`` keys to them, and
    ``state_dict`` stacks the lanes (D, ...), the reference's layout."""

    _state_keys: dict[str, str] = {}     # state_dict key -> attribute

    def _init_lanes(self, devices, impl, acc_dtype, device, shape):
        if acc_dtype not in (torch.float32, torch.float64):
            raise TypeError(f"acc_dtype must be torch.float32 or "
                            f"torch.float64, got {acc_dtype}")
        self.devices = int(devices)
        self.impl = impl
        self.acc_dtype = acc_dtype
        self.mesh = _data_mesh(self.devices, device)
        self.count = 0
        for attr in self._state_keys.values():
            setattr(self, attr, self._on_lanes(
                lambda lane, d: torch.zeros(shape, dtype=acc_dtype,
                                            device=lane.device)))

    def _on_lanes(self, make):
        """``make(lane, d)`` for each lane, made on the lane's stream: a
        lane's state lives and is freed in its stream's order."""
        out = []
        for d, lane in enumerate(self.mesh):
            with lane_context(lane):
                out.append(make(lane, d))
        return out

    def lane_tensors(self) -> tuple:
        return tuple(t for attr in self._state_keys.values()
                     for t in getattr(self, attr))

    def _fold(self, d: int, field: str, partial) -> None:
        acc, err = getattr(self, field), getattr(self, f"_err_{field}")
        acc[d], err[d] = _comp_add(acc[d], partial.to(self.acc_dtype), err[d])

    def merge(self, other):
        assert type(self) is type(other) and self.devices == other.devices
        for attr in self._state_keys.values():
            mine, theirs = getattr(self, attr), getattr(other, attr)
            setattr(self, attr, self._on_lanes(
                lambda lane, d: mine[d] + theirs[d].to(lane.device)))
        self.count += other.count
        return self

    def _pooled(self, *fields):
        """Each field's lanes pooled on lane 0 with its error slot
        re-injected: float64 host arrays (one transfer a moment)."""
        attrs = [a for f in fields for a in (f, f"_err_{f}")]
        pooled = psum_partials(tuple(getattr(self, a) for a in attrs),
                               self.mesh)
        host = [p.cpu().numpy().astype(np.float64) for p in pooled]
        return [host[2 * i] + host[2 * i + 1] for i in range(len(fields))]

    def state_dict(self) -> dict:
        sync_lanes(self.mesh)
        d = {key: np.stack([t.cpu().numpy() for t in getattr(self, attr)])
             for key, attr in self._state_keys.items()}
        d["count"] = np.asarray(self.count, np.int64)
        return d

    def load_state(self, state: dict):
        for key, attr in self._state_keys.items():
            arr = np.asarray(state[key])
            setattr(self, attr, self._on_lanes(
                lambda lane, d: torch.tensor(arr[d], dtype=self.acc_dtype,
                                             device=lane.device)))
        self.count = int(state["count"])
        return self


def _lane_input(a: np.ndarray, lane, dtype) -> torch.Tensor:
    """One lane's slice of a superbatch on its device, by a blocking
    copy (the ring slot may be refilled once the dispatch returns)."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=lane.device)


class MeshStats(_MeshAccumulator):
    """`StreamingStats` a lane each: per-lane (sum, sumsq) partials stay on
    their lanes for the whole pass; `finalize` pools them once."""

    _state_keys = {"sum": "sum", "sumsq": "sumsq", "err_sum": "_err_sum",
                   "err_sumsq": "_err_sumsq"}

    def __init__(self, n_features: int, *, devices: int, impl: str = "auto",
                 acc_dtype=torch.float32, device=None):
        self.n = int(n_features)
        self._init_lanes(devices, impl, acc_dtype, device, (self.n,))

    def update_superbatch(self, sb: CSRSuperBatch) -> "MeshStats":
        """One dispatch: lane d folds megabatch d with ONE launch of K2 on
        its stream (its plain version on the CPU); empty lanes add
        nothing and launch nothing."""
        for d in range(sb.lanes):
            lane = self.mesh[d]
            with lane_context(lane):
                vals = _lane_input(sb.values[d], lane, torch.float32)
                cols = _lane_input(sb.col_ids[d], lane, torch.int32)
                if kernel_ops.use_kernel(self.impl, vals):
                    ps, pss = csr_stats_kernel.csr_column_stats_cuda(
                        vals, cols, self.n)
                else:
                    ps, pss = ref.csr_column_stats_batched_ref(vals, cols,
                                                               self.n)
                self._fold(d, "sum", ps)
                self._fold(d, "sumsq", pss)
        self.count += int(np.sum(sb.n_rows))
        return self

    def finalize(self, *, center: bool = True) -> Screen:
        """Means and variances on lane 0, computed in float64 from the
        pooled moments and rounded to ``acc_dtype`` (the reference's
        arithmetic); the count is the true row count."""
        s, ss = self._pooled("sum", "sumsq")
        m = max(self.count, 1)
        mean = s / m if center else np.zeros(self.n)
        var = np.maximum(ss / m - mean ** 2, 0.0)
        dev = self.mesh[0].device
        return Screen(
            variances=torch.as_tensor(var, dtype=self.acc_dtype, device=dev),
            means=torch.as_tensor(mean, dtype=self.acc_dtype, device=dev),
            count=int(self.count))

    def state_signature(self) -> dict:
        return {"acc": "mesh_stats", "n": int(self.n),
                "devices": int(self.devices),
                "dtype": _dtype_name(self.acc_dtype)}


class MeshGram(_MeshAccumulator):
    """`StreamingGram` a lane each: per-lane (k, k) partial Grams (with
    their Neumaier slots) on their lanes for the pass, pooled once at
    finalize."""

    _state_keys = {"g": "g", "err": "_err_g"}

    def __init__(self, support: np.ndarray, *, devices: int,
                 impl: str = "auto", chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 acc_dtype=torch.float32, device=None):
        self.support = np.asarray(support)
        self.chunk_rows = int(chunk_rows)
        k = self.support.size
        self._init_lanes(devices, impl, acc_dtype, device, (k, k))

    def update_superbatch(self, sb: CSRSuperBatch) -> "MeshGram":
        """One dispatch: the superbatch's columns mapped to support
        positions once on the host, then lane d folds megabatch d with ONE
        launch of K3 on its stream (its plain version on the CPU)."""
        k = self.support.size
        if k:
            local = local_support_cols(self.support, sb.col_ids)
            for d in range(sb.lanes):
                lane = self.mesh[d]
                with lane_context(lane):
                    vals = _lane_input(sb.values[d], lane, torch.float32)
                    cols = _lane_input(local[d], lane, torch.int32)
                    segs = _lane_input(sb.seg_ids[d], lane, torch.int32)
                    if kernel_ops.use_kernel(self.impl, vals):
                        pg = csr_gram_kernel.csr_gram_cuda(
                            vals, cols, segs, self.chunk_rows, k)
                    else:
                        pg = ref.csr_gram_batched_ref(vals, cols, segs,
                                                      self.chunk_rows, k)
                    self._fold(d, "g", pg)
        self.count += int(np.sum(sb.n_rows))
        return self

    def merge(self, other: "MeshGram") -> "MeshGram":
        assert np.array_equal(self.support, other.support)
        return super().merge(other)

    def finalize(self, *, means: np.ndarray | None = None) -> np.ndarray:
        """Sigma_hat = (G - m mu mu^T) / m as a float64 host array."""
        (g,) = self._pooled("g")
        m = max(self.count, 1)
        if means is not None:
            mu = np.asarray(means)[self.support]
            g = g - m * np.outer(mu, mu)
        return g / m

    def state_signature(self) -> dict:
        return {
            "acc": "mesh_gram", "n_hat": int(self.support.size),
            "support_crc": int(zlib.crc32(
                np.ascontiguousarray(self.support).tobytes()) & 0xFFFFFFFF),
            "devices": int(self.devices),
            "dtype": _dtype_name(self.acc_dtype),
        }


# ---------------------------------------------------------------------------
# the sharded drain


def _degrade_step(e: BaseException, D: int, min_devices: int,
                  counters: dict | None) -> int | None:
    """The next rung of the degraded-mode ladder for a pass that died with
    ``e`` at ``D`` lanes: half the lanes (floored at ``min_devices``), or
    None when ``e`` is not a dispatch error or the ladder is spent (the
    caller re-raises)."""
    from ..core.bcd import is_dispatch_error

    nD = max(int(min_devices), 1, D // 2)
    if nD >= D or not is_dispatch_error(e):
        return None
    metrics.counter("mesh.degraded").inc()
    _count(counters, "mesh_degraded", 1)
    return nD


def _mesh_drain(store: SparseCorpus, acc, *, devices, chunk_nnz, chunk_rows,
                megabatch, prefetch_depth, host_id, num_hosts, counters,
                launch_key, checkpointer=None, kind: str = "",
                pass_deadline_s: float | None = None):
    """One pass across the lanes: superbatches of D megabatches,
    prefetched, ONE dispatch each, ceil(B/D) for a pass `engine._drain`
    does in B.  Mirrors `_drain`'s resume, retry, prefetch and watchdog
    accounting with its counter keys (``screen_launches`` /
    ``gram_launches`` count dispatches).  The fault seam
    ``solver_fault_before('mesh.<kind>')`` precedes every dispatch.
    Whatever ends the pass early, the prefetch thread is stopped and
    every lane's work waited for before the exception leaves."""
    D = int(devices)
    wd = None
    if pass_deadline_s is not None:
        wd = health.Watchdog(pass_deadline_s, what=f"{kind or launch_key} pass",
                             exc=health.PassDeadlineError)
    start_batch = 0
    fp = None
    if checkpointer is not None:
        fp = pass_fingerprint(
            kind or launch_key, store, chunk_nnz=chunk_nnz,
            chunk_rows=chunk_rows, megabatch=megabatch, host_id=host_id,
            num_hosts=num_hosts, signature=acc.state_signature(),
            n_devices=D)
        hit = checkpointer.load(fp)
        if hit is not None:
            cursor, state, _complete = hit
            acc.load_state(state)
            start_batch = cursor
            metrics.counter("ingest.resume.loads").inc()
            metrics.counter("ingest.resume.megabatches_skipped").inc(cursor)
            _count(counters, "resumed_megabatches", cursor)
    retries0 = getattr(store, "io_retry_count", 0)
    it = _iter_superbatches(
        store, devices=D, chunk_nnz=chunk_nnz, chunk_rows=chunk_rows,
        megabatch=megabatch, host_id=host_id, num_hosts=num_hosts,
        ring=max(2, prefetch_depth + 2), start_batch=start_batch)
    pstats: dict = {}
    pprev: dict = {}
    if prefetch_depth > 0:
        it = prefetch(it, size=prefetch_depth, stats=pstats)
    lane_regs = [metrics.Registry() for _ in range(D)]
    done = start_batch
    with trace.span("ingest.shard_pass", kind=launch_key, devices=D,
                    megabatch=megabatch):
        try:
            for sb in it:
                with trace.span("ingest.megabatch", kind=launch_key,
                                chunks=int(sb.n_chunks), lanes=int(sb.lanes)):
                    kernel_ops.solver_fault_before(f"mesh.{kind or launch_key}")
                    acc.update_superbatch(sb)
                    trace.device_sync(acc.lane_tensors())
                _bump(counters, **{launch_key: 1, "chunks": sb.n_chunks})
                for d in range(sb.lanes):
                    lane_regs[d].counter("ingest.shard.chunks").inc(
                        sb.lane_chunks[d])
                    lane_regs[d].counter("ingest.shard.nnz").inc(
                        sb.lane_nnz[d])
                _stream_prefetch_stats(pstats, pprev)
                prev_done, done = done, done + sb.lanes
                if (checkpointer is not None
                        and done // checkpointer.every
                        > prev_done // checkpointer.every):
                    with trace.span("ingest.resume.checkpoint",
                                    kind=launch_key, cursor=done):
                        checkpointer.save(fp, done, acc.state_dict())
                    metrics.counter("ingest.resume.checkpoints").inc()
                    _count(counters, "resume_checkpoints", 1)
                if wd is not None:
                    wd.check()
        except BaseException:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            sync_lanes(acc.mesh)
            raise
        if checkpointer is not None:
            checkpointer.save(fp, done, acc.state_dict(), complete=True)
            metrics.counter("ingest.resume.checkpoints").inc()
            _count(counters, "resume_checkpoints", 1)
    # pool the lane registries into the global one
    root = metrics.get_registry()
    for r in lane_regs:
        root.merge(r)
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


# ---------------------------------------------------------------------------
# public passes (signatures mirror engine.sparse_* plus ``devices``)


def mesh_feature_variances(
    store: SparseCorpus,
    *,
    devices: int,
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
    checkpoint_every: int = DEFAULT_CHECKPOINT_EVERY,
    min_devices: int = 1,
    pass_deadline_s: float | None = None,
    acc_dtype=torch.float32,
    device=None,
) -> Screen:
    """The Thm 2.1 screen in one pass across ``devices`` lanes, as
    ``acc_dtype`` tensors on lane 0 (``device``, the card by default).

    ``devices <= 1`` is the single-device engine, so callers can pass the
    config knob straight through.  A dispatch error retries the whole
    pass at D/2 down to ``min_devices`` (the module docstring's
    degraded mode)."""
    kw = dict(center=center, impl=impl, chunk_nnz=chunk_nnz,
              chunk_rows=chunk_rows, megabatch=megabatch,
              prefetch_depth=prefetch_depth, num_hosts=num_hosts,
              counters=counters, io_retries=io_retries,
              io_backoff_s=io_backoff_s, resume_dir=resume_dir,
              checkpoint_every=checkpoint_every,
              pass_deadline_s=pass_deadline_s, acc_dtype=acc_dtype,
              device=device)
    if int(devices) <= 1:
        from . import engine

        return engine.sparse_feature_variances(store, **kw)
    try:
        metrics.gauge("mesh.devices").set(int(devices))
        ckpt = _reliability(store, io_retries, io_backoff_s, resume_dir,
                            checkpoint_every)
        partials = []
        with trace.span("ingest.screen_pass", nnz=int(store.nnz),
                        num_hosts=num_hosts, megabatch=megabatch,
                        devices=int(devices)):
            for h in range(num_hosts):
                acc = MeshStats(store.n_cols, devices=devices, impl=impl,
                                acc_dtype=acc_dtype, device=device)
                _mesh_drain(
                    store, acc, devices=devices, chunk_nnz=chunk_nnz,
                    chunk_rows=chunk_rows, megabatch=megabatch,
                    prefetch_depth=prefetch_depth, host_id=h,
                    num_hosts=num_hosts, counters=counters,
                    launch_key="screen_launches", checkpointer=ckpt,
                    kind="screen", pass_deadline_s=pass_deadline_s)
                partials.append(acc.finalize(center=center))
            _bump(counters, screen_passes=1)
            if len(partials) == 1:
                return partials[0]
            return combine_screens(partials)
    except RuntimeError as e:
        nD = _degrade_step(e, int(devices), min_devices, counters)
        if nD is None:
            raise
        return mesh_feature_variances(store, devices=nD,
                                      min_devices=min_devices, **kw)


def mesh_reduced_covariance(
    store: SparseCorpus,
    support: np.ndarray,
    *,
    devices: int,
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
    checkpoint_every: int = DEFAULT_CHECKPOINT_EVERY,
    min_devices: int = 1,
    pass_deadline_s: float | None = None,
    acc_dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Sigma_hat on the surviving columns in one pass across ``devices``
    lanes, an ``acc_dtype`` tensor on lane 0."""
    kw = dict(means=means, impl=impl, chunk_nnz=chunk_nnz,
              chunk_rows=chunk_rows, megabatch=megabatch,
              prefetch_depth=prefetch_depth, num_hosts=num_hosts,
              counters=counters, io_retries=io_retries,
              io_backoff_s=io_backoff_s, resume_dir=resume_dir,
              checkpoint_every=checkpoint_every,
              pass_deadline_s=pass_deadline_s, acc_dtype=acc_dtype,
              device=device)
    if int(devices) <= 1:
        from . import engine

        return engine.sparse_reduced_covariance(store, support, **kw)
    try:
        metrics.gauge("mesh.devices").set(int(devices))
        ckpt = _reliability(store, io_retries, io_backoff_s, resume_dir,
                            checkpoint_every)
        support = np.asarray(support)
        accs = []
        with trace.span("ingest.gram_pass", n_hat=int(support.size),
                        num_hosts=num_hosts, megabatch=megabatch,
                        devices=int(devices)):
            for h in range(num_hosts):
                acc = MeshGram(support, devices=devices, impl=impl,
                               chunk_rows=chunk_rows, acc_dtype=acc_dtype,
                               device=device)
                _mesh_drain(
                    store, acc, devices=devices, chunk_nnz=chunk_nnz,
                    chunk_rows=chunk_rows, megabatch=megabatch,
                    prefetch_depth=prefetch_depth, host_id=h,
                    num_hosts=num_hosts, counters=counters,
                    launch_key="gram_launches", checkpointer=ckpt,
                    kind="gram", pass_deadline_s=pass_deadline_s)
                accs.append(acc)
            _bump(counters, gram_passes=1)
            acc = accs[0]
            for other in accs[1:]:
                acc.merge(other)
            out = torch.as_tensor(acc.finalize(means=means), dtype=acc_dtype,
                                  device=acc.mesh[0].device)
            trace.device_sync(out)
        return out
    except RuntimeError as e:
        nD = _degrade_step(e, int(devices), min_devices, counters)
        if nD is None:
            raise
        return mesh_reduced_covariance(store, support, devices=nD,
                                       min_devices=min_devices, **kw)


def mesh_sparse_stats(
    store: SparseCorpus,
    *,
    devices: int,
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
    checkpoint_every: int = DEFAULT_CHECKPOINT_EVERY,
    min_devices: int = 1,
    pass_deadline_s: float | None = None,
    acc_dtype=torch.float32,
    device=None,
):
    """The ``(variances, build)`` pair `core.spca` consumes, from passes
    across ``devices`` lanes: the same 1 + 1 corpus passes as
    `engine.sparse_stats` (the covariance cache calls ``build`` once a
    fit), ceil(B/D) dispatches a pass.  ``variances`` is an ``acc_dtype``
    host array."""
    kw = dict(devices=devices, impl=impl, chunk_nnz=chunk_nnz,
              chunk_rows=chunk_rows, megabatch=megabatch,
              prefetch_depth=prefetch_depth, num_hosts=num_hosts,
              counters=counters, io_retries=io_retries,
              io_backoff_s=io_backoff_s, resume_dir=resume_dir,
              checkpoint_every=checkpoint_every, min_devices=min_devices,
              pass_deadline_s=pass_deadline_s, acc_dtype=acc_dtype,
              device=device)
    screen = mesh_feature_variances(store, center=center, **kw)
    means = _host(screen.means) if center else None

    def build(support):
        return mesh_reduced_covariance(store, np.asarray(support),
                                       means=means, **kw)

    return _host(screen.variances), build
