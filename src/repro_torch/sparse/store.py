"""Disk-backed sharded CSR store — the out-of-core corpus substrate.

Port of ``repro.sparse.store`` (numpy only), byte-compatible both ways: a
store written by either package loads in the other, with the same
manifest v2 JSON and the same ``.npy`` bytes.

The paper's corpora are "so large that we cannot even load them into memory
all at once" (NYTimes 300k x 102,660 at 1 GB, PubMed 8.2M x 141,043 at
7.8 GB), and text BOW matrices are >99% sparse — so the on-disk format is
CSR split into row-range *shards*, each shard three flat ``.npy`` files
(``values`` f32, ``col_ids`` i32, ``row_ptr`` i64) memory-mapped at read
time, plus a ``manifest.json`` describing the whole matrix.  Nothing about
the store requires the matrix (or even one shard) to fit in memory.

Chunk contract (what the CSR kernels consume)
--------------------------------------------
``SparseCorpus.iter_chunks`` yields fixed-shape :class:`CSRChunk`s of
exactly ``(chunk_nnz,)`` slots, so every launch on a pass has one shape,
the ragged tail included:

  * whole rows only — a document never spans two chunks (the gather-Gram
    accumulates per-chunk outer products, which would drop cross terms for
    a split row); a single row with nnz > chunk_nnz raises.
  * ``seg_ids[p]`` is the row *local to the chunk* (< chunk_rows), so the
    Gram kernel can densify into fixed (chunk_rows, ·) panels.
  * padded slots carry ``value 0, col_id 0, seg_id 0`` — additively
    harmless for every consumer (stats scatter and Gram densify alike).
  * empty rows occupy no slots but still count via ``n_rows`` (they shift
    means/variances exactly like a zero dense row).

Multi-host: shards are the unit of work — host ``h`` of ``H`` iterates
``shards[h::H]`` and the partial accumulators merge with one
``combine_screens`` (see ``repro_torch.sparse.engine``).

Integrity & fault tolerance (manifest v2)
-----------------------------------------
A multi-hour streaming pass must never fold a truncated or bit-flipped
shard into a Gram — a wrong answer is strictly worse than a crash.  The
store therefore:

  * records a crc32 per array file in the manifest (``checksums`` on each
    shard entry; version 2 — version-1 manifests still load, they just
    carry no checksums to verify);
  * publishes every shard file AND the manifest atomically (write to a
    ``.tmp`` sibling, fsync, ``os.replace``), so a killed writer leaves
    either the previous complete state or a ``.tmp`` leftover — never a
    half-written file a reader would trust;
  * verifies at read time: structural checks (dtype + element count
    against the manifest) on every open, the crc32 once per shard file
    per handle (cached in ``_verified`` — repeated passes over the same
    handle pay nothing).  Failures raise :class:`ShardCorruptionError`
    naming the shard file, which is typed precisely so the retry layer
    can refuse to retry it;
  * retries transient ``OSError``s at the file-open seam with bounded
    exponential backoff (``io_retries`` / ``io_backoff_s`` on the
    handle), counting ``ingest.retries`` in the metrics registry.

All file I/O goes through the module-level :data:`FILE_IO` seam so a
fault-injection harness can wrap ONE object to exercise every failure
path deterministically.
"""
from __future__ import annotations

import json
import os
import time
import zlib
from typing import Iterator, NamedTuple

import numpy as np

from ..obs import metrics

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 2
# Versions this reader accepts: v1 (no checksums) still loads — old stores
# keep working, they just cannot be checksum-verified.
SUPPORTED_VERSIONS = (1, 2)

# Retry policy defaults for transient read errors (a flaky NFS mount, a
# briefly unreachable blob store).  Zero-overhead when nothing fails: the
# happy path is one try/except around the open.
DEFAULT_IO_RETRIES = 2
DEFAULT_IO_BACKOFF_S = 0.05


class ShardCorruptionError(RuntimeError):
    """A store file failed integrity verification (truncation, bit flip,
    dtype/shape mismatch, or an unreadable npy header).

    Carries the offending file name in ``shard`` so operators can locate
    and re-replicate it.  Deliberately NOT an ``OSError``: corruption is
    deterministic — the retry layer must re-raise it immediately instead
    of burning its backoff budget re-reading the same bad bytes.
    """

    def __init__(self, msg: str, *, shard: str = ""):
        super().__init__(msg)
        self.shard = shard


class _FileIO:
    """The ONE seam every store read/write goes through.

    A fault injector (the reference's `testing.faults.FaultInjector`;
    ROADMAP queue 1 item 8 ports it) subclasses this and is swapped in to
    inject deterministic failures; production code never touches files
    except through the module-level ``FILE_IO``.
    """

    def load_array(self, path: str, *, mmap_mode: str | None = None):
        return np.load(path, mmap_mode=mmap_mode)

    def save_array(self, path: str, arr: np.ndarray) -> None:
        with open(path, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())

    def write_text(self, path: str, text: str) -> None:
        with open(path, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())

    def read_text(self, path: str) -> str:
        with open(path) as f:
            return f.read()

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)


FILE_IO = _FileIO()


def _crc32(arr: np.ndarray) -> int:
    """crc32 of an array's raw data bytes (header-independent, so a
    rewritten npy with a cosmetic header change still verifies)."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.view(np.uint8).reshape(-1)) & 0xFFFFFFFF


def _atomic_save_array(path: str, arr: np.ndarray) -> None:
    """Publish ``arr`` at ``path`` via tmp + rename: a reader never sees a
    partially written file under the final name."""
    tmp = path + ".tmp"
    FILE_IO.save_array(tmp, arr)
    FILE_IO.replace(tmp, path)


def _atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    FILE_IO.write_text(tmp, text)
    FILE_IO.replace(tmp, path)

# Default chunk geometry: 16k nnz slots / 512 rows keeps the Gram kernel's
# densify scratch at chunk_rows * n_hat_pad * 4 B (4 MB at n_hat = 2048).
DEFAULT_CHUNK_NNZ = 16_384
DEFAULT_CHUNK_ROWS = 512


class CSRChunk(NamedTuple):
    """One fixed-shape padded chunk of whole CSR rows.

    ``values``/``col_ids``/``seg_ids`` all have shape ``(chunk_nnz,)``;
    slots past ``nnz`` are padding (value 0, col 0, seg 0).
    """

    values: np.ndarray    # (chunk_nnz,) float32
    col_ids: np.ndarray   # (chunk_nnz,) int32, global column ids
    seg_ids: np.ndarray   # (chunk_nnz,) int32, chunk-local row ids
    row_offset: int       # global row index of local row 0
    n_rows: int           # real rows packed in this chunk (incl. empty rows)
    nnz: int              # real entries (<= chunk_nnz)


class CSRMegaBatch(NamedTuple):
    """A fixed-shape batch of C chunks — what ONE ingest kernel launch
    consumes (`ops.csr_column_stats` / `ops.csr_gram_batched`).

    All entry arrays are (C, chunk_nnz); slot ``i`` obeys the `CSRChunk`
    padding contract independently (slots past ``nnz[i]`` are value 0,
    col 0, seg 0).  A ragged final batch pads with empty slots
    (``n_rows == nnz == 0`` — additively harmless everywhere), so the
    shape — and therefore every launch's shape — never changes.

    When produced by ``iter_megabatches(reuse_buffers=True)`` the arrays
    are views into a rotating buffer ring: they are valid until ``ring``
    more batches have been drawn from the same iterator (sized so a
    depth-2 prefetch queue plus the in-flight producer/consumer items
    never alias).  The `repro_torch.kernels.ops` CSR wrappers finish
    their host-to-device copy (a blocking copy) before they return, so a
    consumer that hands a batch straight to them is done with the buffer
    when the call returns.
    """

    values: np.ndarray     # (C, chunk_nnz) float32
    col_ids: np.ndarray    # (C, chunk_nnz) int32, global column ids
    seg_ids: np.ndarray    # (C, chunk_nnz) int32, chunk-local row ids
    row_offset: np.ndarray  # (C,) int64 global row of each slot (0 if unused)
    n_rows: np.ndarray     # (C,) int32 real rows per slot (0 = unused slot)
    nnz: np.ndarray        # (C,) int64 real entries per slot
    n_chunks: int          # real chunks packed (<= C)


def _fill_slot(values, col_ids, seg_ids, vals, cols, row_ptr, r, stop):
    """Copy whole rows [r, stop) of one shard into a padded chunk slot
    (1-D views), upholding the padding contract: slots past nnz carry
    value 0, col 0, seg 0.  The ONE fill routine both `iter_chunks` and
    `iter_megabatches` use, so the two paths cannot drift on the
    contract.  Returns ``(n_rows, nnz)``."""
    lo, hi = int(row_ptr[r]), int(row_ptr[stop])
    k = hi - lo
    values[:k] = vals[lo:hi]
    col_ids[:k] = cols[lo:hi]
    seg_ids[:k] = np.repeat(
        np.arange(stop - r, dtype=np.int32),
        np.diff(row_ptr[r : stop + 1]).astype(np.int64),
    )
    values[k:] = 0.0
    col_ids[k:] = 0
    seg_ids[k:] = 0
    return stop - r, k


def _shard_chunk_bounds(row_ptr: np.ndarray, chunk_nnz: int,
                        chunk_rows: int, row_offset: int) -> np.ndarray:
    """Greedy whole-row chunk boundaries for one shard: ``bounds[i]`` is
    the first row of chunk ``i`` (terminated by ``n_rows``).  Computed ONCE
    per (shard, geometry) and cached — the per-iteration searchsorted pack
    this replaces re-derived the same boundaries every pass."""
    n_rows = row_ptr.size - 1
    bounds = [0]
    r = 0
    while r < n_rows:
        lo = int(row_ptr[r])
        r_hi = min(r + chunk_rows, n_rows)
        stop = int(
            np.searchsorted(row_ptr[r + 1 : r_hi + 1], lo + chunk_nnz,
                            side="right")
        ) + r
        if stop == r:
            raise ValueError(
                f"row {row_offset + r} has "
                f"{int(row_ptr[r + 1]) - lo} nnz > chunk_nnz="
                f"{chunk_nnz}; raise chunk_nnz (rows may not span "
                f"chunks — the gather-Gram needs whole rows)"
            )
        bounds.append(stop)
        r = stop
    return np.asarray(bounds, np.int64)


class CSRStoreWriter:
    """Appends CSR row blocks and splits them into shards on disk.

    A shard closes at the first row boundary past ``shard_nnz`` stored
    entries, so shards are row-aligned and independently iterable.
    """

    def __init__(self, path: str, n_cols: int, *, shard_nnz: int = 1 << 22):
        self.path = path
        self.n_cols = int(n_cols)
        self.shard_nnz = int(shard_nnz)
        os.makedirs(path, exist_ok=True)
        self._shards: list[dict] = []
        self._vals: list[np.ndarray] = []
        self._cols: list[np.ndarray] = []
        self._lens: list[np.ndarray] = []   # per-row nnz for the open shard
        self._open_nnz = 0
        self._total_rows = 0
        self._total_nnz = 0
        self._finished = False

    def append_csr(self, values, col_ids, row_ptr) -> None:
        """Append a block of rows given as local CSR arrays."""
        values = np.asarray(values, np.float32)
        col_ids = np.asarray(col_ids, np.int32)
        row_ptr = np.asarray(row_ptr, np.int64)
        if row_ptr[0] != 0 or row_ptr[-1] != values.size:
            raise ValueError("row_ptr must start at 0 and end at nnz")
        if col_ids.size and (col_ids.min() < 0 or col_ids.max() >= self.n_cols):
            raise ValueError("col_ids out of range")
        lens = np.diff(row_ptr)
        # Split the incoming block at shard boundaries (row-aligned).
        start = 0
        while start < lens.size:
            room = self.shard_nnz - self._open_nnz
            take_nnz = np.cumsum(lens[start:])
            n_take = int(np.searchsorted(take_nnz, room, side="right"))
            if n_take == 0 and self._open_nnz == 0:
                n_take = 1   # a single row larger than shard_nnz: own shard
            if n_take == 0:
                self._flush_shard()
                continue
            stop = start + n_take
            lo, hi = row_ptr[start], row_ptr[stop]
            self._vals.append(values[lo:hi])
            self._cols.append(col_ids[lo:hi])
            self._lens.append(lens[start:stop])
            self._open_nnz += int(hi - lo)
            start = stop
            if self._open_nnz >= self.shard_nnz:
                self._flush_shard()

    def append_dense(self, block: np.ndarray) -> None:
        """Convenience: sparsify a dense row block and append it."""
        block = np.asarray(block)
        rows, cols = np.nonzero(block)
        row_ptr = np.zeros(block.shape[0] + 1, np.int64)
        np.add.at(row_ptr, rows + 1, 1)
        self.append_csr(block[rows, cols], cols, np.cumsum(row_ptr))

    def _flush_shard(self) -> None:
        if not self._lens:
            return
        vals = np.concatenate(self._vals) if self._vals else np.zeros(0, np.float32)
        cols = np.concatenate(self._cols) if self._cols else np.zeros(0, np.int32)
        lens = np.concatenate(self._lens)
        row_ptr = np.zeros(lens.size + 1, np.int64)
        np.cumsum(lens, out=row_ptr[1:])
        k = len(self._shards)
        names = {
            "values": f"shard_{k:05d}.values.npy",
            "col_ids": f"shard_{k:05d}.col_ids.npy",
            "row_ptr": f"shard_{k:05d}.row_ptr.npy",
        }
        arrays = {"values": vals, "col_ids": cols, "row_ptr": row_ptr}
        checksums = {}
        for which, arr in arrays.items():
            # checksum BEFORE the write, publish atomically — a torn write
            # either never surfaces under the final name or mismatches.
            checksums[which] = _crc32(arr)
            _atomic_save_array(os.path.join(self.path, names[which]), arr)
        self._shards.append({
            "files": names,
            "row_offset": self._total_rows,
            "n_rows": int(lens.size),
            "nnz": int(vals.size),
            "checksums": checksums,
        })
        self._total_rows += int(lens.size)
        self._total_nnz += int(vals.size)
        self._vals, self._cols, self._lens = [], [], []
        self._open_nnz = 0

    def finish(self) -> "SparseCorpus":
        if self._finished:
            raise RuntimeError("writer already finished")
        self._flush_shard()
        self._finished = True
        manifest = {
            "version": FORMAT_VERSION,
            "n_rows": self._total_rows,
            "n_cols": self.n_cols,
            "nnz": self._total_nnz,
            "shards": self._shards,
        }
        # Atomic publication: the manifest names every shard file, so it
        # lands LAST and via rename — its presence certifies the store.
        _atomic_write_text(
            os.path.join(self.path, MANIFEST_NAME),
            json.dumps(manifest, indent=2) + "\n",
        )
        return SparseCorpus.open(self.path)


_EXPECTED_DTYPES = {
    "values": np.dtype(np.float32),
    "col_ids": np.dtype(np.int32),
    "row_ptr": np.dtype(np.int64),
}


class SparseCorpus:
    """Read handle on a sharded CSR store (shards are memory-mapped).

    ``verify_checksums`` (default on) checks each shard file's crc32
    against the manifest ONCE per handle, on first read — a K-pass fit
    verifies each byte once, not K times.  Structural checks (dtype and
    element count against the manifest) run on every open and catch
    truncation even on v1 stores that carry no checksums.

    ``io_retries``/``io_backoff_s`` bound the exponential-backoff retry
    loop around transient ``OSError``s at the file-open seam;
    :class:`ShardCorruptionError` is never retried.  Retries land in the
    ``ingest.retries`` registry counter and the handle's
    ``io_retry_count``.
    """

    def __init__(self, path: str, manifest: dict, *,
                 verify_checksums: bool = True,
                 io_retries: int = DEFAULT_IO_RETRIES,
                 io_backoff_s: float = DEFAULT_IO_BACKOFF_S):
        self.path = path
        self.manifest = manifest
        self.verify_checksums = bool(verify_checksums)
        self.io_retries = int(io_retries)
        self.io_backoff_s = float(io_backoff_s)
        self.io_retry_count = 0
        self._verified: set[str] = set()
        # (chunk_nnz, chunk_rows) -> per-shard chunk-boundary arrays,
        # computed lazily on first iteration and reused by every later
        # pass over the store (a K-component fit re-streams the corpus,
        # so the greedy pack must not be re-derived per pass).
        self._chunk_plans: dict[tuple[int, int], list[np.ndarray]] = {}

    @classmethod
    def open(cls, path: str, *, verify_checksums: bool = True,
             io_retries: int = DEFAULT_IO_RETRIES,
             io_backoff_s: float = DEFAULT_IO_BACKOFF_S) -> "SparseCorpus":
        try:
            manifest = json.loads(
                FILE_IO.read_text(os.path.join(path, MANIFEST_NAME))
            )
        except ValueError as e:   # torn/truncated JSON: corrupt, not absent
            raise ShardCorruptionError(
                f"corrupt store manifest at {path}: {e}",
                shard=MANIFEST_NAME,
            ) from e
        if manifest.get("version") not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"unsupported store version {manifest.get('version')!r}"
            )
        return cls(path, manifest, verify_checksums=verify_checksums,
                   io_retries=io_retries, io_backoff_s=io_backoff_s)

    def set_io_policy(self, *, io_retries: int | None = None,
                      io_backoff_s: float | None = None) -> "SparseCorpus":
        """Adjust the transient-read retry policy on this handle."""
        if io_retries is not None:
            self.io_retries = int(io_retries)
        if io_backoff_s is not None:
            self.io_backoff_s = float(io_backoff_s)
        return self

    @property
    def n_rows(self) -> int:
        return int(self.manifest["n_rows"])

    @property
    def n_cols(self) -> int:
        return int(self.manifest["n_cols"])

    @property
    def nnz(self) -> int:
        return int(self.manifest["nnz"])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def n_shards(self) -> int:
        return len(self.manifest["shards"])

    def _load_retrying(self, path: str, name: str) -> np.ndarray:
        """Open one array file through the FILE_IO seam, retrying transient
        OSErrors with bounded exponential backoff.  A missing file or an
        unparseable npy header is corruption (deterministic — retrying
        re-reads the same bad bytes), so those raise immediately."""
        delay = self.io_backoff_s
        for attempt in range(self.io_retries + 1):
            try:
                return FILE_IO.load_array(path, mmap_mode="r")
            except FileNotFoundError as e:
                raise ShardCorruptionError(
                    f"store file {name} is missing at {path}", shard=name
                ) from e
            except ValueError as e:     # bad magic / truncated header
                raise ShardCorruptionError(
                    f"store file {name} is unreadable (truncated or "
                    f"corrupt npy header): {e}", shard=name
                ) from e
            except OSError:
                if attempt == self.io_retries:
                    raise
                self.io_retry_count += 1
                metrics.counter("ingest.retries").inc()
                time.sleep(delay)
                delay *= 2
        raise AssertionError("unreachable")

    def _mmap(self, shard: dict, which: str) -> np.ndarray:
        """Open + verify one shard array.  Structural checks (dtype,
        element count vs the manifest) run every open; the crc32 runs once
        per (shard, array) per handle and only when the manifest carries
        checksums (v2)."""
        name = shard["files"][which]
        arr = self._load_retrying(os.path.join(self.path, name), name)
        expect_n = (int(shard["n_rows"]) + 1 if which == "row_ptr"
                    else int(shard["nnz"]))
        expect_dt = _EXPECTED_DTYPES[which]
        if arr.ndim != 1 or arr.size != expect_n or arr.dtype != expect_dt:
            raise ShardCorruptionError(
                f"shard file {name} is corrupt: got "
                f"{arr.dtype}[{arr.size}], manifest says "
                f"{expect_dt}[{expect_n}] (truncated or overwritten?)",
                shard=name,
            )
        checksums = shard.get("checksums")
        if (self.verify_checksums and checksums is not None
                and name not in self._verified):
            got = _crc32(arr)
            want = int(checksums[which])
            if got != want:
                raise ShardCorruptionError(
                    f"shard file {name} failed checksum verification "
                    f"(crc32 {got:#010x} != manifest {want:#010x}): "
                    "bit flip or torn write — refusing to fold it into "
                    "a screen/Gram", shard=name,
                )
            self._verified.add(name)
        return arr

    def verify(self) -> int:
        """Full integrity scan: re-verify every shard array against the
        manifest (ignoring the once-per-handle cache).  Returns the number
        of files checked; raises :class:`ShardCorruptionError` on the
        first failure."""
        self._verified.clear()
        n = 0
        for shard in self.manifest["shards"]:
            for which in ("values", "col_ids", "row_ptr"):
                self._mmap(shard, which)
                n += 1
        return n

    def iter_shards(self, *, host_id: int = 0, num_hosts: int = 1):
        """This host's shard slice as (values, col_ids, row_ptr, row_offset)
        memory-mapped views — shards are the multi-host unit of work."""
        if not (0 <= host_id < num_hosts):
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        for shard in self.manifest["shards"][host_id::num_hosts]:
            yield (
                self._mmap(shard, "values"),
                self._mmap(shard, "col_ids"),
                self._mmap(shard, "row_ptr"),
                int(shard["row_offset"]),
            )

    def chunk_plan(self, chunk_nnz: int = DEFAULT_CHUNK_NNZ,
                   chunk_rows: int = DEFAULT_CHUNK_ROWS) -> list[np.ndarray]:
        """Per-shard chunk row-boundary arrays for this geometry (cached:
        the greedy whole-row pack runs once per store handle, not once per
        streaming pass)."""
        key = (int(chunk_nnz), int(chunk_rows))
        plan = self._chunk_plans.get(key)
        if plan is None:
            plan = []
            for shard in self.manifest["shards"]:
                row_ptr = self._mmap(shard, "row_ptr")
                plan.append(_shard_chunk_bounds(
                    row_ptr, chunk_nnz, chunk_rows, int(shard["row_offset"])
                ))
            self._chunk_plans[key] = plan
        return plan

    def n_chunks(self, chunk_nnz: int = DEFAULT_CHUNK_NNZ,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS, *,
                 host_id: int = 0, num_hosts: int = 1) -> int:
        """Chunks one pass at this geometry yields on this host slice."""
        plan = self.chunk_plan(chunk_nnz, chunk_rows)
        return sum(b.size - 1 for b in plan[host_id::num_hosts])

    def _iter_packed(self, chunk_nnz, chunk_rows, host_id, num_hosts,
                     start_chunk: int = 0):
        """Internal: (vals_mmap, cols_mmap, row_ptr, row_offset, r, stop)
        per chunk, in deterministic shard-then-row order, off the cached
        plan.  ``start_chunk`` fast-skips the first chunks of this host's
        slice WITHOUT opening the skipped shards — a resumed pass costs
        only the remaining reads (the reference's ``sparse/resume.py``;
        ROADMAP queue 1 item 8)."""
        plan = self.chunk_plan(chunk_nnz, chunk_rows)
        shards = self.manifest["shards"]
        if not (0 <= host_id < num_hosts):
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        skip = int(start_chunk)
        for s in range(host_id, len(shards), num_hosts):
            bounds = plan[s]
            n_c = bounds.size - 1
            if skip >= n_c:       # whole shard already consumed: no reads
                skip -= n_c
                continue
            shard = shards[s]
            vals = self._mmap(shard, "values")
            cols = self._mmap(shard, "col_ids")
            row_ptr = self._mmap(shard, "row_ptr")
            for i in range(skip, n_c):
                yield (vals, cols, row_ptr, int(shard["row_offset"]),
                       int(bounds[i]), int(bounds[i + 1]))
            skip = 0

    def iter_chunks(
        self,
        *,
        chunk_nnz: int = DEFAULT_CHUNK_NNZ,
        chunk_rows: int = DEFAULT_CHUNK_ROWS,
        host_id: int = 0,
        num_hosts: int = 1,
    ) -> Iterator[CSRChunk]:
        """Fixed-shape padded chunks of whole rows (see module docstring).

        A chunk closes when the next row would overflow either the
        ``chunk_nnz`` slot budget or the ``chunk_rows`` row budget; the
        final chunk of each shard is ragged and zero-padded to shape.
        Chunks are freshly allocated (callers may hold references); the
        megabatch iterator below is the buffer-reusing hot path.
        """
        for vals, cols, row_ptr, row_offset, r, stop in self._iter_packed(
            chunk_nnz, chunk_rows, host_id, num_hosts
        ):
            values = np.empty(chunk_nnz, np.float32)
            col_ids = np.empty(chunk_nnz, np.int32)
            seg_ids = np.empty(chunk_nnz, np.int32)
            n_rows, k = _fill_slot(
                values, col_ids, seg_ids, vals, cols, row_ptr, r, stop
            )
            yield CSRChunk(
                values=values,
                col_ids=col_ids,
                seg_ids=seg_ids,
                row_offset=row_offset + r,
                n_rows=n_rows,
                nnz=k,
            )

    def iter_megabatches(
        self,
        *,
        chunk_nnz: int = DEFAULT_CHUNK_NNZ,
        chunk_rows: int = DEFAULT_CHUNK_ROWS,
        megabatch: int = 8,
        host_id: int = 0,
        num_hosts: int = 1,
        reuse_buffers: bool = True,
        ring: int = 4,
        start_batch: int = 0,
    ) -> Iterator[CSRMegaBatch]:
        """Pack C = ``megabatch`` chunks per step into fixed (C, chunk_nnz)
        arrays — the unit ONE ingest kernel launch consumes.

        ``start_batch`` skips the first ``start_batch`` megabatches of the
        pass without reading their chunks (batch boundaries are fixed by
        the cached chunk plan, so batch ``b`` always packs chunks
        ``[b*C, (b+1)*C)`` of this host's slice — the deterministic cursor
        a resumed pass restarts from).

        With ``reuse_buffers`` the (C, chunk_nnz) arrays rotate through a
        preallocated ring instead of being reallocated per batch (mmap
        read + pad lands in warm pages); ``ring`` must exceed the
        downstream prefetch depth + 1 so a queued batch is never
        overwritten before it is consumed.  Only slot tails past each
        chunk's nnz are re-zeroed, so a full chunk costs one memcpy and no
        memset.  The final batch of a pass is ragged: unused slots carry
        ``n_rows == nnz == 0`` and all-zero entries.
        """
        C = int(megabatch)
        if C < 1:
            raise ValueError(f"megabatch must be >= 1, got {megabatch}")
        buffers = [
            (
                np.zeros((C, chunk_nnz), np.float32),
                np.zeros((C, chunk_nnz), np.int32),
                np.zeros((C, chunk_nnz), np.int32),
            )
            for _ in range(max(2, ring) if reuse_buffers else 1)
        ]
        b = 0
        slot = 0
        row_offset_v = np.zeros(C, np.int64)
        n_rows_v = np.zeros(C, np.int32)
        nnz_v = np.zeros(C, np.int64)

        def emit(n_slots: int) -> CSRMegaBatch:
            values, col_ids, seg_ids = buffers[b]
            for i in range(n_slots, C):   # blank the ragged tail's slots
                values[i, :] = 0.0
                col_ids[i, :] = 0
                seg_ids[i, :] = 0
                row_offset_v[i] = 0
                n_rows_v[i] = 0
                nnz_v[i] = 0
            return CSRMegaBatch(
                values=values, col_ids=col_ids, seg_ids=seg_ids,
                row_offset=row_offset_v.copy(), n_rows=n_rows_v.copy(),
                nnz=nnz_v.copy(), n_chunks=n_slots,
            )

        for vals, cols, row_ptr, row_offset, r, stop in self._iter_packed(
            chunk_nnz, chunk_rows, host_id, num_hosts,
            start_chunk=int(start_batch) * C,
        ):
            values, col_ids, seg_ids = buffers[b]
            n_rows_v[slot], nnz_v[slot] = _fill_slot(
                values[slot], col_ids[slot], seg_ids[slot],
                vals, cols, row_ptr, r, stop,
            )
            row_offset_v[slot] = row_offset + r
            slot += 1
            if slot == C:
                yield emit(C)
                slot = 0
                if reuse_buffers:
                    b = (b + 1) % len(buffers)
                else:
                    buffers[0] = (
                        np.zeros((C, chunk_nnz), np.float32),
                        np.zeros((C, chunk_nnz), np.int32),
                        np.zeros((C, chunk_nnz), np.int32),
                    )
        if slot:
            yield emit(slot)

    def to_dense(self, *, max_bytes: int | None = None) -> np.ndarray:
        """Materialise the full matrix — tests/small stores only."""
        if max_bytes is None:
            from ..data.corpus import DENSE_BYTE_BUDGET

            max_bytes = DENSE_BYTE_BUDGET   # one budget for both guards
        need = self.n_rows * self.n_cols * 4
        if need > max_bytes:
            raise MemoryError(
                f"dense materialisation needs {need / 1e9:.2f} GB "
                f"(> {max_bytes / 1e9:.2f} GB budget); iterate "
                f"SparseCorpus.iter_chunks instead"
            )
        X = np.zeros(self.shape, np.float32)
        for chunk in self.iter_chunks():
            rows = chunk.row_offset + chunk.seg_ids[: chunk.nnz]
            np.add.at(
                X, (rows, chunk.col_ids[: chunk.nnz]), chunk.values[: chunk.nnz]
            )
        return X


def write_corpus(
    corpus, path: str, *, shard_nnz: int = 1 << 22
) -> SparseCorpus:
    """Convert an in-memory COO :class:`repro_torch.data.corpus.Corpus` into a
    sharded CSR store (the offline ingest step a real pipeline would run
    once per corpus snapshot)."""
    writer = CSRStoreWriter(path, corpus.n_words, shard_nnz=shard_nnz)
    order = np.argsort(corpus.doc_idx, kind="stable")
    di = corpus.doc_idx[order]
    wi = corpus.word_idx[order]
    ct = corpus.counts[order]
    row_ptr = np.zeros(corpus.n_docs + 1, np.int64)
    np.add.at(row_ptr, di.astype(np.int64) + 1, 1)
    np.cumsum(row_ptr, out=row_ptr)
    # Append in bounded row blocks so peak memory stays O(block nnz).
    block_rows = 65_536
    for lo_r in range(0, corpus.n_docs, block_rows):
        hi_r = min(lo_r + block_rows, corpus.n_docs)
        lo, hi = row_ptr[lo_r], row_ptr[hi_r]
        writer.append_csr(
            ct[lo:hi], wi[lo:hi], row_ptr[lo_r : hi_r + 1] - lo
        )
    return writer.finish()
