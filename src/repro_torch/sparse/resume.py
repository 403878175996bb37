"""Pass-level resume for streaming screen/Gram passes (port of
``repro.sparse.resume``, numpy only).

A corpus pass over millions of documents is a multi-hour streaming job; a
kill (preemption, OOM on a neighbour, operator error) should not mean a
full re-stream.  The megabatch chunk plan is deterministic (the greedy
bounds are a pure function of the manifest + chunk geometry), so "how far
did the pass get" is a single integer: the number of completed megabatches.
`PassCheckpointer` persists that cursor plus the accumulator's summed
moments (`StreamingAccumulator.state_dict` — the same state `merge`
pools, as host arrays) at a configurable cadence, published by tmp +
rename: a killed writer can never publish a torn checkpoint.

Layout (one directory per pass identity under the resume root):

    <root>/pass_<kind>_<fingerprint16>/
      meta.json     {fingerprint, cursor, complete}
      state.npz     accumulator state_dict arrays

The fingerprint hashes everything the cursor is only valid against — the
store identity (rows/cols/nnz/shards), the chunk geometry (chunk_nnz,
chunk_rows, megabatch), the host slice, and the accumulator signature
(`state_signature()`).  A checkpoint with a different fingerprint is
silently ignored: resuming with changed geometry falls back to a clean
pass rather than producing wrong moments.  Corrupt or half-written
checkpoints are likewise ignored (`load` returns None), never trusted.

Resume semantics: `engine._drain` loads the newest valid checkpoint,
restores the accumulator, and asks the store iterator to start at the
saved megabatch boundary (`iter_megabatches(start_batch=...)` — whole
shards before the boundary are skipped without a read).  A checkpoint
saved with ``complete=True`` marks the pass finished: resuming it streams
zero megabatches and finalizes the restored moments directly.

The layout, the fingerprint and the ``state.npz`` keys are the
reference's, so a checkpoint written by either package resumes in the
other.  Like the reference's, the checkpointer writes with plain file
calls, not through the store's ``FILE_IO`` seam, so a fault schedule
counts the same store operations in both packages.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import zipfile

import numpy as np

META_NAME = "meta.json"
STATE_NAME = "state.npz"
DEFAULT_CHECKPOINT_EVERY = 16


def pass_fingerprint(kind: str, store, *, chunk_nnz: int, chunk_rows: int,
                     megabatch: int, host_id: int, num_hosts: int,
                     signature: dict, n_devices: int = 1) -> dict:
    """Everything a saved cursor is only valid against, as a JSON-able
    dict.  Two passes with equal fingerprints stream identical megabatch
    sequences into state-compatible accumulators.  ``n_devices`` is the
    local device topology (mirrors the host topology fields): a mesh pass
    shards its accumulator state across D devices, so a checkpoint written
    at one D cannot restore at another."""
    fp = {
        "kind": str(kind),
        "n_rows": int(store.n_rows),
        "n_cols": int(store.n_cols),
        "nnz": int(store.nnz),
        "n_shards": int(store.n_shards),
        "chunk_nnz": int(chunk_nnz),
        "chunk_rows": int(chunk_rows),
        "megabatch": int(megabatch),
        "host_id": int(host_id),
        "num_hosts": int(num_hosts),
        "n_devices": int(n_devices),
    }
    for k, v in signature.items():
        fp[f"acc_{k}"] = v
    return fp


def _digest(fp: dict) -> str:
    blob = json.dumps(fp, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


class PassCheckpointer:
    """Atomic cursor+state checkpoints for one resume root.

    One instance serves every pass of a fit — each pass gets its own
    subdirectory keyed by fingerprint digest, so the screen pass and the
    Gram pass (and passes of different fits sharing a root) never collide.
    """

    def __init__(self, root: str, *, every: int = DEFAULT_CHECKPOINT_EVERY):
        self.root = str(root)
        self.every = max(1, int(every))

    def _dir(self, fp: dict) -> str:
        return os.path.join(
            self.root, f"pass_{fp['kind']}_{_digest(fp)}"
        )

    def load(self, fp: dict):
        """Return ``(cursor, state_dict, complete)`` for the newest valid
        checkpoint of this pass, or None when there is nothing usable —
        missing, torn, corrupt, or fingerprint-mismatched checkpoints all
        land on None (clean restart), never an exception."""
        d = self._dir(fp)
        try:
            with open(os.path.join(d, META_NAME)) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != fp:
                return None
            cursor = int(meta["cursor"])
            with open(os.path.join(d, STATE_NAME), "rb") as f:
                buf = io.BytesIO(f.read())
            with np.load(buf) as z:
                state = {k: z[k] for k in z.files}
            return cursor, state, bool(meta.get("complete", False))
        except (OSError, ValueError, KeyError, TypeError,
                zipfile.BadZipFile):
            return None

    def save(self, fp: dict, cursor: int, state: dict, *,
             complete: bool = False) -> str:
        """Publish atomically: state + meta land in ``<dir>.tmp`` which
        replaces the previous checkpoint only after both are flushed."""
        final = self._dir(fp)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, STATE_NAME), "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in state.items()})
            f.flush()
            os.fsync(f.fileno())
        meta = {
            "fingerprint": fp,
            "cursor": int(cursor),
            "complete": bool(complete),
        }
        with open(os.path.join(tmp, META_NAME), "w") as f:
            json.dump(meta, f, indent=2)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return final

    def clear(self, fp: dict) -> None:
        """Drop this pass's checkpoint (and any torn tmp)."""
        d = self._dir(fp)
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(d + ".tmp", ignore_errors=True)
