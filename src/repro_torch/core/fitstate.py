"""Whole-fit checkpoint/resume for the solver phase (port of
``repro.core.fitstate``, numpy only).

The corpus PASSES resume through `sparse.resume.PassCheckpointer`; this
module extends the same discipline to the phase that dominates wall time
after the 1+1 passes: the K lambda searches.  `FitCheckpointer`
snapshots, atomically, (a) every COMPLETED component — support, loading,
explained variance, and the reduced state deflation/refinement needs —
and (b) the ACTIVE lambda search's cursor: bracket (lo/hi), evals done,
incumbent best, and the warm-start block.  A fit killed mid-search
resumes at the last component/eval boundary and finishes with identical
final supports: finished components are never re-solved, completed evals
never re-run, completed passes never re-streamed.

Layout (one directory per fit identity under the resume root, beside the
``pass_*`` directories):

    <root>/fit_<fingerprint16>/
      meta.json     {fingerprint, complete, tree}   (arrays as {"__npz__"})
      state.npz     every ndarray in the tree, keyed a0, a1, ...

The fingerprint (`fit_fingerprint`) hashes everything a solver cursor is
only valid against: the screened variances (a crc over their bytes — the
covariance-cache identity, since the union base support is a pure
function of them), the component plan (n_components, target_card,
deflation mode), and every SPCAConfig field that steers the search
(bracket evals, sweep budgets, tolerances, warm-start and batching
switches).  A mismatched fingerprint is silently ignored — resuming a
changed fit falls back to a clean solve rather than wrong components.
Corrupt or torn checkpoints likewise load as "nothing" (the tmp+rename
publication means a killed writer can never tear the PREVIOUS
checkpoint).

State values are JSON scalars/lists/dicts with numpy arrays allowed
anywhere in the tree — no pickle, so a checkpoint can never execute
code on load.  Tensors are the caller's to bring to the host first
(`core.spca` packs with `device.to_host`).  The fingerprint, the layout
and the codec are the reference's, so a fit checkpoint written by either
package opens in the other when the two fingerprints agree — which
needs the same variance bytes (see `fit_fingerprint`).
"""
from __future__ import annotations

import io
import json
import os
import shutil
import zipfile
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..obs import metrics, trace

META_NAME = "meta.json"
STATE_NAME = "state.npz"

# SPCAConfig fields a solver-phase cursor is only valid against.  Ingest
# geometry is deliberately absent: the SAME fit state is reachable through
# different chunk plans (the passes have their own fingerprints).
_CFG_FIELDS = (
    "center", "max_reduced", "max_sweeps", "qp_sweeps", "tol", "beta",
    "support_rel_tol", "lam_search_evals", "card_slack", "tau_iters",
    "solver_impl", "reuse_covariance", "warm_start", "lam_grid_probe",
    "grid_probe_max_n", "batch_evals", "batch_deflation",
    "support_bucketing", "support_buckets",
)


def fit_fingerprint(variances, *, n_components: int, target_card: int,
                    deflation: str, cfg) -> dict:
    """Everything a saved solver cursor is only valid against, as a
    JSON-able dict.  Two fits with equal fingerprints run identical
    component/eval sequences over the same covariance identity."""
    v = np.ascontiguousarray(np.asarray(variances, np.float64))
    fp = {
        "kind": "fit",
        "n_features": int(v.shape[0]),
        "variances_crc": int(zlib.crc32(v.tobytes())),
        "n_components": int(n_components),
        "target_card": int(target_card),
        "deflation": str(deflation),
    }
    for name in _CFG_FIELDS:
        val = getattr(cfg, name, None)
        if isinstance(val, (tuple, list)):
            val = [float(v) for v in val]
        elif not (val is None or isinstance(val, (bool, int, str))):
            val = float(val)
        fp[f"cfg_{name}"] = val
    return fp


# -- pickle-free tree serialization ---------------------------------------


def _encode(obj, arrays: dict):
    """Recursively replace ndarrays in a JSON-able tree with
    ``{"__npz__": key}`` markers, collecting the arrays by key."""
    if isinstance(obj, np.ndarray):
        key = f"a{len(arrays)}"
        arrays[key] = obj
        return {"__npz__": key}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): _encode(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v, arrays) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"fit state cannot serialize {type(obj).__name__}")


def _decode(obj, z):
    if isinstance(obj, dict):
        if set(obj) == {"__npz__"}:
            return z[obj["__npz__"]]
        return {k: _decode(v, z) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, z) for v in obj]
    return obj


@dataclass
class FitState:
    """What a resumed fit gets back: the completed components (packed
    dicts, in order), the active search cursor (or None), and whether the
    whole fit already finished."""

    components: list = field(default_factory=list)
    search: dict | None = None
    complete: bool = False


class FitCheckpointer:
    """Atomic solver-phase checkpoints for one resume root.

    Usage: ``state = ckpt.open(fp)`` binds the fit identity and loads any
    usable prior state; `record_component` / `record_search` / `finish`
    then persist progress as the fit advances.  ``every`` throttles the
    search-cursor cadence (a cursor is saved every ``every`` evals and
    always at a round/bracket-hit boundary); component boundaries always
    checkpoint.
    """

    def __init__(self, root: str, *, every: int = 1):
        self.root = str(root)
        self.every = max(1, int(every))
        self._fp: dict | None = None
        self.state = FitState()
        self.saves = 0

    def _dir(self) -> str:
        # Same digest as the pass checkpoints, so fit_* and pass_* dirs
        # under one resume root share a naming discipline.  Imported
        # lazily: the sparse package imports core at init.
        from ..sparse.resume import _digest
        return os.path.join(self.root, f"fit_{_digest(self._fp)}")

    def open(self, fp: dict) -> FitState:
        """Bind the fit identity and return the newest usable state —
        missing, torn, corrupt, or fingerprint-mismatched checkpoints all
        land on a fresh `FitState`, never an exception."""
        self._fp = dict(fp)
        self.state = self._load() or FitState()
        if self.state.components or self.state.search is not None:
            metrics.counter("fit.resume.loads").inc()
            metrics.counter("fit.resume.components").inc(
                len(self.state.components)
            )
        return self.state

    def _load(self) -> FitState | None:
        d = self._dir()
        try:
            with open(os.path.join(d, META_NAME)) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != self._fp:
                return None
            with open(os.path.join(d, STATE_NAME), "rb") as f:
                buf = io.BytesIO(f.read())
            with np.load(buf) as z:
                tree = _decode(meta["tree"], z)
            return FitState(
                components=list(tree.get("components", [])),
                search=tree.get("search"),
                complete=bool(meta.get("complete", False)),
            )
        except (OSError, ValueError, KeyError, TypeError,
                zipfile.BadZipFile):
            return None

    def _save(self) -> None:
        assert self._fp is not None, "open() binds the fit identity first"
        with trace.span("fit.checkpoint",
                        components=len(self.state.components),
                        evals=(self.state.search or {}).get("evals", 0)):
            arrays: dict = {}
            tree = _encode(
                {"components": self.state.components,
                 "search": self.state.search},
                arrays,
            )
            final = self._dir()
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, STATE_NAME), "wb") as f:
                np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
                f.flush()
                os.fsync(f.fileno())
            meta = {
                "fingerprint": self._fp,
                "complete": bool(self.state.complete),
                "tree": tree,
            }
            with open(os.path.join(tmp, META_NAME), "w") as f:
                json.dump(meta, f)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        self.saves += 1
        metrics.counter("fit.resume.checkpoints").inc()

    def record_component(self, packed: dict) -> None:
        """A component finished: append it, drop the now-stale search
        cursor, and always persist (a component is hours of work)."""
        self.state.components.append(packed)
        self.state.search = None
        self._save()

    def record_search(self, cursor: dict) -> None:
        """The active lambda search advanced one eval/round.  Persisted at
        the ``every`` cadence and always when the cursor says ``done``
        (bracket hit — the next event is the component boundary)."""
        self.state.search = cursor
        if cursor.get("done") or int(cursor.get("evals", 0)) % self.every == 0:
            self._save()

    def search_cursor(self, k: int) -> dict | None:
        """The saved cursor for component ``k``, or None (a cursor from a
        different component index is stale by construction)."""
        s = self.state.search
        if s is not None and int(s.get("k", -1)) == int(k):
            return s
        return None

    def finish(self) -> None:
        """The whole fit completed: mark it so a re-run restores every
        component with zero solver work."""
        self.state.complete = True
        self.state.search = None
        self._save()

    def clear(self) -> None:
        if self._fp is None:
            return
        d = self._dir()
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(d + ".tmp", ignore_errors=True)
