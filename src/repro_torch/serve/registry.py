"""Versioned model registry with atomic hot-swap and checkpoint persistence.

Port of ``repro.serve.registry``.  The serving fleet looks up "the active
model" on every batch while a refit lands a new one.  Two invariants make
that safe without a read lock:

  * a `ModelVersion` is immutable — pack, projector, certificate threshold
    and training screen are frozen at registration;
  * the active pointer is swapped with a single attribute store (atomic
    under the GIL), so a concurrent lookup sees either the old or the new
    version in full, never a torn mix.

Persistence rides `repro_torch.checkpoint` (atomic tmp-dir + rename
writes): one checkpoint step per registered version, with the reference's
tree keys and dtypes, so a registry root written by either package loads
in the other; a restarted server ``load_all()``s it back, newest version
active.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
import zipfile
from dataclasses import dataclass, field

import numpy as np

from .. import checkpoint
from ..core.elimination import Screen
from ..core.spca import PCResult
from ..device import as_tensor, resolve, to_host
from ..obs import metrics
from .projector import ProjectorPack, TopicProjector, pack_components


@dataclass(frozen=True)
class ModelVersion:
    """One immutable registered model: everything a server needs to serve
    it and to judge when it has gone stale."""

    version: int
    pack: ProjectorPack
    projector: TopicProjector
    lam: float          # loosest safe-elimination threshold (min over PCs)
    lams: np.ndarray    # per-component thresholds — each PC's own Thm 2.1
                        # certificate; the drift monitor watches all of them
    screen: Screen      # training-time variance screen (drift baseline)
    meta: dict = field(default_factory=dict)


def version_from_tree(tree: dict, *, version: int, impl: str = "auto",
                      device=None) -> ModelVersion:
    """A `ModelVersion` from a registry checkpoint tree of numpy arrays
    (the reference's keys: ``support_idx``, ``values``, ``n_features``,
    ``lam``, optional ``lams``, ``screen_var``, ``screen_mean``,
    ``screen_count``, optional ``meta_json``), served on ``device``.  The
    screen keeps the stored dtypes (``count`` as its 0-d array)."""
    pack = ProjectorPack(
        support_idx=np.asarray(tree["support_idx"], np.int32),
        values=np.asarray(tree["values"], np.float32),
        n_features=int(tree["n_features"]),
    )
    device = resolve(device)
    screen = Screen(
        variances=as_tensor(np.asarray(tree["screen_var"]), device),
        means=as_tensor(np.asarray(tree["screen_mean"]), device),
        count=np.asarray(tree["screen_count"]),
    )
    lam = float(tree["lam"])
    meta = {}
    if "meta_json" in tree:
        meta = json.loads(
            np.asarray(tree["meta_json"], np.uint8).tobytes().decode())
    return ModelVersion(
        version=version,
        pack=pack,
        projector=TopicProjector(pack, impl=impl, device=device),
        lam=lam,
        lams=np.asarray(tree.get("lams", [lam]), np.float64),
        screen=screen,
        meta=meta,
    )


class ModelRegistry:
    """Monotonically versioned store of packed models.

    ``register`` allocates the next version, persists it (when a root
    directory was given) and atomically makes it active; ``active()`` is a
    lock-free read of the current version; ``rollback`` re-activates an
    older version without refitting.  Projectors and restored screens live
    on ``device`` (the card unless ``device='cpu'``).
    """

    def __init__(self, root: str | None = None, *, impl: str = "auto",
                 device=None):
        self.root = root
        self.impl = impl
        self.device = resolve(device)
        self._lock = threading.Lock()
        self._versions: dict[int, ModelVersion] = {}
        self._active: ModelVersion | None = None

    # ------------------------------------------------------------- lookups
    def active(self) -> ModelVersion:
        mv = self._active
        if mv is None:
            raise LookupError("registry has no active model")
        return mv

    def get(self, version: int) -> ModelVersion:
        return self._versions[version]

    def versions(self) -> list[int]:
        return sorted(self._versions)

    # ------------------------------------------------------------ mutation
    def register(
        self,
        results: list[PCResult],
        screen: Screen,
        *,
        n_features: int | None = None,
        meta: dict | None = None,
        persist: bool = True,
    ) -> ModelVersion:
        """Pack, persist, and hot-swap a freshly fitted component list."""
        pack = pack_components(results, n_features=n_features)
        lams = np.asarray([r.lam for r in results], np.float64)
        with self._lock:
            version = max(self._versions, default=-1) + 1
            mv = ModelVersion(
                version=version,
                pack=pack,
                projector=TopicProjector(pack, impl=self.impl,
                                         device=self.device),
                lam=float(lams.min()),
                lams=lams,
                screen=screen,
                meta=dict(meta or {}),
            )
            if persist and self.root is not None:
                self._save(mv)
            self._versions[version] = mv
            self._active = mv    # the atomic hot-swap
        return mv

    def rollback(self, version: int) -> ModelVersion:
        with self._lock:
            mv = self._versions[version]
            self._active = mv
        return mv

    def rollback_to_last_good(self) -> ModelVersion:
        """Re-activate the newest version OLDER than the active one — the
        bad-deploy escape hatch.  Raises LookupError when there is nothing
        older to fall back to."""
        with self._lock:
            if self._active is None:
                raise LookupError("registry has no active model")
            older = [v for v in self._versions if v < self._active.version]
            if not older:
                raise LookupError(
                    f"no version older than active v{self._active.version} "
                    "to roll back to"
                )
            mv = self._versions[max(older)]
            self._active = mv
        metrics.counter("serve.registry.rollbacks").inc()
        return mv

    # --------------------------------------------------------- persistence
    def _save(self, mv: ModelVersion) -> str:
        # the reference's keys and dtypes; the screen's arrays and count
        # keep the dtypes they were given
        tree = {
            "support_idx": mv.pack.support_idx,
            "values": mv.pack.values,
            "n_features": np.asarray(mv.pack.n_features, np.int64),
            "lam": np.asarray(mv.lam, np.float64),
            "lams": mv.lams,
            "screen_var": to_host(mv.screen.variances),
            "screen_mean": to_host(mv.screen.means),
            "screen_count": np.asarray(mv.screen.count),
            # JSON-as-bytes: checkpoint leaves are arrays, meta is not.
            "meta_json": np.frombuffer(
                json.dumps(mv.meta).encode(), dtype=np.uint8),
        }
        return checkpoint.save(self.root, mv.version, tree)

    def _load_version(self, version: int) -> ModelVersion:
        d = os.path.join(self.root, f"step_{version:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like = {k: np.empty(tuple(v["shape"]), np.dtype(v["dtype"]))
                for k, v in manifest["leaves"].items()}
        tree = checkpoint.restore(self.root, version, like)
        return version_from_tree({k: v.numpy() for k, v in tree.items()},
                                 version=version, impl=self.impl,
                                 device=self.device)

    def load_all(self) -> list[int]:
        """Restore every persisted version; newest loadable becomes active.

        A corrupt version directory (truncated npz, torn manifest, missing
        files — what a crashed writer or bad disk leaves behind) is
        SKIPPED with a warning and a ``serve.registry.corrupt`` count, not
        allowed to crash server startup: the fleet comes back up on every
        version that still loads."""
        if self.root is None or not os.path.isdir(self.root):
            return []
        steps = []
        for d in os.listdir(self.root):
            if not d.startswith("step_") or d.endswith(".tmp"):
                continue
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                continue
        loaded: list[int] = []
        with self._lock:
            for s in sorted(steps):
                try:
                    self._versions[s] = self._load_version(s)
                # RuntimeError is checkpoint.restore's "corrupt or missing"
                # signal; the rest covers torn manifests and shape drift.
                except (OSError, ValueError, KeyError, TypeError,
                        RuntimeError, json.JSONDecodeError,
                        zipfile.BadZipFile) as e:
                    metrics.counter("serve.registry.corrupt").inc()
                    warnings.warn(
                        f"registry: skipping corrupt version {s} at "
                        f"{self.root}: {type(e).__name__}: {e}",
                        RuntimeWarning, stacklevel=2,
                    )
                    continue
                loaded.append(s)
            if loaded:
                self._active = self._versions[loaded[-1]]
        return loaded
