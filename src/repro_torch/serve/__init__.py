"""Online topic-serving subsystem: project live documents onto fitted
sparse PCs.  Port of ``repro.serve``.

  projector.py — gather-packed components + batched projection
                 (kernel K4 on the card, its plain version on the CPU)
  registry.py  — versioned model store, atomic hot-swap, checkpointed
  batcher.py   — microbatching queue: ragged requests -> one fixed shape
  drift.py     — streaming variance watch on the Thm 2.1 certificate

End-to-end wiring lives in ``repro_torch.launch.serve_topics``.
"""
from . import batcher, drift, projector, registry
from .batcher import (
    BatcherConfig, LatencyStats, MicroBatcher, RequestShed, RequestTimeout,
)
from .drift import DriftMonitor, DriftReport
from .projector import ProjectorPack, TopicProjector, pack_components
from .registry import ModelRegistry, ModelVersion

__all__ = [
    "batcher", "drift", "projector", "registry",
    "BatcherConfig", "LatencyStats", "MicroBatcher", "RequestShed",
    "RequestTimeout",
    "DriftMonitor", "DriftReport",
    "ProjectorPack", "TopicProjector", "pack_components",
    "ModelRegistry", "ModelVersion",
]
