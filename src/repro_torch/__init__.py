"""PyTorch/CUDA port of the sparse-PCA system (Zhang & El Ghaoui, NIPS
2011) in ``repro``.

The layout mirrors ``repro``: ``core/`` (elimination, BCD, driver),
``kernels/`` (the hand-written CUDA kernels, their plain versions and
wrappers), ``obs/``, ``data/``, ``configs/`` (the experiments and the
LM architectures), ``models/`` (the LM zoo), ``train/`` (its serve
steps), ``launch/``.  The port
imports torch, numpy and the standard library, never jax or ``repro``.
Entry points run on CUDA unless given ``device="cpu"``.
"""
from .device import DEFAULT_DEVICE, DeviceUnavailable, as_tensor, resolve

__all__ = ["DEFAULT_DEVICE", "DeviceUnavailable", "as_tensor", "resolve"]
