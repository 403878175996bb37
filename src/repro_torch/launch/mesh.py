"""The 1-D data mesh of the sparse-PCA leg (port of
``repro.launch.mesh.make_data_mesh``).

The reference's mesh is one process driving D local devices through
``shard_map``.  Its counterpart here is one process driving an ordered
tuple of D *lanes*: each lane is a ``(torch.device, torch.cuda.Stream)``
pair, and work for lane ``d`` is queued on lane ``d``'s stream, so the
lanes run concurrently where the hardware lets them.  There is no
``torch.distributed`` process group: the reference's sparse-PCA leg is
single-process SPMD too.

Lanes take the first D CUDA devices, one lane a device.  With fewer
devices `make_data_mesh` raises, as the reference does, unless *forced
lanes* are set: ``REPRO_TORCH_FORCE_LANES=D`` in the environment lets up
to D lanes share the devices that exist, round robin, each lane on its
own stream (the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=D``).  On the CPU
(``device='cpu'``) lanes are ``cpu`` lanes with no stream: one without
forcing, D with it.  Lanes never share a device unless forced lanes were
set.

``make_production_mesh`` and ``make_dev_mesh`` (the LM's 2-D meshes) are
not ported: they belong to ROADMAP queue 1 item 14c.
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import torch

from ..device import resolve

FORCE_LANES_ENV = "REPRO_TORCH_FORCE_LANES"


class Lane(NamedTuple):
    """One member of the data mesh: where its work runs and the stream it
    is queued on (None on the CPU)."""

    device: torch.device
    stream: torch.cuda.Stream | None


# A data mesh: the ordered tuple of its lanes; lane 0 is where partials
# meet.
DataMesh = tuple


def forced_lanes() -> int:
    """The forced lane count from ``REPRO_TORCH_FORCE_LANES`` (0 = unset)."""
    raw = os.environ.get(FORCE_LANES_ENV, "").strip()
    if not raw:
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{FORCE_LANES_ENV}={raw!r} is not an integer") \
            from None
    if n < 0:
        raise ValueError(f"{FORCE_LANES_ENV}={raw!r} must be >= 0")
    return n


def lanes_available(device=None) -> int:
    """How many lanes a mesh on ``device``'s type may have: the forced
    count when set, else one lane per CUDA device (one on the CPU)."""
    dev = resolve(device)
    forced = forced_lanes()
    if forced:
        return forced
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def make_data_mesh(n_devices: int = 0, *, device=None) -> DataMesh:
    """The data mesh over the first ``n_devices`` lanes (0 = every lane
    available) on ``device``'s type (the card by default).

    CUDA lanes take the devices in order, each lane with a new stream of
    its own; a forced mesh wider than the card count deals its lanes round
    robin over the devices.  Asking for more lanes than exist raises,
    naming the way out."""
    dev = resolve(device)
    avail = lanes_available(dev)
    n = int(n_devices) if n_devices else avail
    if n < 1:
        raise ValueError(f"a data mesh needs at least one lane, got {n}")
    if n > avail:
        raise RuntimeError(
            f"need {n} lanes, have {avail} — run under "
            f"{FORCE_LANES_ENV}={n} to let {n} lanes share the "
            f"{'devices' if dev.type == 'cuda' else 'CPU'} that exist")
    if dev.type == "cpu":
        return tuple(Lane(torch.device("cpu"), None) for _ in range(n))
    count = torch.cuda.device_count()
    lanes = []
    for d in range(n):
        cuda = torch.device("cuda", d % count)
        lanes.append(Lane(cuda, torch.cuda.Stream(device=cuda)))
    return tuple(lanes)


@contextlib.contextmanager
def lane_context(lane: Lane):
    """Queue the block's work on the lane: its stream (which also makes
    its device current), ordered after the work already queued on that
    device's current stream, so the lane reads inputs the caller made
    there; nothing on the CPU."""
    if lane.stream is None:
        yield
        return
    lane.stream.wait_stream(torch.cuda.current_stream(lane.device))
    with torch.cuda.stream(lane.stream):
        yield


def sync_lanes(mesh: DataMesh) -> None:
    """Wait on the host until every lane's queued work, and any other
    work on the lanes' devices, has run.  The mesh passes call it where
    lane partials meet (and once more after they are pooled), so no
    buffer made on one lane's stream is read or freed while another
    stream may still touch it: a host wait a pass, not a stream-ordering
    protocol to get wrong."""
    for dev in {lane.device for lane in mesh if lane.stream is not None}:
        torch.cuda.synchronize(dev)
