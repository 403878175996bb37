"""The port's meshes: the 1-D data mesh of the sparse-PCA leg and the
LM's 2-D and 3-D meshes (port of ``repro.launch.mesh``).

**What a mesh is here.**  The reference's mesh is one process driving its
local devices through ``shard_map`` and ``jit``: single-process SPMD
(``repro/launch/train.py`` says so too).  Its counterpart here is one
process driving *lanes*: each lane is a ``(torch.device,
torch.cuda.Stream)`` pair, and work for a lane is queued on that lane's
stream, so lanes run concurrently where the hardware lets them.  There is
no ``torch.distributed`` process group: one card cannot hold two NCCL
ranks, and none is needed for one process.

* A `DataMesh` is the ordered tuple of D lanes (`make_data_mesh`), the
  sparse leg's mesh; lane 0 is where partials meet.
* A `LaneMesh` is an N-D grid of the same lanes with named axes
  (`make_dev_mesh`, `make_production_mesh`).  ``axis_names`` and ``shape``
  (a dict from axis name to size, as jax's ``mesh.shape``) are what the
  logical-axis rules of `repro_torch.distributed.sharding` read, as the
  reference's rules read a ``Mesh``.  Its lanes are numbered in row-major
  order of the grid.

Lanes take the first CUDA devices, one lane a device.  With fewer devices
a mesh constructor raises, as the reference does, unless *forced lanes*
are set: ``REPRO_TORCH_FORCE_LANES=D`` in the environment lets up to D
lanes share the devices that exist, round robin, each lane on its own
stream (the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=D``).  On the CPU
(``device='cpu'``) lanes are ``cpu`` lanes with no stream: one without
forcing, D with it.  On ``device='meta'`` lanes are ``meta`` lanes with no
stream and no memory, as many as asked for: the dry-run
(`launch.dryrun`) needs a production mesh's shape and names only.  Lanes
never share a device unless forced lanes were set, and a constructor never
falls back to fewer lanes than asked for.
"""
from __future__ import annotations

import contextlib
import math
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


def _resolve_lane_device(device) -> torch.device:
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve(device)


def _lanes(n: int, dev: torch.device) -> tuple:
    """``n`` lanes on ``dev``'s type: ``meta`` lanes without a check,
    else the first ``n`` of `lanes_available` (raising with the way out
    when there are fewer)."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one lane, got {n}")
    if dev.type == "meta":
        return tuple(Lane(torch.device("meta"), None) for _ in range(n))
    avail = lanes_available(dev)
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


def make_data_mesh(n_devices: int = 0, *, device=None) -> DataMesh:
    """The data mesh over the first ``n_devices`` lanes (0 = every lane
    available) on ``device``'s type (the card by default).

    CUDA lanes take the devices in order, each lane with a new stream of
    its own; a forced mesh wider than the card count deals its lanes round
    robin over the devices.  Asking for more lanes than exist raises,
    naming the way out."""
    dev = resolve(device)
    n = int(n_devices) if n_devices else lanes_available(dev)
    return _lanes(n, dev)


class LaneMesh:
    """An N-D grid of lanes with named axes: the counterpart of a
    ``jax.sharding.Mesh`` (see the module note).

    ``lanes`` holds the grid's lanes in row-major order; ``axis_names``
    the axes, major first; ``shape`` maps each axis name to its size, as
    jax's ``mesh.shape`` does; ``devices_shape`` is the grid's shape as a
    tuple.  Iterating a mesh gives its lanes in order, so `sync_lanes`
    takes either kind of mesh."""

    def __init__(self, lanes, shape, axis_names):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axes {axis_names} repeat a name")
        if len(lanes) != math.prod(shape):
            raise ValueError(f"{len(lanes)} lanes for a {shape} mesh")
        self.lanes = tuple(lanes)
        self.devices_shape = shape
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    def __iter__(self):
        return iter(self.lanes)

    def __len__(self):
        return len(self.lanes)

    @property
    def size(self) -> int:
        return len(self.lanes)

    def coords(self, index: int) -> dict:
        """Lane ``index``'s coordinate on every axis."""
        out = {}
        for name, size in zip(reversed(self.axis_names),
                              reversed(self.devices_shape)):
            index, out[name] = divmod(index, size)
        return {a: out[a] for a in self.axis_names}

    def index(self, coords: dict) -> int:
        """The lane at ``coords`` (axes left out are at 0)."""
        i = 0
        for name, size in zip(self.axis_names, self.devices_shape):
            i = i * size + int(coords.get(name, 0))
        return i

    def group_index(self, coords: dict, axes) -> int:
        """Where ``coords`` falls among the groups of ``axes``: the
        row-major index of its coordinates on those axes (0 for none)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + int(coords[a])
        return i

    def group_lanes(self, axes) -> tuple:
        """The first lane of each group along ``axes``: the lane whose
        coordinates on the other axes are 0, in row-major order of
        ``axes`` (the lanes a reduction over ``axes`` meets)."""
        axes = tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"{a!r} is not an axis of {self}")
        n = math.prod(self.shape[a] for a in axes)
        out = []
        for g in range(n):
            coords, rest = {}, g
            for a in reversed(axes):
                rest, coords[a] = divmod(rest, self.shape[a])
            out.append(self.lanes[self.index(coords)])
        return tuple(out)

    def __repr__(self):
        kind = self.lanes[0].device.type
        return f"LaneMesh({self.shape}, {kind})"


def _grid(shape, axes, device) -> LaneMesh:
    dev = _resolve_lane_device(device)
    return LaneMesh(_lanes(math.prod(shape), dev), shape, axes)


def make_dev_mesh(shape=(2, 2), axes=("data", "model"), *,
                  device=None) -> LaneMesh:
    """A small mesh of ``prod(shape)`` lanes on ``device``'s type (the
    card by default), taken as `make_data_mesh` takes them.  Too few
    lanes raises, naming ``REPRO_TORCH_FORCE_LANES``; it never falls back
    to fewer."""
    return _grid(tuple(shape), tuple(axes), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> LaneMesh:
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    with ``multi_pod`` ``(2, 16, 16)`` over ``("pod", "data", "model")``.
    ``device="meta"`` gives meta lanes (no stream, no memory, no
    environment variable needed), which is all the dry-run reads; on
    ``cuda`` or ``cpu`` it needs that many lanes, as `make_dev_mesh`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, device)


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


def sync_lanes(mesh) -> None:
    """Wait on the host until every lane's queued work, and any other
    work on the lanes' devices, has run.  The mesh passes call it where
    lane partials meet (and once more after they are pooled), so no
    buffer made on one lane's stream is read or freed while another
    stream may still touch it: a host wait a pass, not a stream-ordering
    protocol to get wrong."""
    for dev in {lane.device for lane in mesh if lane.stream is not None}:
        torch.cuda.synchronize(dev)
