"""Device meshes, sharding specs and the mesh's collectives (counterpart of
``oryx_tpu/parallel/mesh.py``).

The framework's standard mesh has one axis, ``data``, over which examples
(users, points, ratings, items) are sharded; factor and parameter
matrices are either replicated or row-sharded over the same axis.
``oryx.batch.compute.mesh`` names a shape of axis-name -> size.

A :class:`Mesh` lists its shards, each a :class:`Placement`: an explicit
``torch.device`` and the rank of the process that owns it. A mesh may
list one device more than once: the CPU tests run eight shards on the
CPU, and a one-card host runs four on ``cuda:0``. Code over a mesh is
written shard by shard: a process computes for each of its own shards
(``Mesh.local``, in shard order) and combines them with the three
collectives the JAX package gets from XLA, each over every shard of the
mesh in shard order:

- :func:`all_gather` (``lax.all_gather``, tiled),
- :func:`all_reduce_sum` (``lax.psum``),
- :func:`ring_shift` (``lax.ppermute`` by +1: shard s receives what
  shard s + 1 held, the last shard what the first held).

Within a process they combine the local shards' tensors in shard order
on the first shard's device, and give every shard its copy (shards on
one device share one tensor, so nothing may write into a result in
place). Across processes they run over ``torch.distributed``'s default
group (``parallel/distributed.py``), which such a mesh must span: every
rank owns the same number of shards, listed rank by rank. Where that
group's backend is gloo, a CUDA tensor is staged through a pinned host
buffer for the transfer only.

Port notes: the JAX package's ``NamedSharding`` becomes
:class:`Sharding`, whose :func:`put` places a host array's pieces on the
local shards. The port's ops shard over every shard of a mesh in
row-major order; for the default one-axis mesh that is the ``data``
axis, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from oryx_tpu_torch import device as device_mod
from oryx_tpu_torch.parallel import distributed

DATA_AXIS = "data"

# Per-thread device-subset override: hyperparameter candidates train
# concurrently on disjoint sub-meshes (MLUpdate.java:256-288 runs them as
# parallel Spark jobs; here each candidate thread scopes its own devices).
# A new thread starts with no scope: it never inherits another's.
_scope = threading.local()


class Placement(NamedTuple):
    """One shard's device and the rank of the process that owns it."""

    device: torch.device
    rank: int


def as_placement(d) -> Placement:
    """``d`` (a Placement, a ``torch.device`` or a device string) as a
    Placement; a bare device belongs to this process."""
    if isinstance(d, Placement):
        return d
    return Placement(torch.device(d), distributed.rank())


@contextlib.contextmanager
def device_scope(devices):
    """Restrict mesh construction in this thread to ``devices``."""
    prev = getattr(_scope, "devices", None)
    _scope.devices = [as_placement(d) for d in devices]
    try:
        yield
    finally:
        _scope.devices = prev


def scoped_devices() -> list[Placement]:
    """Devices visible to mesh construction in this thread: the thread's
    scope, else every rank's device once ``maybe_initialize`` joined a
    multi-process run, else every local CUDA device. The CPU only where
    the caller chose it (``device.set_device("cpu")``), as one device;
    without CUDA and without that choice, ``default_device()`` raises."""
    devs = getattr(_scope, "devices", None)
    if devs is not None:
        return list(devs)
    if distributed.is_initialized():
        return distributed.rank_placements()
    chosen = device_mod.chosen()
    if chosen is not None and chosen.type == "cpu":
        return [Placement(chosen, 0)]
    if torch.cuda.is_available():
        return [Placement(torch.device("cuda", i), 0) for i in range(torch.cuda.device_count())]
    return [Placement(device_mod.default_device(), 0)]  # raises: no CUDA, no choice


def partition_devices(groups: int) -> list[list[Placement]]:
    """Split the scoped devices into ``groups`` disjoint contiguous subsets
    (at most one group per device)."""
    devices = scoped_devices()
    groups = max(1, min(groups, len(devices)))
    per = len(devices) // groups
    return [devices[g * per : (g + 1) * per] for g in range(groups)]


class Mesh:
    """Shards on named axes: ``devices`` is an object array of Placements
    of the mesh's shape, ``shards`` the same in row-major order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        arr = np.empty(np.shape(devices), dtype=object)
        for pos, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[pos] = as_placement(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-d mesh needs as many axis names, got {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shards: list[Placement] = list(arr.flat)
        me = distributed.rank()
        self.local: list[int] = [i for i, s in enumerate(self.shards) if s.rank == me]
        if not self.local:
            raise ValueError(f"mesh {self} has no shard of this process (rank {me})")
        ranks = sorted({s.rank for s in self.shards})
        self.multiprocess = ranks != [me]
        if self.multiprocess:
            world = distributed.world_size()
            if ranks != list(range(world)):
                raise ValueError(f"a mesh across processes must span all {world} ranks: {ranks}")
            per = len(self.shards) // world
            if [s.rank for s in self.shards] != [r for r in range(world) for _ in range(per)]:
                raise ValueError("a mesh across processes lists each rank's shards together, "
                                 "rank by rank, the same count for every rank")

    @property
    def size(self) -> int:
        return len(self.shards)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_devices(self) -> list[torch.device]:
        return [self.shards[i].device for i in self.local]

    def __repr__(self) -> str:
        devs = ", ".join(f"{s.device}@{s.rank}" for s in self.shards)
        return f"Mesh({self.shape}, [{devs}])"


def get_mesh(spec: Mapping[str, int] | None = None, devices=None) -> Mesh:
    """A Mesh over the thread's scoped devices (all of them unless a
    device_scope is active). Default: one 'data' axis."""
    devices = scoped_devices() if devices is None else [as_placement(d) for d in devices]
    if not spec:
        arr = np.empty(len(devices), dtype=object)
        arr[:] = devices
        return Mesh(arr, (DATA_AXIS,))
    names = tuple(spec.keys())
    sizes = tuple(int(s) for s in spec.values())
    want = math.prod(sizes)
    if want > len(devices):
        raise ValueError(f"mesh {dict(spec)} needs {want} devices, have {len(devices)}")
    arr = np.empty(want, dtype=object)
    arr[:] = devices[:want]
    return Mesh(arr.reshape(sizes), names)


@dataclass(frozen=True)
class Sharding:
    """How an array lies on a mesh (``NamedSharding``): ``spec`` names, per
    array dimension, the axis it is split over, or None (replicated)."""

    mesh: Mesh
    spec: tuple


def shard_rows(mesh: Mesh, axis: str = DATA_AXIS) -> Sharding:
    """First array dim sharded over ``axis``, rest replicated."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def data_sharding(mesh: Mesh, ndim: int, axis: str = DATA_AXIS) -> Sharding:
    """Shard dim 0 over ``axis`` for an ndim-dim array."""
    return Sharding(mesh, (axis, *([None] * (ndim - 1))))


def put(array: np.ndarray, sharding: Sharding) -> list[torch.Tensor]:
    """The local shards' pieces of a host array, each on its shard's
    device: row blocks of equal size under a row sharding (the rows must
    divide evenly: pad with :func:`pad_to_multiple` first), the whole
    array under a replicated one (one copy per device)."""
    mesh = sharding.mesh
    a = np.ascontiguousarray(array)
    if not sharding.spec or sharding.spec[0] is None:
        return replicate(torch.from_numpy(a), mesh)
    if a.shape[0] % mesh.size:
        raise ValueError(f"{a.shape[0]} rows do not split evenly over {mesh.size} shards")
    per = a.shape[0] // mesh.size
    return [torch.from_numpy(a[i * per : (i + 1) * per]).to(mesh.shards[i].device)
            for i in mesh.local]


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest m >= n with m % multiple == 0 (shard-evenly helper)."""
    return ((n + multiple - 1) // multiple) * multiple


def mesh_from_config(config) -> Mesh | None:
    """Mesh per oryx.batch.compute.mesh: explicit axis spec, or all scoped
    devices on one 'data' axis when several are present, else None
    (single device: skip sharding machinery entirely)."""
    spec = config.get("oryx.batch.compute.mesh", None)
    if spec is None:
        if len(scoped_devices()) > 1:
            return get_mesh()
        return None
    return get_mesh(spec)


# -- collectives over the data axis ----------------------------------------------


def replicate(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """``t`` on every local shard's device: one copy per distinct device,
    shared by the shards on it."""
    copies: dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in mesh.local_devices():
        if dev not in copies:
            copies[dev] = t.to(dev)
        out.append(copies[dev])
    return out


def _check_local(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    if len(tensors) != len(mesh.local):
        raise ValueError(f"{len(tensors)} tensors for {len(mesh.local)} local shards")


def all_gather(mesh: Mesh, tensors: Sequence[torch.Tensor], dim: int = 0) -> list[torch.Tensor]:
    """Every shard's tensor, concatenated along ``dim`` in shard order
    (``lax.all_gather(..., tiled=True)``); one result per local shard.
    Every shard gives a tensor of one shape."""
    _check_local(mesh, tensors)
    dev = tensors[0].device
    mine = torch.cat([t.to(dev) for t in tensors], dim)
    if mesh.multiprocess:
        mine = torch.cat(distributed.all_gather(mine), dim)
    return replicate(mine, mesh)


def all_reduce_sum(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of every shard's tensor (``lax.psum``), added in shard
    order; one result per local shard."""
    _check_local(mesh, tensors)
    dev = tensors[0].device
    total = tensors[0].to(dev, copy=True)
    for t in tensors[1:]:
        total = total + t.to(dev)
    if mesh.multiprocess:
        total = distributed.all_reduce_sum(total)
    return replicate(total, mesh)


def ring_shift(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.ppermute`` by +1: shard s receives shard (s + 1) mod S's
    tensor. Every shard gives a tensor of one shape and type."""
    _check_local(mesh, tensors)
    devs = mesh.local_devices()
    nxt = list(tensors[1:])
    if mesh.multiprocess:
        nxt.append(distributed.shift_from_next(tensors[0]))
    else:
        nxt.append(tensors[0])
    return [t.to(d) for t, d in zip(nxt, devs)]
