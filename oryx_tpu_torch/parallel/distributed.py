"""Multi-process runs and the kernel compile cache (counterpart of
``oryx_tpu/parallel/distributed.py``).

The reference scales out via YARN containers coordinated by Spark; the
JAX package joins JAX's multi-controller runtime. Here every process of
a run calls ``torch.distributed.init_process_group``, and from then on
``parallel.mesh.scoped_devices()`` lists every rank's device, so a mesh
spans the run and its collectives cross processes.

Configuration (all optional; absent means single-process):

- ``oryx.batch.compute.distributed.coordinator-address``: host:port of
  process 0, also read from $ORYX_COORDINATOR (``tcp://<address>``);
- ``oryx.batch.compute.distributed.num-processes`` / $ORYX_NUM_PROCESSES;
- ``oryx.batch.compute.distributed.process-id`` / $ORYX_PROCESS_ID;
- ``auto = true``: the environment names the run (``env://``: torchrun's
  MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK), as Cloud TPU detection
  does for the JAX package.

The backend is NCCL where every rank holds a GPU of its own, gloo where
ranks share one (NCCL refuses two ranks on one GPU) or run on the CPU.
Over gloo a CUDA tensor goes through a pinned host buffer for the
transfer only; the computation stays on the card. Every rendezvous and
collective has a time limit (``TIMEOUT_S``), so a hung rank fails its
peers instead of hanging them.

``maybe_enable_compile_cache`` points the kernels' build
(``ops/_build.py``) at ``oryx.compute.compile-cache-dir``: where the JAX
package persists XLA's compiled programs, the port keeps its compiled
kernel libraries, so a restarted process loads what an earlier one built.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch

from oryx_tpu_torch import device as device_mod

log = logging.getLogger(__name__)

# seconds any rendezvous or collective may take before it fails
TIMEOUT_S = 300.0

_initialized = False
_cache_dir: str | None = None
_backend: str | None = None
_placements: list | None = None  # every rank's Placement, in rank order


def maybe_enable_compile_cache(config) -> None:
    """Build and load the port's kernels in ``oryx.compute.compile-cache-dir``
    (no-op when null). Idempotent; affects only kernels this process has
    not loaded yet, as XLA's cache affects only later compiles."""
    global _cache_dir
    if _cache_dir is not None:
        return
    d = config.get("oryx.compute.compile-cache-dir", None)
    if not d:
        return
    from oryx_tpu_torch.ops import _build

    os.makedirs(d, exist_ok=True)
    _build.set_build_dir(d)
    _cache_dir = str(d)
    log.info("kernel compile cache at %s", d)


def is_initialized() -> bool:
    return _initialized


def rank() -> int:
    return torch.distributed.get_rank() if _initialized else 0


def world_size() -> int:
    return torch.distributed.get_world_size() if _initialized else 1


def backend() -> str | None:
    return _backend


def rank_placements() -> list:
    """Every rank's Placement (its device and rank), in rank order."""
    return list(_placements or [])


def _rank_device(rank_: int) -> torch.device:
    """The device this rank computes on: the CPU where the caller chose it
    or there is no CUDA, else a local card ($LOCAL_RANK, or the rank,
    modulo the cards)."""
    chosen = device_mod.chosen()
    if chosen is not None and chosen.type == "cpu":
        return chosen
    if not torch.cuda.is_available():
        return device_mod.default_device()  # raises
    local = int(os.environ.get("LOCAL_RANK", rank_))
    return torch.device("cuda", local % torch.cuda.device_count())


def _choose_backend(dev: torch.device, world: int) -> str:
    """NCCL when each of this host's ranks has a card of its own, else gloo."""
    if dev.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def maybe_initialize(config) -> bool:
    """Join a multi-process run when configured; returns True if this
    process is now (or already was) part of one."""
    global _initialized, _backend, _placements
    if _initialized:
        return True
    coord = (
        config.get("oryx.batch.compute.distributed.coordinator-address", None)
        or os.environ.get("ORYX_COORDINATOR")
    )
    nproc = (
        config.get("oryx.batch.compute.distributed.num-processes", None)
        or os.environ.get("ORYX_NUM_PROCESSES")
    )
    pid = config.get("oryx.batch.compute.distributed.process-id", None)
    if pid is None:
        pid = os.environ.get("ORYX_PROCESS_ID")
    auto = bool(config.get("oryx.batch.compute.distributed.auto", False))
    if coord is None and not auto:
        return False

    if coord is not None:
        missing = [
            name
            for name, val in (
                ("num-processes ($ORYX_NUM_PROCESSES)", nproc),
                ("process-id ($ORYX_PROCESS_ID)", pid),
            )
            if val is None
        ]
        if missing:
            raise ValueError(
                "oryx.batch.compute.distributed.coordinator-address is set but "
                + " and ".join(missing)
                + " is missing; all three are required for explicit multi-process init"
            )
        init = dict(init_method=f"tcp://{coord}", world_size=int(nproc), rank=int(pid))
        world, me = int(nproc), int(pid)
    else:  # torchrun's environment
        init = dict(init_method="env://")
        world, me = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])

    dev = _rank_device(me)
    _backend = _choose_backend(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        _backend, timeout=datetime.timedelta(seconds=TIMEOUT_S), **init
    )
    _initialized = True
    from oryx_tpu_torch.parallel.mesh import Placement

    devices = [None] * world
    torch.distributed.all_gather_object(devices, str(dev))
    _placements = [Placement(torch.device(d), r) for r, d in enumerate(devices)]
    log.info(
        "torch.distributed initialized: process %d/%d on %s, backend %s",
        me, world, dev, _backend,
    )
    return True


def shutdown() -> None:
    """Leave the run (tests and scripts that join more than once)."""
    global _initialized, _backend, _placements
    if _initialized:
        torch.distributed.destroy_process_group()
    _initialized, _backend, _placements = False, None, None


# -- transport for parallel.mesh's collectives --------------------------------------


def _staged(t: torch.Tensor) -> bool:
    return _backend == "gloo" and t.device.type == "cuda"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape on all ranks), in rank order, on
    ``t``'s device."""
    src = _to_host(t) if _staged(t) else t.contiguous()
    out = [torch.empty_like(src) for _ in range(world_size())]
    torch.distributed.all_gather(out, src)
    return [o.to(t.device) for o in out]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t``, on ``t``'s device."""
    buf = _to_host(t) if _staged(t) else t.clone()
    torch.distributed.all_reduce(buf, op=torch.distributed.ReduceOp.SUM)
    return buf.to(t.device)


def shift_from_next(t: torch.Tensor) -> torch.Tensor:
    """Send ``t`` to the previous rank and return what the next rank sent
    (the ring step between the last local shard of one rank and the first
    of the next)."""
    world, me = world_size(), rank()
    src = _to_host(t) if _staged(t) else t.contiguous()
    recv = torch.empty_like(src)
    ops = [
        torch.distributed.P2POp(torch.distributed.isend, src, (me - 1) % world),
        torch.distributed.P2POp(torch.distributed.irecv, recv, (me + 1) % world),
    ]
    for req in torch.distributed.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device)
