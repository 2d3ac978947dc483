"""Fused Lloyd sweep for k-means (counterpart of
``oryx_tpu/ops/pallas_kmeans.py``).

One Lloyd iteration assigns every point to its nearest center and
reduces the points into per-center sums, counts and the cost. The sweep
runs in hand-written CUDA kernels (``csrc/kmeans.cu``), which replace
``pallas_kmeans._sweep_kernel`` (B3):

- ``kmeans_sweep``: each CTA owns a contiguous range of points, reads
  each point once, and writes its partial sums, counts and cost;
- ``kmeans_reduce``: the partials summed over CTAs in CTA order.

Each kernel has a plain PyTorch version of the same function here
(``*_plain``). A wrapper runs the plain version only for tensors on the
CPU (the tests); for a CUDA tensor it launches the kernel or raises.

``lloyd`` and ``minibatch_lloyd`` run whole schedules with the centers
on the device between sweeps: nothing in their iteration loops waits
for the host. They return ``(centers [k, d], counts [k], cost)`` as
numpy, with counts and cost measured against the final centers, as
``lloyd_pallas`` and ``minibatch_lloyd_pallas`` do.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from oryx_tpu_torch.device import resolve

# point rows are padded to a multiple of this (pallas_kmeans.BLOCK_N), so
# padded shapes agree with the JAX package
BLOCK_N = 1024

# rows per tile of the sweep kernel; a CTA's range is whole tiles
_TILE_ROWS = 64
# threads per CTA in csrc/kmeans.cu
_KERNEL_THREADS = 256
# dynamic shared memory a sweep CTA may take for its accumulator copies;
# beyond it the CTA accumulates in its slab of the partials output
_SMEM_BUDGET = 100 * 1024


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_k(k: int) -> int:
    """Center rows as the JAX package pads them (a multiple of 8)."""
    return max(8, _ceil_to(k, 8))


def pad_to_block(points: np.ndarray) -> np.ndarray:
    """Points padded with zero rows to a BLOCK_N multiple."""
    n, d = points.shape
    n_pad = max(BLOCK_N, _ceil_to(n, BLOCK_N))
    if n_pad == n:
        return points
    return np.concatenate([points, np.zeros((n_pad - n, d), np.float32)])


# -- launch counters -------------------------------------------------------------

_launch_lock = threading.Lock()
LAUNCHES = {"kmeans_sweep": 0, "kmeans_reduce": 0}


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


# -- the kernels and their plain versions -----------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from oryx_tpu_torch.ops import _build

        lib = _build.load("kmeans")
        lib.kmeans_sweep.argtypes = [_P, _L, _I, _P, _I, _I, _L, _I, _L, _I, _P, _P, _P, _P]
        lib.kmeans_sweep.restype = _I
        lib.kmeans_reduce.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P]
        lib.kmeans_reduce.restype = _I
        lib.kmeans_sweep_smem_bytes.argtypes = [_I, _I, _I]
        lib.kmeans_sweep_smem_bytes.restype = _L
        _lib = lib
    return _lib


def sweep_grid(n_pad: int, device) -> tuple[int, int]:
    """(num_ctas, rows_per_cta) of kmeans_sweep: up to four CTAs per SM,
    each walking a contiguous run of whole 64-row tiles. The CPU takes one
    range."""
    tiles = max(1, math.ceil(n_pad / _TILE_ROWS))
    if torch.device(device).type != "cuda":
        return 1, tiles * _TILE_ROWS
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = math.ceil(tiles / min(tiles, 4 * sms))
    return math.ceil(tiles / per), per * _TILE_ROWS


def _sweep_groups(kp: int, d: int) -> int:
    """Accumulator copies a sweep CTA keeps in shared memory: as many as
    its threads cover (256 // min(d, 256)) within the budget, or 0 when
    even one does not fit (then it accumulates in its partials slab)."""
    lib = _kernels()
    groups = _KERNEL_THREADS // min(d, _KERNEL_THREADS)
    while groups > 0 and lib.kmeans_sweep_smem_bytes(kp, d, groups) > _SMEM_BUDGET:
        groups -= 1
    return groups


def assign_plain(points: torch.Tensor, centers: torch.Tensor, k_real: int):
    """(argmin [n] int64, min d2 [n] f32): d2 = |p|^2 - 2 p.c + |c|^2 in
    float32, centers >= k_real at +inf, ties to the lowest center."""
    d2 = (
        torch.sum(points * points, dim=1, keepdim=True)
        - 2.0 * (points @ centers.T)
        + torch.sum(centers * centers, dim=1)[None, :]
    )
    cols = torch.arange(centers.shape[0], device=points.device)
    d2 = torch.where(cols[None, :] < k_real, d2, math.inf)
    return torch.argmin(d2, dim=1), torch.amin(d2, dim=1)


def kmeans_sweep_plain(points, centers, n_items, k_real, num_ctas, rows_per_cta):
    """Plain version of kmeans_sweep: the same partials, [num_ctas, kp, d]
    f64 sums, [num_ctas, kp] int32 counts and [num_ctas] f64 cost, from
    matmul distances, argmin and index_add_ into (CTA, center) rows. A
    point with a NaN distance adds NaN to the cost and goes to no center,
    as in the TPU kernel (its equality argmin against a NaN minimum
    matches nothing)."""
    n_pad, d = points.shape
    kp = centers.shape[0]
    n = min(int(n_items), n_pad)
    a, mind2 = assign_plain(points[:n], centers, k_real)
    row = torch.arange(n, device=points.device)
    slot = (row // rows_per_cta) * kp + a
    keep = ~torch.isnan(mind2)
    sums = torch.zeros((num_ctas * kp, d), dtype=torch.float64, device=points.device)
    sums.index_add_(0, slot[keep], points[:n][keep].double())
    counts = torch.zeros(num_ctas * kp, dtype=torch.int32, device=points.device)
    counts.index_add_(0, slot[keep], torch.ones_like(slot[keep], dtype=torch.int32))
    cost = torch.zeros(num_ctas, dtype=torch.float64, device=points.device)
    cost.index_add_(0, row // rows_per_cta, torch.clamp_min(mind2, 0.0).double())
    return sums.view(num_ctas, kp, d), counts.view(num_ctas, kp), cost


def kmeans_reduce_plain(part_sums, part_counts, part_cost):
    """Plain version of kmeans_reduce: (sums [kp, d] f32, counts [kp] f32,
    cost [1] f32), the partials summed over the CTA axis."""
    return (
        part_sums.sum(dim=0).float(),
        part_counts.sum(dim=0).float(),
        part_cost.sum().reshape(1).float(),
    )


def _check_sweep_args(points, centers, n_items, k_real):
    if points.device.type != "cuda" or centers.device != points.device:
        raise ValueError(f"kmeans_sweep takes CUDA tensors, not {points.device}/{centers.device}")
    if points.dtype != torch.float32 or centers.dtype != torch.float32:
        raise ValueError("kmeans_sweep takes float32 points and centers")
    if points.dim() != 2 or centers.dim() != 2 or points.shape[1] != centers.shape[1]:
        raise ValueError(
            f"points {tuple(points.shape)} do not match centers {tuple(centers.shape)}"
        )
    if not (points.is_contiguous() and centers.is_contiguous()):
        raise ValueError("kmeans_sweep takes contiguous tensors")
    if not 1 <= k_real <= centers.shape[0]:
        raise ValueError(f"k_real = {k_real} is outside [1, {centers.shape[0]}]")
    if n_items < 0:
        raise ValueError(f"n_items = {n_items} is negative")


def kmeans_sweep(points, centers, n_items: int, k_real: int):
    """B3, first pass: per-CTA partials (sums [C, kp, d] f64, counts
    [C, kp] int32, cost [C] f64) of the points' first ``n_items`` rows
    against the centers' first ``k_real`` rows. CPU tensors take the plain
    version."""
    num_ctas, rows_per_cta = sweep_grid(points.shape[0], points.device)
    if points.device.type == "cpu":
        return kmeans_sweep_plain(points, centers, n_items, k_real, num_ctas, rows_per_cta)
    _check_sweep_args(points, centers, n_items, k_real)
    n_pad, d = points.shape
    kp = centers.shape[0]
    groups = _sweep_groups(kp, d)
    dev = points.device
    part_sums = torch.empty((num_ctas, kp, d), dtype=torch.float64, device=dev)
    part_counts = torch.empty((num_ctas, kp), dtype=torch.int32, device=dev)
    part_cost = torch.empty(num_ctas, dtype=torch.float64, device=dev)
    rc = _kernels().kmeans_sweep(
        points.data_ptr(), n_pad, d, centers.data_ptr(), kp, int(k_real), int(n_items),
        num_ctas, rows_per_cta, groups, part_sums.data_ptr(), part_counts.data_ptr(),
        part_cost.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"kmeans_sweep kernel launch failed: CUDA error {rc}")
    _count("kmeans_sweep")
    return part_sums, part_counts, part_cost


def kmeans_reduce(part_sums, part_counts, part_cost):
    """B3, second pass: (sums [kp, d] f32, counts [kp] f32, cost [1] f32)
    from kmeans_sweep's partials. CPU tensors take the plain version."""
    if part_sums.device.type == "cpu":
        return kmeans_reduce_plain(part_sums, part_counts, part_cost)
    dev = part_sums.device
    if part_counts.device != dev or part_cost.device != dev or dev.type != "cuda":
        raise ValueError("kmeans_reduce takes CUDA tensors on one device")
    if (part_sums.dtype, part_counts.dtype, part_cost.dtype) != (
        torch.float64, torch.int32, torch.float64,
    ):
        raise ValueError("kmeans_reduce takes f64 sums, int32 counts and f64 cost")
    if part_sums.dim() != 3 or part_counts.shape != part_sums.shape[:2] or (
        part_cost.shape != part_sums.shape[:1]
    ):
        raise ValueError(
            f"partials {tuple(part_sums.shape)}, {tuple(part_counts.shape)}, "
            f"{tuple(part_cost.shape)} do not line up"
        )
    if not all(t.is_contiguous() for t in (part_sums, part_counts, part_cost)):
        raise ValueError("kmeans_reduce takes contiguous tensors")
    num_ctas, kp, d = part_sums.shape
    sums = torch.empty((kp, d), dtype=torch.float32, device=dev)
    counts = torch.empty(kp, dtype=torch.float32, device=dev)
    cost = torch.empty(1, dtype=torch.float32, device=dev)
    rc = _kernels().kmeans_reduce(
        part_sums.data_ptr(), part_counts.data_ptr(), part_cost.data_ptr(), num_ctas, kp, d,
        sums.data_ptr(), counts.data_ptr(), cost.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"kmeans_reduce kernel launch failed: CUDA error {rc}")
    _count("kmeans_reduce")
    return sums, counts, cost


def sweep(points, centers, n_items: int, k_real: int):
    """One fused assignment + reduction pass (``pallas_kmeans._sweep``):
    (sums [kp, d], counts [kp], cost [1]), all f32 on the points' device."""
    return kmeans_reduce(*kmeans_sweep(points, centers, n_items, k_real))


# -- schedules ---------------------------------------------------------------------


def _device_points(points, n_items, device):
    """(padded f32 points on the device, n_items)."""
    if isinstance(points, torch.Tensor):
        if n_items is None:
            raise ValueError("n_items is required for pre-uploaded points")
        if points.shape[0] % BLOCK_N:
            raise ValueError("pre-uploaded points must be padded to BLOCK_N")
        if points.dtype != torch.float32:
            raise ValueError("pre-uploaded points must be float32")
        return points.contiguous(), int(n_items)
    pts = np.asarray(points, dtype=np.float32)
    return torch.from_numpy(pad_to_block(pts)).to(resolve(device)), pts.shape[0]


def _padded_centers(centers0, kp: int, device) -> torch.Tensor:
    if not isinstance(centers0, torch.Tensor):
        centers0 = torch.from_numpy(np.asarray(centers0, dtype=np.float32))
    c = centers0.to(device=device, dtype=torch.float32)
    out = torch.zeros((kp, c.shape[1]), dtype=torch.float32, device=device)
    out[: c.shape[0]] = c
    return out


def _lloyd_update(ctr, sums, counts):
    return torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts, 1.0)[:, None], ctr)


def _results(ctr, counts, cost, k):
    return ctr[:k].cpu().numpy(), counts[:k].cpu().numpy(), float(cost.cpu()[0])


def lloyd(points, centers0, iterations: int, n_items: int | None = None, device=None):
    """Lloyd iterations through the sweep kernels; returns (centers [k, d],
    counts [k], cost) with counts and cost measured against the final
    centers (``lloyd_pallas``). ``points`` is numpy, or a card tensor
    already padded to a BLOCK_N multiple with ``n_items`` real rows (so
    callers can start the upload before their init)."""
    pts, n = _device_points(points, n_items, device)
    k = centers0.shape[0]
    ctr = _padded_centers(centers0, padded_k(k), pts.device)
    for _ in range(iterations):
        sums, counts, _ = sweep(pts, ctr, n, k)
        ctr = _lloyd_update(ctr, sums, counts)
    _, counts, cost = sweep(pts, ctr, n, k)
    return _results(ctr, counts, cost, k)


def minibatch_step(points, centers, v, idx, batch: int, k_real: int | None = None):
    """One mini-batch step (Sculley 2010) as ``_minibatch_fused`` takes it:
    sweep the gathered rows ``points[idx]`` (the first ``batch`` count),
    then move each center toward its batch mean with rate 1 / v_c, v_c the
    running assigned count. Returns the new (centers, v)."""
    xb = points[idx].contiguous()
    k = centers.shape[0] if k_real is None else k_real
    sums, counts, _ = sweep(xb, centers, batch, k)
    v = v + counts
    centers = centers + (sums - counts[:, None] * centers) / torch.clamp_min(v, 1.0)[:, None]
    return centers, v


def minibatch_lloyd(
    points,
    centers0,
    iterations: int,
    batch: int,
    generator: torch.Generator,
    n_items: int | None = None,
    device=None,
):
    """Mini-batch counterpart of ``lloyd`` (``minibatch_lloyd_pallas``):
    each iteration sweeps ``batch`` points drawn with ``generator`` (on the
    points' device), then one full sweep gives counts and cost."""
    pts, n = _device_points(points, n_items, device)
    k = centers0.shape[0]
    kp = padded_k(k)
    batch = min(int(batch), n)
    ctr = _padded_centers(centers0, kp, pts.device)
    v = torch.zeros(kp, dtype=torch.float32, device=pts.device)
    for _ in range(iterations):
        idx = torch.randint(0, n, (batch,), generator=generator, device=pts.device)
        ctr, v = minibatch_step(pts, ctr, v, idx, batch, k_real=k)
    _, counts, cost = sweep(pts, ctr, n, k)
    return _results(ctr, counts, cost, k)
