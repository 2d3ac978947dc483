"""Fused Lloyd sweep for k-means (counterpart of
``oryx_tpu/ops/pallas_kmeans.py``).

One Lloyd iteration assigns every point to its nearest center and
reduces the points into per-center sums, counts and the cost. The sweep
runs in one hand-written CUDA kernel (``csrc/kmeans.cu``), which
replaces ``pallas_kmeans._sweep_kernel`` (B3): ``sweep`` launches it
once per call (launch key ``kmeans_sweep.tc``: distances on the tensor
cores, per-CTA partials and their reduction in the same launch).

``sweep_plain`` is the plain PyTorch version of the same function. The
wrapper runs it only for tensors on the CPU (the tests); for a CUDA
tensor it launches the kernel or raises.

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
LAUNCHES = {"kmeans_sweep.tc": 0}


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


# -- the kernel and its plain version ----------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib = None
_PLAN_KEYS = ("N", "center_tiles", "resident", "row_features", "point_slots", "copies", "smem",
              "ctas", "tiles_per_cta")


def _kernels():
    global _lib
    if _lib is None:
        from oryx_tpu_torch.ops import _build

        lib = _build.load("kmeans")
        lib.kmeans_sweep.argtypes = [_P, _L, _I, _P, _I, _I, _L, _P, _L, _P, _P, _P, _P]
        lib.kmeans_sweep.restype = _I
        lib.kmeans_sweep_plan.argtypes = [_I, _I, _L, ctypes.POINTER(_I)]
        lib.kmeans_sweep_plan.restype = _L
        _lib = lib
    return _lib


def sweep_plan(kp: int, d: int, n: int, device) -> tuple[int, dict]:
    """(scratch bytes, plan) of a sweep over n points against kp centers of
    d features on a card: the center tile N and tiles, whether the center
    stages stay resident, the features of a staged point row (d, or a chunk
    of d for wide rows), the point slots per warpgroup, the f64 accumulator
    copies per warpgroup in shared memory (0: the CTA's slab in global
    memory), the shared-memory bytes, the CTAs and the 64-point tiles each
    walks (csrc/kmeans.cu; the C side keeps the card's occupancy and the
    kernel's attributes)."""
    info = (_I * len(_PLAN_KEYS))()
    with torch.cuda.device(device):
        nbytes = _kernels().kmeans_sweep_plan(kp, d, n, info)
    if nbytes < 0:
        raise RuntimeError(f"the sweep kernel cannot run {kp} centers x {d} features on {device}")
    return int(nbytes), dict(zip(_PLAN_KEYS, list(info)))


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


def sweep_plain(points, centers, n_items: int, k_real: int):
    """Plain version of the sweep: (sums [kp, d], counts [kp], cost [1]) f32
    of the first ``n_items`` points against the first ``k_real`` centers,
    from matmul distances, argmin and f64 ``index_add_``, rounded to f32
    once. A point with a NaN distance adds NaN to the cost and goes to no
    center, as in the TPU kernel (its equality argmin against a NaN minimum
    matches nothing)."""
    kp, d = centers.shape
    n = min(int(n_items), points.shape[0])
    a, mind2 = assign_plain(points[:n], centers, k_real)
    keep = ~torch.isnan(mind2)
    sums = torch.zeros((kp, d), dtype=torch.float64, device=points.device)
    sums.index_add_(0, a[keep], points[:n][keep].double())
    counts = torch.zeros(kp, dtype=torch.float64, device=points.device)
    counts.index_add_(0, a[keep], torch.ones_like(a[keep], dtype=torch.float64))
    cost = torch.clamp_min(mind2, 0.0).double().sum().reshape(1)
    return sums.float(), counts.float(), cost.float()


def _check_sweep_args(points, centers, n_items, k_real):
    if points.device.type != "cuda" or centers.device != points.device:
        raise ValueError(f"sweep takes CUDA tensors, not {points.device}/{centers.device}")
    if points.dtype != torch.float32 or centers.dtype != torch.float32:
        raise ValueError("sweep takes float32 points and centers")
    if points.dim() != 2 or centers.dim() != 2 or points.shape[1] != centers.shape[1]:
        raise ValueError(
            f"points {tuple(points.shape)} do not match centers {tuple(centers.shape)}"
        )
    if not (points.is_contiguous() and centers.is_contiguous()):
        raise ValueError("sweep takes contiguous tensors")
    if not 1 <= k_real <= centers.shape[0]:
        raise ValueError(f"k_real = {k_real} is outside [1, {centers.shape[0]}]")
    if n_items < 0:
        raise ValueError(f"n_items = {n_items} is negative")


def sweep(points, centers, n_items: int, k_real: int):
    """One fused assignment + reduction pass (``pallas_kmeans._sweep``):
    (sums [kp, d], counts [kp], cost [1]), all f32 on the points' device,
    of the first ``n_items`` points against the first ``k_real`` centers.
    CPU tensors take the plain version."""
    if points.device.type == "cpu":
        return sweep_plain(points, centers, n_items, k_real)
    _check_sweep_args(points, centers, n_items, k_real)
    n_rows, d = points.shape
    kp = centers.shape[0]
    n = min(int(n_items), n_rows)
    dev = points.device
    nbytes, _ = sweep_plan(kp, d, n, dev)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    sums = torch.empty((kp, d), dtype=torch.float32, device=dev)
    counts = torch.empty(kp, dtype=torch.float32, device=dev)
    cost = torch.empty(1, dtype=torch.float32, device=dev)
    rc = _kernels().kmeans_sweep(
        points.data_ptr(), n_rows, d, centers.data_ptr(), kp, int(k_real), n,
        scratch.data_ptr(), nbytes, sums.data_ptr(), counts.data_ptr(), cost.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"kmeans_sweep kernel launch failed: CUDA error {rc}")
    _count("kmeans_sweep.tc")
    return sums, counts, cost


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
