"""K-means on the card: Lloyd iterations and internal evaluation metrics
(counterpart of ``oryx_tpu/ops/kmeans.py``).

``train_kmeans`` runs on one card: the points upload starts, the
initial centers are picked (warm start, "random", or k-means|| on the
device or the host), then every Lloyd iteration, every mini-batch step
and the final full pass go through the fused sweep kernels of
``ops/pallas_kmeans.py`` (B3).

Over a device mesh (``parallel/mesh.py``) the points are row-sharded,
padded with rows no sweep counts, and the centers replicated: each Lloyd
iteration runs one B3 sweep per shard, whose per-center sums, counts and
cost one ``all_reduce_sum`` turns into the global ones, and every shard
moves its copy of the centers alike. As in the JAX package, a mesh runs
full-batch Lloyd (no mini-batch) and picks its init on the host unless
``init_backend="device"``.

The host k-means|| init, ``assign_clusters`` and the four internal
clustering metrics (SumSquaredError / DaviesBouldinIndex / DunnIndex /
SilhouetteCoefficient, SURVEY.md §2.8) are numpy, copied as they are.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from oryx_tpu_torch.common import rng as rng_mod
from oryx_tpu_torch.device import resolve
from oryx_tpu_torch.ops import pallas_kmeans

# wall seconds of the most recent train_kmeans call, split by phase
# ({"init": s, "iterate": s}). Overwritten per call, never merged.
last_phase_seconds: dict[str, float] = {}


def centers_from_jax(centers: np.ndarray, counts: np.ndarray, device=None):
    """The JAX package's ``train_kmeans`` outputs (numpy centers [k, d] and
    counts [k]) as the port's float32 tensors on ``device``."""
    dev = resolve(device)
    return (
        torch.from_numpy(np.array(centers, dtype=np.float32)).to(dev),
        torch.from_numpy(np.array(counts, dtype=np.float32)).to(dev),
    )


def _upload(points: np.ndarray, device: torch.device) -> torch.Tensor:
    """Padded points on the device; to the card the copy is asynchronous
    (pinned source), so the init overlaps it."""
    t = torch.from_numpy(pallas_kmeans.pad_to_block(points))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _sq_to(points: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances [n] from each point to one center c [1, d]."""
    diff = points - c
    return torch.sum(diff * diff, dim=1)


def _gumbel(n: int, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=device)
    return -torch.log(-torch.log(u))


# bytes of one [rows, candidates] distance block of the device init: past
# it the rows go in blocks (k = 4,472 at 200,000 points would otherwise
# take 14 GB a round)
_INIT_BLOCK_BYTES = 1 << 30


def _nearest_new(points, pn, newpts, newv):
    """(min squared distance clamped at 0, argmin) of every point over the
    valid new candidates, in row blocks of at most _INIT_BLOCK_BYTES."""
    c2 = torch.sum(newpts * newpts, dim=1)[None, :]
    rows = max(1, _INIT_BLOCK_BYTES // (4 * max(1, newpts.shape[0])))
    mins, args = [], []
    for beg in range(0, points.shape[0], rows):
        dn = pn[beg : beg + rows] - 2.0 * (points[beg : beg + rows] @ newpts.T) + c2
        dn = torch.where(newv[None, :], dn, torch.inf)
        args.append(torch.argmin(dn, dim=1))
        mins.append(torch.clamp_min(torch.amin(dn, dim=1), 0.0))
    if len(mins) == 1:
        return mins[0], args[0]
    return torch.cat(mins), torch.cat(args)


def _kmeans_parallel_init_device(
    points: torch.Tensor, n_items: int, k: int, rounds: int, generator: torch.Generator
) -> torch.Tensor:
    """k-means|| (Bahmani et al.) on the device, without host round trips
    (``_kmeans_parallel_init_device`` of the JAX package, same fixed-shape
    formulation): each round Bernoulli-samples points with probability
    min(2k d2 / total, 1) and keeps up to 4k of them (the smallest drawn
    uniforms; ties there fall only among unpicked rows, which are masked);
    candidates are weighted by the points they attract, then a weighted
    k-means++ picks k of them by Gumbel-max draws. Same distribution
    family as the host init, not the same random stream."""
    n, d = points.shape
    dev = points.device
    cap_round = min(4 * k, n)
    cap_t = 1 + rounds * cap_round
    mask = torch.arange(n, device=dev) < n_items
    maskf = mask.float()
    logmask = torch.where(mask, 0.0, -torch.inf)
    pn = torch.sum(points * points, dim=1, keepdim=True)

    i0 = torch.argmax(_gumbel(n, generator, dev) + logmask).view(1)
    first = points.index_select(0, i0)
    cand = torch.zeros((cap_t, d), dtype=torch.float32, device=dev)
    cand[0:1] = first
    cvalid = torch.zeros(cap_t, dtype=torch.bool, device=dev)
    cvalid[0] = True
    d2 = torch.where(mask, _sq_to(points, first), 0.0)
    # nearest-candidate id per point, tracked across rounds
    amin = torch.zeros(n, dtype=torch.int64, device=dev)

    for r in range(rounds):
        total = torch.clamp_min(torch.sum(d2), 1e-30)
        probs = torch.clamp_max((2.0 * k) * d2 / total, 1.0)
        u = torch.rand(n, generator=generator, device=dev)
        picked = (u < probs) & mask
        _, idx = torch.topk(-torch.where(picked, u, torch.inf), cap_round)
        newv = picked[idx]
        newpts = torch.where(newv[:, None], points[idx], 0.0)
        base = 1 + r * cap_round
        cand[base : base + cap_round] = newpts
        cvalid[base : base + cap_round] = newv
        dn_min, dn_arg = _nearest_new(points, pn, newpts, newv)
        closer = dn_min < d2
        amin = torch.where(closer, base + dn_arg, amin)
        d2 = torch.where(mask & closer, dn_min, d2)

    # weight candidates by how many points they attract
    w = torch.zeros(cap_t, dtype=torch.float32, device=dev).index_add_(0, amin, maskf)

    # weighted k-means++ over the candidates (Gumbel-max: argmax(log score
    # + Gumbel) samples proportionally to score; a chosen candidate has
    # d2 = 0, so score 0, and is never picked again)
    lw = torch.log(torch.where(cvalid, w, 0.0))
    pick = torch.argmax(lw + _gumbel(cap_t, generator, dev)).view(1)
    centers = torch.zeros((k, d), dtype=torch.float32, device=dev)
    c = cand.index_select(0, pick)
    centers[0:1] = c
    mind2 = torch.clamp_min(_sq_to(cand, c), 0.0)
    for i in range(1, k):
        score = torch.where(cvalid, mind2 * w, 0.0)
        pick = torch.argmax(torch.log(score) + _gumbel(cap_t, generator, dev)).view(1)
        c = cand.index_select(0, pick)
        centers[i : i + 1] = c
        mind2 = torch.minimum(mind2, torch.clamp_min(_sq_to(cand, c), 0.0))
    return centers


def train_kmeans(
    points: np.ndarray,
    k: int,
    iterations: int = 30,
    init: str = "k-means||",
    mesh: Optional[object] = None,
    seed: int | None = None,
    initial_centers: np.ndarray | None = None,
    minibatch_size: int | None = None,
    init_backend: str = "auto",
    device=None,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Returns (centers [k, d], counts [k], cost). ``initial_centers``
    [k, d] seeds Lloyd directly (warm start from a previous generation's
    centers); a shape mismatch falls back to the configured ``init`` so a
    changed k or feature dim cold-starts.

    ``minibatch_size`` switches the iterations to mini-batch k-means
    (oryx.ml.kmeans.minibatch-size): each iteration updates centers from a
    random sample of that many points, then one full pass produces the
    reported counts and cost. n at or below the batch size runs full-batch
    Lloyd.

    ``init_backend``: "device" runs k-means|| init on the card, "host"
    keeps the NumPy passes, "auto" = device except under a mesh. With
    ``mesh`` the points shard over its shards (one B3 sweep per shard per
    iteration, one ``all_reduce_sum``); ``device`` is then unused."""
    points = np.asarray(points, dtype=np.float32)
    n, d = points.shape
    if n == 0:
        raise ValueError("no points")
    k = min(k, n)
    gen = np.random.default_rng(rng_mod.next_seed() if seed is None else seed)
    minibatch = minibatch_size is not None and 0 < minibatch_size < n and mesh is None
    device_init = init_backend == "device" or (init_backend == "auto" and mesh is None)
    dev = resolve(device) if mesh is None else mesh.shards[mesh.local[0]].device

    t_init = time.perf_counter()
    # the upload is enqueued first, so the init (device or host) overlaps it
    pts_dev = _upload(points, dev) if mesh is None or device_init else None

    def pick_init():
        if initial_centers is not None:
            warm = np.asarray(initial_centers, dtype=np.float32)
            if warm.shape == (k, d):
                return warm.copy()
        if init == "random":
            return points[gen.choice(n, size=k, replace=False)]
        if device_init:
            g = torch.Generator(device=dev).manual_seed(int(gen.integers(2**31)))
            return _kmeans_parallel_init_device(pts_dev, n, k, 2, g)
        return _kmeans_parallel_init(points, k, gen)

    centers0 = pick_init()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # the init phase ends with its device work
    t_iter = time.perf_counter()
    if mesh is not None:
        out = _lloyd_mesh(points, centers0, iterations, mesh)
    elif minibatch:
        g = torch.Generator(device=dev).manual_seed(int(gen.integers(2**31)))
        out = pallas_kmeans.minibatch_lloyd(
            pts_dev, centers0, iterations, int(minibatch_size), g, n_items=n
        )
    else:
        out = pallas_kmeans.lloyd(pts_dev, centers0, iterations, n_items=n)
    last_phase_seconds.clear()
    last_phase_seconds.update(init=t_iter - t_init, iterate=time.perf_counter() - t_iter)
    return out


def _lloyd_mesh(points: np.ndarray, centers0, iterations: int, mesh):
    """Lloyd over ``mesh``: points row-sharded (padded to a shard multiple;
    a shard's sweep counts only its real rows), centers replicated. One
    B3 sweep per shard per iteration, summed over the shards by one
    ``all_reduce_sum``; counts and cost against the final centers."""
    from oryx_tpu_torch.parallel.mesh import all_reduce_sum, pad_to_multiple, put, shard_rows

    n, d = points.shape
    s = mesh.size
    per = pad_to_multiple(n, s) // s
    padded = np.zeros((per * s, d), np.float32)
    padded[:n] = points
    pts = put(padded, shard_rows(mesh))
    real = [max(0, min(per, n - i * per)) for i in mesh.local]
    k = centers0.shape[0]
    kp = pallas_kmeans.padded_k(k)
    ctr = [pallas_kmeans._padded_centers(centers0, kp, p.device) for p in pts]

    def sweep_one(p, c, r):
        if r == 0:  # a shard of padding rows only adds nothing
            return torch.zeros(kp * d + kp + 1, dtype=torch.float32, device=p.device)
        sm, cn, co = pallas_kmeans.sweep(p, c, r, k)
        return torch.cat([sm.reshape(-1), cn, co])

    def sweep_all(ctr):
        packed = [sweep_one(p, c, r) for p, c, r in zip(pts, ctr, real)]
        tot = all_reduce_sum(mesh, packed)
        return [(t[: kp * d].view(kp, d), t[kp * d : kp * d + kp], t[-1:]) for t in tot]

    for _ in range(iterations):
        ctr = [pallas_kmeans._lloyd_update(c, sm, cn) for c, (sm, cn, _) in zip(ctr, sweep_all(ctr))]
    _, counts, cost = sweep_all(ctr)[0]
    return pallas_kmeans._results(ctr[0], counts, cost, k)


def _kmeans_parallel_init(points: np.ndarray, k: int, gen: np.random.Generator, rounds: int = 2):
    """k-means|| oversampling init then weighted k-means++ over candidates."""
    n = points.shape[0]
    centers = [points[gen.integers(n)]]
    oversample = 2 * k
    for _ in range(rounds):
        c = np.stack(centers)
        d2 = _min_sq_dists(points, c)
        total = d2.sum()
        if total <= 0:
            break
        probs = np.minimum(oversample * d2 / total, 1.0)
        picked = np.nonzero(gen.random(n) < probs)[0]
        centers.extend(points[i] for i in picked)
    cand = np.stack(centers)
    if len(cand) <= k:
        # oversampling came up short: top up with random points (keeping
        # the sampled candidates first; duplicates are harmless — Lloyd
        # leaves an empty cluster's center in place)
        extra = points[gen.choice(n, size=k, replace=n < k)]
        return np.concatenate([cand, extra])[:k]
    # weight candidates by how many points they attract, then k-means++
    assign = np.argmin(_sq_dist_matrix(points, cand), axis=1)
    weights = np.bincount(assign, minlength=len(cand)).astype(np.float64)
    return _weighted_kmeans_pp(cand, weights, k, gen)


def _weighted_kmeans_pp(cand: np.ndarray, weights: np.ndarray, k: int, gen) -> np.ndarray:
    chosen = [int(gen.choice(len(cand), p=weights / weights.sum()))]
    for _ in range(k - 1):
        d2 = _min_sq_dists(cand, cand[chosen])
        score = d2 * weights
        total = score.sum()
        if total <= 0:
            remaining = [i for i in range(len(cand)) if i not in chosen]
            chosen.append(int(gen.choice(remaining)))
            continue
        chosen.append(int(gen.choice(len(cand), p=score / total)))
    return cand[chosen]


def _sq_dist_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (
        np.sum(a * a, axis=1, keepdims=True)
        - 2.0 * a @ b.T
        + np.sum(b * b, axis=1)[None, :]
    )


def _min_sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(_sq_dist_matrix(a, b).min(axis=1), 0.0)


# ---------------------------------------------------------------------------
# Assignment + internal evaluation metrics
# ---------------------------------------------------------------------------


def assign_clusters(points: np.ndarray, centers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(cluster ids, distances) for each point (Euclidean)."""
    d2 = _sq_dist_matrix(np.asarray(points, np.float64), np.asarray(centers, np.float64))
    a = np.argmin(d2, axis=1)
    return a, np.sqrt(np.maximum(d2[np.arange(len(a)), a], 0.0))


def sum_squared_error(points: np.ndarray, centers: np.ndarray) -> float:
    """SSE: lower is better (SumSquaredError.java)."""
    _, dist = assign_clusters(points, centers)
    return float(np.sum(dist**2))


def _cluster_mean_dists(points: np.ndarray, centers: np.ndarray) -> np.ndarray:
    a, dist = assign_clusters(points, centers)
    k = centers.shape[0]
    sums = np.bincount(a, weights=dist, minlength=k)
    counts = np.maximum(np.bincount(a, minlength=k), 1)
    return sums / counts


def davies_bouldin_index(points: np.ndarray, centers: np.ndarray) -> float:
    """Mean over clusters i of max_j != i (S_i + S_j) / d(c_i, c_j);
    lower is better (DaviesBouldinIndex.java)."""
    s = _cluster_mean_dists(points, centers)
    k = centers.shape[0]
    if k < 2:
        return 0.0
    cd = np.sqrt(np.maximum(_sq_dist_matrix(centers.astype(np.float64), centers.astype(np.float64)), 0))
    ratios = (s[:, None] + s[None, :]) / np.where(cd > 0, cd, np.inf)
    np.fill_diagonal(ratios, 0.0)
    return float(np.mean(ratios.max(axis=1)))


def dunn_index(points: np.ndarray, centers: np.ndarray) -> float:
    """Min centroid separation / max mean intra-cluster distance; higher
    is better (DunnIndex.java)."""
    s = _cluster_mean_dists(points, centers)
    k = centers.shape[0]
    if k < 2:
        return 0.0
    cd = np.sqrt(np.maximum(_sq_dist_matrix(centers.astype(np.float64), centers.astype(np.float64)), 0))
    cd[np.eye(k, dtype=bool)] = np.inf
    max_intra = s.max()
    if max_intra <= 0:
        return 0.0
    return float(cd.min() / max_intra)


def silhouette_coefficient(
    points: np.ndarray, centers: np.ndarray, max_sample: int = 100_000, gen=None
) -> float:
    """Mean silhouette over a sample; singleton clusters contribute 0
    (SilhouetteCoefficient.java, MAX_SAMPLE_SIZE=100000)."""
    points = np.asarray(points, dtype=np.float64)
    if gen is None:
        gen = rng_mod.get_random()
    if len(points) > max_sample:
        points = points[gen.choice(len(points), size=max_sample, replace=False)]
    a, _ = assign_clusters(points, centers)
    k = centers.shape[0]
    total = 0.0
    count = len(points)
    if count == 0:
        return 0.0
    # Mean distance from each point to each cluster's points, computed in
    # row blocks so peak memory is O(block x largest-cluster) rather than
    # O(|cluster| x sample).
    by_cluster = [points[a == c] for c in range(k)]
    sizes = np.asarray([len(p) for p in by_cluster])
    block = 256
    for c in range(k):
        pts = by_cluster[c]
        if len(pts) <= 1:
            continue  # contributes 0
        for start in range(0, len(pts), block):
            blk = pts[start : start + block]
            intra = np.zeros(len(blk))
            inter = np.full(len(blk), np.inf)
            for o in range(k):
                if not sizes[o]:
                    continue
                d = np.sqrt(np.maximum(_sq_dist_matrix(blk, by_cluster[o]), 0))
                if o == c:
                    intra = d.sum(axis=1) / (sizes[c] - 1)  # exclude self (d=0)
                else:
                    inter = np.minimum(inter, d.mean(axis=1))
            valid = np.isfinite(inter)
            s = np.where(
                valid, (inter - intra) / np.maximum(np.maximum(intra, inter), 1e-300), 0.0
            )
            total += float(s.sum())
    return total / count
