"""ALS matrix factorization on one card (counterpart of ``oryx_tpu/ops/als.py``).

The replacement for Spark MLlib's ALS (the hot loop of the reference's
ALSUpdate, app/oryx-app-mllib/.../als/ALSUpdate.java:116-124):
alternating normal-equation sweeps solved as batched k x k systems on
the card.

- Ratings arrive as COO (user_idx, item_idx, value). On the host they
  are packed into **degree buckets** (``ops/packing.py``, bit for bit
  the JAX package's): rows whose rating count rounds up to the same
  power-of-two width D share a padded [N_b, D] rectangle of neighbor
  indices and values, so a power-law degree distribution no longer
  forces every row to the maximum degree.
- One half-sweep solves every row of one side:
    implicit (Hu/Koren/Volinsky, MLlib semantics):
        c_ui = 1 + alpha*|r|, p_ui = 1 if r > 0 else 0
        A_u = YtY + sum_i (c-1) y_i y_i^T + lambda*I ;  b_u = sum_i c*p*y_i
    explicit (ALS-WR weighted-lambda):
        A_u = sum_i y_i y_i^T + lambda*n_u*I        ;  b_u = sum_i r y_i
  built with a gather and batched products and solved by batched
  Cholesky (the systems are symmetric positive definite for lam > 0).
  Rows go in chunks that keep the [C, D, k]
  gather workspace under ``workspace_elems``, and each chunk's systems
  are built and solved in pieces of at most ``SOLVE_ELEMS`` elements of
  A (the [C, k, k] systems are k/D times the workspace; at D = 8 and
  k = 200 a whole chunk's would take 10 GB before the solve's own copy).
  Every row is independent, so the pieces change no result.

Port notes:
- The JAX package runs all of this through XLA (no Pallas kernel); here
  it is PyTorch ops on one card. ``_compiled_run`` and
  ``compiled_run_cache_info`` existed only for XLA's compile cache and
  have no counterpart; nor has the XLA shape padding of the fold-in
  (``_bucket``).
- A device mesh (``parallel/mesh.py``), in the JAX package's two modes:
  replicated factors (each shard solves its slice of every bucket
  against its copy of the other side, YtY on each shard, and one
  ``all_reduce_sum`` of the disjoint solved rows replicates the new
  factors), or ``shard_factors=True`` (``_train_als_sharded``: factors in
  the device-major bucket layout of ``_sharded_layout``, YtY an
  ``all_reduce_sum`` of local Gramians, and the neighbor gather a ring
  exchange over S ``ring_shift`` steps). Pad slots are not solved in
  either mode: they solve to zero in the JAX package.
- The solve: the JAX package's ``jnp.linalg.solve`` is an LU solve; here
  ``torch.linalg.cholesky_ex`` and ``cholesky_solve``, since a batched
  LU (``solve_ex``) is several times slower on the card at rank 200
  (``chip_smoke.py``'s als-train phase times both; ``PERF.md``).
  Neither raises nor waits for the card: where ``jnp.linalg.solve`` returns non-finite values on
  a singular system (explicit feedback with lam = 0 and a rank-deficient
  row), a failed factorization gives NaN.
- Pad slots (each bucket's tail of row -1, there for XLA's shapes) are
  not uploaded or solved: they only ever scattered to the sacrificial
  last row, which is sliced off.
- ``matmul_dtype="bfloat16"``: JAX rounds the Gramian operands to
  bfloat16 and multiplies with float32 accumulation. Here the operands
  are rounded to bfloat16 and multiplied in float32, where every
  bfloat16 x bfloat16 product is exact: the same function, on the
  card's float32 units. Solves stay float32.
- Fold-in: ``jax.scipy.linalg.cho_factor`` yields NaN on a matrix that
  is not positive definite; ``torch.linalg.cholesky_ex`` reports it in
  ``info`` instead, which counts here as the non-finite case, so the
  ``pinv`` fallback re-solves exactly the rows the reference re-solves.
  JAX keeps the SVD off the hot path with ``lax.cond``; here it is a
  host check.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass
from typing import Callable, ContextManager, Optional

import numpy as np
import torch

from oryx_tpu_torch.common import ledger
from oryx_tpu_torch.common import rng as rng_mod
from oryx_tpu_torch.device import resolve
from oryx_tpu_torch.ops.packing import (  # noqa: F401  (re-export)
    NeighborBucket,
    PackingOptions,
    _pow2_at_least,
    build_neighbor_buckets_reference,
    pack_neighbor_buckets,
    pad_to_multiple,
)

log = logging.getLogger(__name__)

# wall seconds of the most recent train_als call, split by phase
# ({"pack": s, "init": s, "iterate": s}: neighbor-bucket packing vs the
# rest of setup (factor init) vs the upload and the sweeps, read back).
# Overwritten per call, never merged.
last_phase_seconds: dict[str, float] = {}

# elements of A ([rows, k, k]) built and solved at once
SOLVE_ELEMS = 1 << 26


@dataclass
class NeighborBlock:
    """Padded per-row neighbor structure for one side of the factorization."""

    idx: np.ndarray  # [N, D] int32 indices into the other side's factors
    val: np.ndarray  # [N, D] float32 rating values (0 where padded)
    mask: np.ndarray  # [N, D] float32 1/0 validity

    @property
    def num_rows(self) -> int:
        return self.idx.shape[0]


def build_neighbor_block(
    row_idx: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    num_rows: int,
    pad_rows_to: int = 1,
) -> NeighborBlock:
    """Group COO entries by row and pad to [N, Dmax] rectangles.

    Retained for small problems and tests; ``train_als`` uses the
    degree-bucketed :func:`build_neighbor_buckets`."""
    order = np.argsort(row_idx, kind="stable")
    r, c, v = row_idx[order], col_idx[order], values[order]
    counts = np.bincount(r, minlength=num_rows)
    dmax = max(1, int(counts.max()) if counts.size else 1)
    n = pad_to_multiple(max(num_rows, 1), pad_rows_to)
    idx = np.zeros((n, dmax), dtype=np.int32)
    val = np.zeros((n, dmax), dtype=np.float32)
    mask = np.zeros((n, dmax), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(r)) - starts[r]
    idx[r, pos] = c
    val[r, pos] = v
    mask[r, pos] = 1.0
    return NeighborBlock(idx, val, mask)


def build_neighbor_buckets(
    row_idx: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    num_rows: int,
    num_shards: int = 1,
    min_width: int = 8,
    workspace_elems: int = 1 << 27,
    features: int = 50,
    stable_shapes: bool = True,
    options: PackingOptions | None = None,
) -> list[NeighborBucket]:
    """Group COO entries by row into power-of-two degree buckets
    (``ops/packing.pack_neighbor_buckets``; the layout is bit for bit
    :func:`build_neighbor_buckets_reference`'s for every option value).
    Rows with no ratings appear in no bucket; each bucket's chunk keeps
    the [chunk, D, k] gather workspace under ``workspace_elems``."""
    return pack_neighbor_buckets(
        row_idx, col_idx, values, num_rows, num_shards, min_width,
        workspace_elems, features, stable_shapes, options,
    )


def _rounded(t: torch.Tensor, md: Optional[torch.dtype]) -> torch.Tensor:
    """t rounded to md's precision and held in float32: the product of two
    bfloat16 values is exact in float32, so a float32 product of rounded
    operands is a bfloat16 product with float32 accumulation."""
    return t if md is None else t.to(md).to(torch.float32)


def _normal_equations(v, cval, cmask, yty, lam, alpha, implicit, k, matmul_dtype=None):
    """A [C,k,k], b [C,k] of the per-row normal equations given the
    gathered neighbor workspace v [C,D,k] (zeros at masked slots).

    ``matmul_dtype=torch.bfloat16`` rounds the Gramian operands to
    bfloat16 (per-row confidence weights fold into one operand in f32
    BEFORE the rounding, so it applies once per factor entry); the k x k
    systems stay f32."""
    md = matmul_dtype
    eye = torch.eye(k, dtype=torch.float32, device=v.device)
    vm = _rounded(v, md)
    vt = vm.transpose(1, 2)
    if implicit:
        conf_m1 = alpha * cval.abs() * cmask  # c - 1
        vw = _rounded(v * conf_m1[..., None], md)
        a = yty[None] + torch.bmm(vw.transpose(1, 2), vm) + lam * eye[None]
        p = (cval > 0).to(torch.float32) * cmask
        bw = _rounded((1.0 + alpha * cval.abs()) * p, md)
    else:
        n_u = cmask.sum(dim=1)  # ratings per row (ALS-WR lambda scaling)
        a = torch.bmm(vt, vm) + (lam * n_u.clamp(min=1.0))[:, None, None] * eye[None]
        bw = _rounded(cval * cmask, md)
    b = torch.bmm(vt, bw[..., None])[..., 0]
    return a, b


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve of symmetric positive definite systems that neither
    raises nor syncs: a system whose factorization fails (a singular one)
    gives NaN, as ``jnp.linalg.solve`` gives non-finite values there."""
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(b[..., None], chol)[..., 0]
    return torch.where((info == 0)[:, None], x, float("nan"))


def _no_stage(_name: str) -> ContextManager:
    return contextlib.nullcontext()


def _sweep_buckets(
    other: torch.Tensor,  # [M(+1), k] factors of the other side (full copy)
    out_shape: int,  # rows in the output factor matrix (incl. pad slot)
    bucket_args: list[tuple],  # per bucket: (target, idx, val, deg, chunk)
    lam: float,
    alpha: float,
    implicit: bool,
    matmul_dtype=None,
    stage: Callable[[str], ContextManager] | None = None,
) -> torch.Tensor:
    """One half-sweep: solve every bucket and scatter results into a fresh
    [out_shape, k] factor matrix. Rows in no bucket (degree 0) stay zero;
    ``target`` is the bucket's output row per slot. ``stage(name)`` wraps
    the "gram" (gather and normal equations) and "solve" work, for
    timing."""
    k = other.shape[1]
    stage = stage or _no_stage
    yty = None
    if implicit:
        with stage("gram"):
            om = _rounded(other, matmul_dtype)
            yty = om.T @ om
    piece = max(1, SOLVE_ELEMS // (k * k))
    out = torch.zeros((out_shape, k), dtype=torch.float32, device=other.device)
    for target, idx, val, deg, chunk in bucket_args:
        n, d = idx.shape
        iota = torch.arange(d, dtype=torch.int32, device=other.device)
        for c0 in range(0, n, chunk):
            with stage("gram"):
                cidx, cval = idx[c0 : c0 + chunk], val[c0 : c0 + chunk]
                cmask = (iota[None, :] < deg[c0 : c0 + chunk, None]).to(torch.float32)
                v = other.index_select(0, cidx.reshape(-1)).view(*cidx.shape, k)
                v = v * cmask[..., None]
            for s0 in range(0, len(cidx), piece):
                s1 = s0 + piece
                with stage("gram"):
                    a, b = _normal_equations(
                        v[s0:s1], cval[s0:s1], cmask[s0:s1], yty, lam, alpha,
                        implicit, k, matmul_dtype,
                    )
                with stage("solve"):
                    out[target[c0 : c0 + chunk][s0:s1]] = _solve(a, b)
    return out


@dataclass
class ALSModel:
    """Factorization result: row-major float32 factor matrices."""

    x: np.ndarray  # [num_users, k]
    y: np.ndarray  # [num_items, k]


def bucket_tensors(buckets: list[NeighborBucket], device, shard: int = 0,
                   num_shards: int = 1) -> list[tuple]:
    """Each bucket's real slots on ``device`` as (target, idx, val, deg,
    chunk), target being the int64 output row per slot; of a mesh shard's
    slice of every bucket (its ``num_slots / num_shards`` slots) where
    ``num_shards`` > 1. The pad slots (row -1) are a bucket's tail and are
    left out."""
    out = []
    for b in buckets:
        per = b.num_slots // num_shards
        sl = slice(shard * per, (shard + 1) * per)
        rows = b.rows[sl]
        n = int(np.count_nonzero(rows >= 0))
        if not n:
            continue
        out.append((
            torch.from_numpy(rows[:n].astype(np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(b.idx[sl][:n])).to(device),
            torch.from_numpy(np.ascontiguousarray(b.val[sl][:n])).to(device),
            torch.from_numpy(np.ascontiguousarray(b.deg[sl][:n])).to(device),
            b.chunk,
        ))
    return out


def train_als(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    values: np.ndarray,
    num_users: int,
    num_items: int,
    features: int,
    lam: float,
    alpha: float = 1.0,
    implicit: bool = True,
    iterations: int = 10,
    mesh=None,
    seed: int | None = None,
    workspace_elems: int = 1 << 27,
    shard_factors: bool = False,
    matmul_dtype: str | None = None,
    init_y: np.ndarray | None = None,
    packing: PackingOptions | None = None,
    device=None,
) -> ALSModel:
    """Full ALS training run on ``device`` (default: the card).

    ``init_y`` [num_items, features] warm-starts the item factors from a
    previous generation; a shape mismatch falls back to cold init. The
    cold init draws ``np.random.default_rng(seed)`` exactly as the JAX
    package does, so a seeded run of either starts from the same
    factors. COO inputs are int32/float32 numpy arrays.
    ``workspace_elems`` bounds the per-chunk gather workspace (elements,
    not bytes). ``matmul_dtype="bfloat16"``
    (oryx.batch.compute.matmul-dtype) rounds the Gramian operands to
    bfloat16; solves stay f32. With ``mesh``, neighbor buckets are
    row-sharded over its shards; factors are replicated (default) or, with
    ``shard_factors=True``, sharded over the mesh (ring-exchange
    half-sweeps; ``init_y`` then does not apply, as in the JAX package).
    ``device`` applies without a mesh."""
    t_init = time.perf_counter()
    if matmul_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(
            f"matmul_dtype must be float32 or bfloat16, got {matmul_dtype!r}"
        )
    md = torch.bfloat16 if matmul_dtype == "bfloat16" else None
    seed_val = rng_mod.next_seed() if seed is None else seed
    if shard_factors:
        if mesh is None:
            raise ValueError("shard_factors=True requires a mesh")
        return _train_als_sharded(
            user_idx, item_idx, values, num_users, num_items, features,
            lam, alpha, implicit, iterations, mesh, seed_val, workspace_elems,
            md, packing,
        )
    dev = resolve(device) if mesh is None else None
    num_shards = mesh.size if mesh is not None else 1

    t_pack0 = time.perf_counter()
    u_buckets = build_neighbor_buckets(
        user_idx, item_idx, values, num_users, num_shards,
        workspace_elems=workspace_elems, features=features, options=packing,
    )
    i_buckets = build_neighbor_buckets(
        item_idx, user_idx, values, num_items, num_shards,
        workspace_elems=workspace_elems, features=features, options=packing,
    )
    t_pack = time.perf_counter() - t_pack0

    # MLlib-style init: small random normal factors (+1 sacrificial pad
    # row, then pow2 row padding as in the JAX package; pad rows are zero,
    # enter YtY as zero, and are sliced off on export)
    users_pad = _pow2_at_least(num_users + 1)
    items_pad = _pow2_at_least(num_items + 1)
    y0 = np.zeros((items_pad, features), np.float32)
    if init_y is not None and np.shape(init_y) == (num_items, features):
        y0[:num_items] = np.asarray(init_y, dtype=np.float32)
    else:
        if init_y is not None:
            log.info(
                "init_y shape %s != (%d, %d); cold-starting",
                np.shape(init_y), num_items, features,
            )
        y0[:num_items] = 0.1 * np.random.default_rng(seed_val).standard_normal(
            (num_items, features)
        ).astype(np.float32)

    t_iter = time.perf_counter()
    if mesh is not None:
        x, y = _run_replicated(mesh, u_buckets, i_buckets, y0, users_pad, items_pad,
                               iterations, lam, alpha, implicit, md)
    else:
        u_args = bucket_tensors(u_buckets, dev)
        i_args = bucket_tensors(i_buckets, dev)
        x = torch.zeros((users_pad, features), dtype=torch.float32, device=dev)
        y = torch.from_numpy(y0).to(dev)
        for _ in range(iterations):
            x = _sweep_buckets(y, users_pad, u_args, lam, alpha, implicit, md)
            y = _sweep_buckets(x, items_pad, i_args, lam, alpha, implicit, md)
    x_np = x[:num_users].cpu().numpy()
    y_np = y[:num_items].cpu().numpy()
    last_phase_seconds.clear()
    last_phase_seconds.update(
        pack=t_pack,
        init=t_iter - t_init - t_pack,
        iterate=time.perf_counter() - t_iter,
    )
    return ALSModel(x=x_np, y=y_np)


def _run_replicated(mesh, u_buckets, i_buckets, y0: np.ndarray, users_pad: int,
                    items_pad: int, iterations: int, lam, alpha, implicit, md):
    """Replicated-factor half-sweeps over ``mesh``: every shard solves its
    slice of each bucket against its copy of the other side (YtY on each
    shard), and one ``all_reduce_sum`` of the shards' outputs, whose rows
    are disjoint, gives every shard the new factors. Returns the first
    local shard's (x, y)."""
    from oryx_tpu_torch.parallel.mesh import all_reduce_sum, put, replicated

    s = mesh.size
    devs = mesh.local_devices()
    u_args = [bucket_tensors(u_buckets, d, i, s) for i, d in zip(mesh.local, devs)]
    i_args = [bucket_tensors(i_buckets, d, i, s) for i, d in zip(mesh.local, devs)]
    y_l = put(y0, replicated(mesh))
    x_l = y_l
    for _ in range(iterations):
        x_l = all_reduce_sum(mesh, [
            _sweep_buckets(y, users_pad, a, lam, alpha, implicit, md) for y, a in zip(y_l, u_args)
        ])
        y_l = all_reduce_sum(mesh, [
            _sweep_buckets(x, items_pad, a, lam, alpha, implicit, md) for x, a in zip(x_l, i_args)
        ])
    if not iterations:
        x_l = [torch.zeros((users_pad, y0.shape[1]), dtype=torch.float32, device=devs[0])]
    return x_l[0], y_l[0]


# ---------------------------------------------------------------------------
# Sharded-factor training: ring-exchange half-sweeps
# ---------------------------------------------------------------------------


def _sharded_layout(buckets: list[NeighborBucket], num_rows: int, s: int):
    """Device-major slot layout for sharded factors.

    Global slot order is device-major, bucket-minor: device d's block is
    the concatenation of every bucket's d-th shard slice. Returns
    (perm_rows [T] global row id per slot (-1 pad), pos [num_rows] slot
    position per row (-1 if degree 0), loc = slots per device)."""
    loc = sum(b.num_slots // s for b in buckets)
    total = loc * s
    perm_rows = np.full(total, -1, dtype=np.int64)
    pos = np.full(num_rows, -1, dtype=np.int64)
    offset = 0
    for b in buckets:
        n_b = b.num_slots
        n_loc = n_b // s
        i = np.arange(n_b)
        d, j = i // n_loc, i % n_loc
        gp = d * loc + offset + j
        perm_rows[gp] = b.rows
        valid = b.rows >= 0
        pos[b.rows[valid]] = gp[valid]
        offset += n_loc
    return perm_rows, pos, loc


def _translate_to_shards(idx: np.ndarray, pos_other: np.ndarray, other_loc: int):
    """Map col ids to (owner shard, local row) in the other side's layout.

    Entries whose col has no slot (only possible for mask-0 padding, idx
    0) get shard -1 — matched by no ring step, contributing zero."""
    p = pos_other[idx]
    ish = np.where(p < 0, -1, p // other_loc).astype(np.int32)
    ilo = np.where(p < 0, 0, p % other_loc).astype(np.int32)
    return ish, ilo


def _shard_slices(buckets, arrs, shard: int, s: int, device) -> list[tuple]:
    """A shard's slice of every bucket in the sharded layout: (ish, ilo,
    val, deg) on ``device``, the slots per shard, the real (leading) slots
    among them and the chunk."""
    out = []
    for b, (ish, ilo, val, deg) in zip(buckets, arrs):
        per = b.num_slots // s
        sl = slice(shard * per, (shard + 1) * per)
        real = int(np.count_nonzero(b.rows[sl] >= 0))
        out.append((
            *(torch.from_numpy(np.ascontiguousarray(a[sl])).to(device)
              for a in (ish, ilo, val, deg)),
            per, real, b.chunk,
        ))
    return out


def _ring_fill(mesh, other_l, ish_l, ilo_l) -> list[torch.Tensor]:
    """Every local shard's [C, D, k] neighbor workspace: at ring step t
    shard g holds the other side's shard (g + t) mod S and fills the slots
    that shard owns (``ring_fill`` of the JAX package; its last shift,
    which returns every block home, is left out)."""
    from oryx_tpu_torch.parallel.mesh import ring_shift

    s = mesh.size
    k = other_l[0].shape[1]
    v_l = [torch.zeros(ish.shape + (k,), dtype=torch.float32, device=ish.device)
           for ish in ish_l]
    cur = list(other_l)
    for t in range(s):
        for j, g in enumerate(mesh.local):
            hit = (ish_l[j] == (g + t) % s)[..., None]
            v_l[j] = v_l[j] + torch.where(hit, cur[j][ilo_l[j].long()], 0.0)
        if t + 1 < s:
            cur = ring_shift(mesh, cur)
    return v_l


def _sharded_half_sweep(mesh, other_l, shard_args, out_rows: int, lam, alpha, implicit, md):
    """One half-sweep with factors sharded: YtY an ``all_reduce_sum`` of the
    shards' Gramians (pad slots are zero), every chunk's workspace a ring
    fill, then each shard solves its chunk's real slots into its
    [out_rows, k] block (pad slots stay zero)."""
    from oryx_tpu_torch.parallel.mesh import all_reduce_sum

    k = other_l[0].shape[1]
    yty_l = [None] * len(other_l)
    if implicit:
        yty_l = all_reduce_sum(mesh, [_rounded(o, md).T @ _rounded(o, md) for o in other_l])
    out_l = [torch.zeros((out_rows, k), dtype=torch.float32, device=o.device) for o in other_l]
    piece = max(1, SOLVE_ELEMS // (k * k))
    offset = 0
    for b in range(len(shard_args[0])):
        per, chunk = shard_args[0][b][4], shard_args[0][b][6]
        for c0 in range(0, per, chunk):
            c1 = min(c0 + chunk, per)
            # the slots each shard solves: its real slots lead its slice
            reals = [max(0, min(c1, a[b][5]) - c0) for a in shard_args]
            v_l = _ring_fill(
                mesh, other_l,
                [a[b][0][c0 : c0 + r] for a, r in zip(shard_args, reals)],
                [a[b][1][c0 : c0 + r] for a, r in zip(shard_args, reals)],
            )
            for j, (a, r) in enumerate(zip(shard_args, reals)):
                if not r:
                    continue
                cval, cdeg = a[b][2][c0 : c0 + r], a[b][3][c0 : c0 + r]
                iota = torch.arange(cval.shape[1], dtype=torch.int32, device=cval.device)
                cmask = (iota[None, :] < cdeg[:, None]).to(torch.float32)
                v = v_l[j] * cmask[..., None]
                for s0 in range(0, r, piece):
                    s1 = min(s0 + piece, r)
                    am, bm = _normal_equations(v[s0:s1], cval[s0:s1], cmask[s0:s1], yty_l[j],
                                               lam, alpha, implicit, k, md)
                    out_l[j][offset + c0 + s0 : offset + c0 + s1] = _solve(am, bm)
        offset += per
    return out_l


def _train_als_sharded(
    user_idx, item_idx, values, num_users, num_items, features,
    lam, alpha, implicit, iterations, mesh, seed_val, workspace_elems,
    matmul_dtype=None, packing=None,
) -> ALSModel:
    """ALS with factors sharded over the mesh (see the module doc): the
    JAX package's layout, permutations and init, so the natural-order
    factors compare."""
    from oryx_tpu_torch.parallel.mesh import all_gather, put, shard_rows

    t_init = time.perf_counter()
    s = mesh.size
    u_buckets = build_neighbor_buckets(
        user_idx, item_idx, values, num_users, s,
        workspace_elems=workspace_elems, features=features, options=packing,
    )
    i_buckets = build_neighbor_buckets(
        item_idx, user_idx, values, num_items, s,
        workspace_elems=workspace_elems, features=features, options=packing,
    )
    if not u_buckets or not i_buckets:
        return ALSModel(
            x=np.zeros((num_users, features), np.float32),
            y=np.zeros((num_items, features), np.float32),
        )

    t_pack = time.perf_counter() - t_init
    perm_x, pos_x, u_loc = _sharded_layout(u_buckets, num_users, s)
    perm_y, pos_y, i_loc = _sharded_layout(i_buckets, num_items, s)
    u_arrs = [(*_translate_to_shards(b.idx, pos_y, i_loc), b.val, b.deg) for b in u_buckets]
    i_arrs = [(*_translate_to_shards(b.idx, pos_x, u_loc), b.val, b.deg) for b in i_buckets]
    devs = mesh.local_devices()
    u_sh = [_shard_slices(u_buckets, u_arrs, i, s, d) for i, d in zip(mesh.local, devs)]
    i_sh = [_shard_slices(i_buckets, i_arrs, i, s, d) for i, d in zip(mesh.local, devs)]

    # the natural-order init of the replicated path, permuted into the
    # sharded layout (pad slots zero: they enter the summed YtY)
    y_nat = 0.1 * np.random.default_rng(seed_val).standard_normal(
        (num_items, features)
    ).astype(np.float32)
    y0 = np.zeros((i_loc * s, features), np.float32)
    yv0 = perm_y >= 0
    y0[yv0] = y_nat[perm_y[yv0]]

    t_iter = time.perf_counter()
    y_l = put(y0, shard_rows(mesh))
    x_l = [torch.zeros((u_loc, features), dtype=torch.float32, device=d) for d in devs]
    for _ in range(iterations):
        x_l = _sharded_half_sweep(mesh, y_l, u_sh, u_loc, lam, alpha, implicit, matmul_dtype)
        y_l = _sharded_half_sweep(mesh, x_l, i_sh, i_loc, lam, alpha, implicit, matmul_dtype)
    x_p = all_gather(mesh, x_l)[0].cpu().numpy()
    y_p = all_gather(mesh, y_l)[0].cpu().numpy()

    x = np.zeros((num_users, features), np.float32)
    y = np.zeros((num_items, features), np.float32)
    xv = perm_x >= 0
    yv = perm_y >= 0
    x[perm_x[xv]] = x_p[xv]
    y[perm_y[yv]] = y_p[yv]
    last_phase_seconds.clear()
    last_phase_seconds.update(
        pack=t_pack,
        init=t_iter - t_init - t_pack,
        iterate=time.perf_counter() - t_iter,
    )
    return ALSModel(x=x, y=y)


# -- evaluation --------------------------------------------------------------

def _to(a, dtype: torch.dtype, device) -> torch.Tensor:
    """a (a tensor, or anything numpy takes) as a ``dtype`` tensor on
    ``device``; numpy input is copied, so a read-only array is fine."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=dtype, device=device)
    return torch.from_numpy(np.array(a, dtype=_NUMPY_OF[dtype])).to(device)


_NUMPY_OF = {torch.float32: np.float32, torch.bool: np.bool_, torch.int64: np.int64}



# elements of one [pairs, k] gather of predict_pairs / mean_auc
_EVAL_ELEMS = 1 << 24


def predict_pairs(x: np.ndarray, y: np.ndarray, user_idx: np.ndarray, item_idx: np.ndarray,
                  device=None) -> np.ndarray:
    """Predicted strengths for (user, item) pairs (on the card, batched)."""
    dev = resolve(device)
    xa, ya = _to(x, torch.float32, dev), _to(y, torch.float32, dev)
    ui, ii = _to(user_idx, torch.int64, dev), _to(item_idx, torch.int64, dev)
    step = max(1, _EVAL_ELEMS // max(xa.shape[1], 1))
    out = [
        torch.sum(xa[ui[s : s + step]] * ya[ii[s : s + step]], dim=-1)
        for s in range(0, len(ui), step)
    ]
    if not out:
        return np.zeros(0, np.float32)
    return torch.cat(out).cpu().numpy()


def rmse(x: np.ndarray, y: np.ndarray, user_idx, item_idx, values, device=None) -> float:
    """Root mean squared error over test pairs (Evaluation.rmse analogue,
    app/oryx-app-mllib/.../als/Evaluation.java:49-63)."""
    if len(values) == 0:
        return float("nan")
    pred = predict_pairs(x, y, user_idx, item_idx, device)
    return float(np.sqrt(np.mean((pred - values) ** 2)))


def _auc_bucket(x, y, uids, pos, posm, neg, negm, chunk):
    """Per-user AUC for one degree bucket: [N, P] padded positive and
    sampled-negative item ids + masks, scored on the card with the
    pairwise [C, P, P] comparison in chunks of ``chunk`` users."""
    aucs, valids = [], []
    for c0 in range(0, uids.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        xu = x[uids[sl]][..., None]  # [C, k, 1]
        sp = torch.bmm(y[pos[sl]], xu)[..., 0]
        sn = torch.bmm(y[neg[sl]], xu)[..., 0]
        cpm, cnm = posm[sl], negm[sl]
        gt = (
            (sp[:, :, None] > sn[:, None, :]) & cpm[:, :, None] & cnm[:, None, :]
        ).sum(dim=(1, 2))
        pairs = cpm.sum(dim=1) * cnm.sum(dim=1)
        aucs.append(gt / pairs.clamp(min=1))
        valids.append(pairs > 0)
    return torch.cat(aucs), torch.cat(valids)


def mean_auc(
    x: np.ndarray,
    y: np.ndarray,
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    rng: np.random.Generator,
    device=None,
) -> float:
    """Mean per-user AUC with about as many sampled negatives as positives
    per user (Evaluation.areaUnderCurve, Evaluation.java:70-136).

    Users are grouped into power-of-two positive-count buckets; negative
    sampling (4x candidates, positives rejected) runs on the host on the
    caller's ``rng``, exactly as in the JAX package, and the scores and
    pairwise comparisons on the card."""
    if len(user_idx) == 0:
        return float("nan")
    dev = resolve(device)
    all_items = np.unique(item_idx)
    order = np.argsort(user_idx, kind="stable")
    uu, ii = user_idx[order], item_idx[order]
    uniq_users, starts = np.unique(uu, return_index=True)
    ends = np.concatenate([starts[1:], [len(uu)]])
    counts = ends - starts

    xd, yd = _to(x, torch.float32, dev), _to(y, torch.float32, dev)
    k = max(int(xd.shape[1]), 1)

    entry_user = np.repeat(np.arange(len(uniq_users)), counts)
    entry_pos = np.arange(len(ii)) - np.repeat(starts, counts)

    aucs: list[np.ndarray] = []
    valids: list[np.ndarray] = []
    widths = np.maximum(1, 2 ** np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64))
    for w in sorted(set(widths.tolist())):
        sel = np.flatnonzero(widths == w)
        nu = len(sel)
        p = int(w)
        pos = np.zeros((nu, p), dtype=np.int64)
        posm = np.zeros((nu, p), dtype=bool)
        slot_of = np.full(len(uniq_users), -1, dtype=np.int64)
        slot_of[sel] = np.arange(nu)
        esel = slot_of[entry_user] >= 0
        pos[slot_of[entry_user[esel]], entry_pos[esel]] = ii[esel]
        posm[slot_of[entry_user[esel]], entry_pos[esel]] = True
        # sample 4x candidates, reject positives via disjoint-range keys:
        # row r's sorted positives become keys in [r*M, (r+1)*M) so one
        # global searchsorted answers rowwise membership
        m = int(all_items.max()) + 2
        cand = rng.choice(all_items, size=(nu, 4 * p))
        keys = np.sort(np.where(posm, pos, m - 1) + np.arange(nu)[:, None] * m, axis=1)
        ckeys = cand + np.arange(nu)[:, None] * m
        loc = np.searchsorted(keys.ravel(), ckeys.ravel())
        hit = np.zeros(loc.shape, dtype=bool)
        in_range = loc < keys.size
        hit[in_range] = keys.ravel()[loc[in_range]] == ckeys.ravel()[in_range]
        ok = ~hit.reshape(nu, 4 * p)
        rank = np.cumsum(ok, axis=1) - 1
        want = counts[sel][:, None]  # as many negatives as positives
        take = ok & (rank < want) & (rank < p)
        neg = np.zeros((nu, p), dtype=np.int64)
        negm = np.zeros((nu, p), dtype=bool)
        rows, cols = np.nonzero(take)
        neg[rows, rank[rows, cols]] = cand[rows, cols]
        negm[rows, rank[rows, cols]] = True

        chunk = max(1, min(nu, (1 << 24) // max(p * p, 1), _EVAL_ELEMS // (p * k)))
        a, v = _auc_bucket(
            xd, yd, _to(uniq_users[sel], torch.int64, dev),
            _to(pos, torch.int64, dev), _to(posm, torch.bool, dev),
            _to(neg, torch.int64, dev), _to(negm, torch.bool, dev), chunk,
        )
        aucs.append(a.cpu().numpy())
        valids.append(v.cpu().numpy())
    auc = np.concatenate(aucs)
    valid = np.concatenate(valids)
    return float(auc[valid].mean()) if valid.any() else float("nan")


# ---------------------------------------------------------------------------
# Speed-layer fold-in, batched
# ---------------------------------------------------------------------------
#
# The reference folds in one event at a time (ALSUtils.computeUpdatedXu:
# 74-106 inside ALSSpeedModelManager.buildUpdates' parallelStream). All
# events in a micro-batch read the PRE-batch model state (updates travel
# via the update topic, not in-place), so the whole batch is one
# data-parallel computation: a single [k,k] Cholesky factorization per
# side reused against an [n,k] right-hand-side block.


def _batch_target_qui(implicit: bool, values, current):
    """Vectorized ALSUtils.computeTargetQui:37-59; NaN = no update."""
    if not implicit:
        return values
    pos = (values > 0.0) & (current < 1.0)
    t_pos = current + (values / (1.0 + values)) * (1.0 - current.clamp(min=0.0))
    neg = (values < 0.0) & (current > 0.0)
    t_neg = current + (values / (values - 1.0)) * (0.0 - current.clamp(max=1.0))
    nan = torch.full_like(values, float("nan"))
    return torch.where(pos, t_pos, torch.where(neg, t_neg, nan))


def _fold_half(ata, vecs_own, own_valid, vecs_other, other_valid, values, implicit):
    """New own-side vectors after events against the other side's vectors
    (torch, on the tensors' device).

    vecs_own[n,k] current vectors (zeros where own_valid is False — a
    brand-new row starts from a "don't know" prior of 0.5), vecs_other
    the interacting vectors. Returns (new_vecs[n,k], updated[n])."""
    qui = torch.where(own_valid, torch.sum(vecs_own * vecs_other, dim=1), 0.0)
    current = torch.where(own_valid, qui, 0.5)
    target = _batch_target_qui(implicit, values, current)
    d_qui = target - qui
    rhs = d_qui[:, None] * vecs_other  # [n, k]
    chol, info = torch.linalg.cholesky_ex(ata)
    d_vec = torch.cholesky_solve(rhs.T, chol).T
    # a factorization that failed (info > 0: not positive definite) is
    # the reference's NaN factor: every row re-solves by pseudo-inverse,
    # as do rows that came out non-finite
    row_ok = torch.isfinite(d_vec).all(dim=1) & (info == 0)
    if not bool(row_ok.all()):
        d_pinv = (torch.linalg.pinv(ata, rtol=1e-5) @ rhs.T).T
        d_vec = torch.where(row_ok[:, None], d_vec, d_pinv)
    new_vecs = torch.where(own_valid[:, None], vecs_own, 0.0) + d_vec
    updated = other_valid & ~torch.isnan(target) & torch.isfinite(d_vec).all(dim=1)
    return torch.where(updated[:, None], new_vecs, 0.0), updated


def _fold_in_batch_device(yty, xtx, xu, xu_valid, yi, yi_valid, values, implicit):
    new_xu, x_upd = _fold_half(yty, xu, xu_valid, yi, yi_valid, values, implicit)
    new_yi, y_upd = _fold_half(xtx, yi, yi_valid, xu, xu_valid, values, implicit)
    return tuple(t.cpu().numpy() for t in (new_xu, x_upd, new_yi, y_upd))


def _fold_half_host(ata, vecs_own, own_valid, vecs_other, other_valid, values, implicit):
    """Host (BLAS) twin of _fold_half: float32 vectors/solves (same
    precision as the device path), float64 target math (scalar parity)."""
    vo = np.asarray(vecs_own, dtype=np.float32)
    vt = np.asarray(vecs_other, dtype=np.float32)
    values = values.astype(np.float64)
    qui = np.where(own_valid, np.einsum("nk,nk->n", vo, vt, dtype=np.float64), 0.0)
    current = np.where(own_valid, qui, 0.5)
    if implicit:
        with np.errstate(divide="ignore", invalid="ignore"):
            t_pos = current + (values / (1.0 + values)) * (1.0 - np.maximum(0.0, current))
            t_neg = current + (values / (values - 1.0)) * (0.0 - np.minimum(1.0, current))
        target = np.where(
            (values > 0.0) & (current < 1.0),
            t_pos,
            np.where((values < 0.0) & (current > 0.0), t_neg, np.nan),
        )
    else:
        target = values
    d_qui = np.nan_to_num(target - qui).astype(np.float32)
    rhs = d_qui[:, None] * vt
    ata32 = np.asarray(ata, dtype=np.float32)
    try:
        # AtA is SPD and k x k (tiny): invert it ONCE via Cholesky (in
        # float64 for the inversion's sake), then apply to all n right-hand
        # sides as a single GEMM. The pinv fallback below still catches
        # ill-conditioned Gramians.
        import scipy.linalg as sla

        chol = sla.cho_factor(ata32.astype(np.float64), lower=True, check_finite=False)
        ainv = sla.cho_solve(
            chol, np.eye(ata32.shape[0], dtype=np.float64), check_finite=False
        ).astype(np.float32)
        d_vec = rhs @ ainv  # ainv symmetric: no transpose needed
    except Exception:
        d_vec = np.full_like(rhs, np.nan)
    # same safety net as the device path: singular/ill-conditioned AtA
    # falls back to a pseudo-inverse solve, and rows that still come out
    # non-finite are dropped instead of published
    finite = np.isfinite(d_vec).all(axis=1)
    if not finite.all():
        d_lstsq = (np.linalg.pinv(ata32, rcond=1e-5) @ rhs.T).T
        d_vec = np.where(~finite[:, None], d_lstsq, d_vec)
        finite = np.isfinite(d_vec).all(axis=1)
    new = np.where(own_valid[:, None], vo, 0.0)
    new += d_vec  # in-place: [n,k] temp saved, bits unchanged
    updated = other_valid & ~np.isnan(target) & finite
    if not updated.all():  # zero dropped rows in place of a full where-copy
        new[~updated] = 0.0
    return new.astype(np.float32, copy=False), updated


_auto_fold_choice: str | None = None


def _calibrate_fold_backend(yty, xtx, xu, xu_valid, yi, yi_valid, values, implicit):
    """Time host vs device on this real batch, lock in the winner, return
    the host result (already computed — no work wasted). The device is
    timed on a second call so its first-call set-up does not count."""
    global _auto_fold_choice
    t0 = time.perf_counter()
    host_result = fold_in_batch(
        yty, xtx, xu, xu_valid, yi, yi_valid, values, implicit, backend="host"
    )
    t_host = time.perf_counter() - t0
    try:
        fold_in_batch(  # first dispatch, untimed
            yty, xtx, xu, xu_valid, yi, yi_valid, values, implicit, backend="device"
        )
        t0 = time.perf_counter()
        fold_in_batch(
            yty, xtx, xu, xu_valid, yi, yi_valid, values, implicit, backend="device"
        )
        t_device = time.perf_counter() - t0
    except Exception:  # device backend unusable: host it is
        t_device = float("inf")
    _auto_fold_choice = "device" if t_device < t_host else "host"
    log.info(
        "fold-in auto backend: host %.3fs vs device %.3fs at n=%d -> %s",
        t_host, t_device, len(values), _auto_fold_choice,
    )
    return host_result


def _on_device(a, dtype=torch.float32) -> torch.Tensor:
    return _to(a, dtype, resolve(None))


def _on_host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def fold_in_batch(
    yty,
    xtx,
    xu: np.ndarray,
    xu_valid: np.ndarray,
    yi: np.ndarray,
    yi_valid: np.ndarray,
    values: np.ndarray,
    implicit: bool,
    backend: str = "auto",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fold a micro-batch of n (user, item, value) events into both factor
    sides at once. xu/yi are the events' current vectors ([n,k], zero rows
    where the id is new, flagged by the valid masks). Returns
    (new_xu[n,k], x_updated[n], new_yi[n,k], y_updated[n]) — rows where
    the updated flag is False carry no update (reference: None returns of
    ALSUtils.computeUpdatedXu).

    backend: 'device' (torch on the port's device: the card unless the
    caller chose the CPU), 'host' (float64 BLAS inverse, numpy), or
    'auto' — measured, not guessed: the first large enough batch runs
    both backends once, times them, and locks in the winner for the
    process."""
    n, k = xu.shape
    if backend == "auto":
        if _auto_fold_choice is not None:
            backend = _auto_fold_choice
        elif n * max(k, 1) < 500_000:
            backend = "host"  # too small to learn from; host wins when tiny
        else:
            return _calibrate_fold_backend(
                yty, xtx, xu, xu_valid, yi, yi_valid, values, implicit
            )
    if backend == "host":
        yty, xtx = _on_host(yty), _on_host(xtx)
        new_xu, x_upd = _fold_half_host(yty, xu, xu_valid, yi, yi_valid, values, implicit)
        new_yi, y_upd = _fold_half_host(xtx, yi, yi_valid, xu, xu_valid, values, implicit)
        return new_xu, x_upd, new_yi, y_upd
    return _fold_in_batch_device(
        _on_device(yty), _on_device(xtx), _on_device(xu), _on_device(xu_valid, torch.bool),
        _on_device(yi), _on_device(yi_valid, torch.bool), _on_device(values), implicit,
    )


def device_gramian(mat: np.ndarray) -> torch.Tensor:
    """Upload a [k,k] Gramian once as a float32 tensor on the port's
    device. Callers cache the result on the owning Solver instance: the
    solver cache is invalidated exactly when the Gramian changes (vector
    writes, model rotation), so a fresh Solver — not every micro-batch —
    is the only event that pays the upload again."""
    return _on_device(np.asarray(mat))


class FoldInSession:
    """Accumulate fold-in delta blocks and solve them as one micro-batch.

    The pipelined speed layer parses the input stream into several event
    blocks per micro-batch (one per transport frame). A session
    accumulates the gathered vector blocks as they arrive — placed on the
    device at once when the fold backend is the device, so the copies
    overlap the parse stage — and issues ONE solve over the
    concatenation per micro-batch.

    ``yty``/``xtx`` may be numpy arrays or tensors from
    :func:`device_gramian`. Results are computed by the exact same code
    as :func:`fold_in_batch`, so a session is bit-identical to the
    unbatched fold at f32."""

    def __init__(self, yty, xtx, implicit: bool, backend: str = "auto") -> None:
        self.yty = yty
        self.xtx = xtx
        self.implicit = implicit
        self.backend = backend
        self._blocks: list[tuple] = []
        self._pending = 0
        # released by reference drop (the device Gramians/blocks live as
        # long as the session) — no probe, live while strongly referenced
        ledger.register("session", self)

    def _resolved_backend(self, n: int, k: int) -> str:
        if self.backend != "auto":
            return self.backend
        if _auto_fold_choice is not None:
            return _auto_fold_choice
        return "host" if n * max(k, 1) < 500_000 else "auto"

    def resolved_backend(self, n: int, k: int) -> str:
        """The backend this session would pick for an [n,k] micro-batch.
        Callers use it to decide whether device-resident Gramians are
        worth handing in: the host path wants the float64 originals (its
        Cholesky runs in f64), the device path casts to f32 regardless."""
        return self._resolved_backend(n, k)

    def add_block(self, xu, xu_valid, yi, yi_valid, values) -> None:
        n, k = xu.shape
        if self._resolved_backend(max(self._pending + n, n), k) == "device":
            block = (
                _on_device(xu), _on_device(xu_valid, torch.bool), _on_device(yi),
                _on_device(yi_valid, torch.bool), _on_device(values),
            )
        else:
            block = (xu, xu_valid, yi, yi_valid, values)
        self._blocks.append(block)
        self._pending += n

    @property
    def pending(self) -> int:
        return self._pending

    def solve(self):
        """One fold over everything accumulated; clears the session.
        Returns (new_xu, x_updated, new_yi, y_updated) like fold_in_batch,
        or None when nothing is pending."""
        if not self._blocks:
            return None
        blocks, self._blocks = self._blocks, []
        n, self._pending = self._pending, 0
        k = blocks[0][0].shape[1]
        backend = self._resolved_backend(n, k)
        if backend == "device" and all(isinstance(b[0], torch.Tensor) for b in blocks):
            # all-device micro-batch: concatenate on the device and fold
            # with the resident Gramians directly — the only host traffic
            # is the [n,k] results coming back
            cat = [
                col[0] if len(blocks) == 1 else torch.cat(col)
                for col in zip(*blocks)
            ]
            return _fold_in_batch_device(
                _on_device(self.yty), _on_device(self.xtx), *cat, self.implicit
            )
        cols = [[_on_host(c) for c in col] for col in zip(*blocks)]
        cat = [col[0] if len(col) == 1 else np.concatenate(col) for col in cols]
        return fold_in_batch(
            _on_host(self.yty), _on_host(self.xtx), *cat, self.implicit, backend=backend
        )


class PartitionedFoldInSession:
    """Sharded fold-in: K disjoint accumulator slices over ONE shared
    Gramian pair.

    The sharded speed pipeline runs K independent parse->fold->publish
    chains; each chain folds only its own partitions' events. Every
    slice shares the same ``yty``/``xtx`` references (device-resident via
    :func:`device_gramian` when the backend resolves there — uploaded
    ONCE for all K shards), and each shard's blocks accumulate in its own
    slice so concurrent ``add_block``/``solve_shard`` calls never touch
    shared state.

    Bit-identity: the fold math is row-wise independent, so folding a
    shard's slice alone, or merging all slices into one solve
    (:meth:`solve`, shard order), produces EXACTLY the f32 bits a single
    session fed the same events would."""

    def __init__(self, yty, xtx, implicit: bool, shards: int, backend: str = "auto") -> None:
        if shards < 1:
            raise ValueError("shards must be >= 1")
        self.implicit = implicit
        self.backend = backend
        self._slices = [
            FoldInSession(yty, xtx, implicit, backend) for _ in range(shards)
        ]

    @property
    def shards(self) -> int:
        return len(self._slices)

    @property
    def pending(self) -> int:
        return sum(s.pending for s in self._slices)

    def set_gramians(self, yty, xtx) -> None:
        """Swap in (typically device-resident) Gramians for every slice —
        one upload serves all K shards for the life of the Solver pair."""
        for s in self._slices:
            s.yty = yty
            s.xtx = xtx

    def session(self, shard: int) -> FoldInSession:
        """Shard ``shard``'s private slice. Distinct shards may use their
        slices concurrently; one shard's slice is single-threaded."""
        return self._slices[shard % len(self._slices)]

    def resolved_backend(self, n: int, k: int) -> str:
        return self._slices[0].resolved_backend(n, k)

    def add_block(self, shard: int, xu, xu_valid, yi, yi_valid, values) -> None:
        self.session(shard).add_block(xu, xu_valid, yi, yi_valid, values)

    def solve_shard(self, shard: int):
        """Fold shard ``shard``'s accumulated slice alone (its micro-batch
        boundary); other shards' slices are untouched."""
        return self.session(shard).solve()

    def solve(self):
        """The merge step: reconcile ALL slices in shard order into one
        solve (list moves only; the concatenation happens inside the
        single solve)."""
        merged = self._slices[0]
        for s in self._slices[1:]:
            merged._blocks.extend(s._blocks)
            merged._pending += s._pending
            s._blocks = []
            s._pending = 0
        return merged.solve()
