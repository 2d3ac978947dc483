"""Host-side neighbor-bucket packing for ALS ingest.

This module owns the COO -> degree-bucketed neighbor layout transform that
feeds the device sweeps in :mod:`oryx_tpu_torch.ops.als` (the analogue of the
reference's Spark-side block partitioning in ``ALSUpdate.java``). Two
implementations produce **bit-identical** buckets:

``build_neighbor_buckets_reference``
    The original single-process composite-key path: one stable argsort by
    ``(width_code << 40) | row`` over all entries. Kept as the equivalence
    oracle and as a fallback; its int64 comparison sort is the scaling
    wall (~3M entries/s on one core at 50M ratings).

``pack_neighbor_buckets``
    The sharded engine. Rows are split into contiguous ranges; each range
    is packed independently and writes directly into a preallocated
    arena, either in-process (1 worker) or from forked worker processes
    through ``multiprocessing.shared_memory`` (zero-copy handoff — no
    rating block is ever pickled; inputs reach workers by fork
    copy-on-write, outputs come back as the parent's own mapping of the
    shared arena). Input is streamed in bounded chunks (``chunk_rows``
    COO entries at a time) during counting and shard selection so peak
    RSS stays flat relative to the working set as the dataset grows.

    The restructure is also the single-core win: sorting by 16-bit keys
    (block id, then row-within-block) hits numpy's radix sort instead of
    the int64 timsort (~7x on the sort), and the final placement is one
    flat scatter through a per-row precomputed destination base instead
    of per-bucket masked passes.

Determinism contract: packing consumes no RNG, and the bucket layout is a
pure function of ``(row_idx, col_idx, values, num_rows, num_shards,
min_width, workspace_elems, features, stable_shapes)`` — the shard count,
worker count and chunk size never change a byte of the output. Within a
bucket, rows are ordered by ascending row id (the rank of the row among
same-width rows) and each row's entries keep input arrival order, exactly
the order the reference path's stable composite-key sort produces.

Port note: a copy of ``oryx_tpu/ops/packing.py``; its buckets are bit
for bit the JAX package's for every option value. The port forks its
packing workers from a process that already holds a CUDA context and
supervised threads, so the worker path (``_worker_main``,
``_pack_range``) stays numpy-only: it touches no torch object, takes no
lock and logs nothing, and a forked child has only the thread that
forked it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
import weakref
from dataclasses import dataclass
from multiprocessing import get_context, shared_memory
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

# Rows per radix block: keys within a block fit uint16, numpy's stable
# sort dispatches to radix for <=16-bit integers.
_BLOCK_BITS = 16
_BLOCK = 1 << _BLOCK_BITS

# Multiprocess packing only pays for itself beyond this many entries;
# below it "auto" resolves to the in-process path.
_MIN_PARALLEL_NNZ = 2_000_000

# wall seconds of the most recent pack_neighbor_buckets call, split by
# phase, plus the resolved worker count. Read by ops/als.py (which folds
# the totals into its last_phase_seconds) and by tools/. Overwritten per
# call, never merged.
last_pack_stats: dict[str, float] = {}


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest m >= n with m % multiple == 0 (shard-evenly helper)."""
    return ((n + multiple - 1) // multiple) * multiple


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


@dataclass
class NeighborBucket:
    """Rows whose degree rounds up to the same power-of-two width.

    ``rows`` holds global row ids per slot (``-1`` for pad slots added to
    make the slot count divisible by the sharding/chunking granule)."""

    rows: np.ndarray  # [n] int32 global row ids, -1 = pad slot
    idx: np.ndarray  # [n, D] int32 col indices into the other side
    val: np.ndarray  # [n, D] float32 rating values (0 where padded)
    deg: np.ndarray  # [n] int32 real entries per slot (0 for pad slots);
    #   entries fill positions 0..deg-1, so the [n, D] validity mask is
    #   exactly (iota < deg) and never needs to be materialized — a third
    #   of the bucket bytes on host AND device at scale
    chunk: int  # rows per sweep step (n is a multiple of chunk*shards)

    @property
    def width(self) -> int:
        return self.idx.shape[1]

    @property
    def num_slots(self) -> int:
        return self.idx.shape[0]


@dataclass(frozen=True)
class PackingOptions:
    """Knobs for the sharded packing engine (``oryx.ml.als.packing.*``).

    ``workers``: ``"auto"`` (one worker per core, capped at 8, in-process
    when the input is small or the host has one core) or an explicit
    count; ``<= 1`` forces the in-process path.
    ``chunk_rows``: COO entries per streamed chunk during counting and
    shard selection — bounds the transient footprint of a pass over the
    input.
    ``shm_budget_mb``: ceiling on the shared-memory arena for the
    multi-process path; a pack whose output arena would exceed it falls
    back to the in-process path with a warning instead of failing (or
    filling a small /dev/shm).
    ``worker_timeout_sec``: per-pack deadline for the worker pool; on
    expiry workers are terminated and the pack raises instead of hanging.
    """

    workers: "int | str" = "auto"
    chunk_rows: int = 8_000_000
    shm_budget_mb: int = 8192
    worker_timeout_sec: float = 900.0

    def resolve_workers(self, nnz: int, num_rows: int) -> int:
        if isinstance(self.workers, str):
            if self.workers != "auto":
                raise ValueError(
                    f"packing workers must be 'auto' or an int, got {self.workers!r}"
                )
            w = min(os.cpu_count() or 1, 8)
            if nnz < _MIN_PARALLEL_NNZ:
                w = 1
        else:
            w = int(self.workers)
        # one worker per row at most; empty shards are legal but useless
        return max(1, min(w, max(1, num_rows)))


def bucket_geometry(
    num_real_rows: int,
    width: int,
    num_shards: int,
    workspace_elems: int,
    features: int,
    stable_shapes: bool,
) -> tuple[int, int]:
    """(padded slot count, chunk) for one bucket — shared by both packing
    paths so shape signatures (and the compile cache they key) never
    depend on which path packed the bucket.

    The chunk size keeps the [chunk, D, k] gather workspace under
    ``workspace_elems`` elements; ``stable_shapes`` rounds the slot count
    to a power of two so consecutive generations of a growing
    factorization reuse the compiled sweep (see ops/als.py)."""
    chunk = max(1, workspace_elems // (width * max(features, 1)))
    chunk = 1 << (chunk.bit_length() - 1)  # floor to power of two
    chunk = min(chunk, 1 << 16)
    if stable_shapes and num_shards & (num_shards - 1) == 0:
        # pow2 slot count: a multiple of chunk*num_shards for free
        # (all three are powers of two and n >= num_shards*chunk')
        n = _pow2_at_least(max(num_real_rows, num_shards))
        chunk = min(chunk, n // num_shards)
    else:
        granule = chunk * num_shards
        n = pad_to_multiple(num_real_rows, granule)
        # shrink chunk when padding to the granule would more than
        # double the bucket (tiny buckets shouldn't pay a 65536-row pad)
        while chunk > 1 and n >= 2 * max(1, num_real_rows):
            chunk //= 2
            granule = chunk * num_shards
            n = pad_to_multiple(num_real_rows, granule)
    return n, chunk


def row_widths(counts: np.ndarray, min_width: int) -> np.ndarray:
    """Power-of-two bucket width per row (>= min_width); log2 of an exact
    power of two is exact in float64, so the ceil is safe."""
    safe = np.maximum(counts, 1)
    return np.maximum(
        min_width, (2 ** np.ceil(np.log2(safe)).astype(np.int64)).astype(np.int64)
    )


def build_neighbor_buckets_reference(
    row_idx: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    num_rows: int,
    num_shards: int = 1,
    min_width: int = 8,
    workspace_elems: int = 1 << 27,
    features: int = 50,
    stable_shapes: bool = True,
) -> list[NeighborBucket]:
    """Single-process composite-key pack (the original path).

    Rows with no ratings appear in no bucket (their factors stay zero,
    matching the rectangle path where an all-masked row solves to the
    zero vector). One stable sort by (bucket width, row) makes every
    bucket a contiguous slice of the sorted arrays; the stable sort also
    preserves arrival order within each row. Kept verbatim as the
    equivalence oracle for the sharded engine."""
    row_idx = np.asarray(row_idx)
    col_idx = np.asarray(col_idx)
    values = np.asarray(values)
    nnz = len(row_idx)
    if not num_rows or not nnz:
        return []
    counts = np.bincount(row_idx, minlength=num_rows)
    widths = row_widths(counts, min_width)

    wcode = np.log2(widths).astype(np.int64)  # [num_rows], values < 40
    key = (wcode[row_idx] << 40) | row_idx.astype(np.int64)
    order = np.argsort(key, kind="stable")
    del key
    r = row_idx[order]
    c = col_idx[order]
    v = values[order]
    del order

    # row-run boundaries in sorted order -> per-entry position within row
    bounds = np.flatnonzero(np.r_[True, r[1:] != r[:-1]]).astype(np.int64)
    row_start = np.zeros(nnz, dtype=np.int64)
    row_start[bounds] = bounds
    np.maximum.accumulate(row_start, out=row_start)
    pos = (np.arange(nnz, dtype=np.int64) - row_start).astype(np.int32)
    del row_start

    # bucket slice boundaries: wcode is non-decreasing along the sort
    codes_present = np.unique(wcode[r[bounds]])
    code_of_bound = wcode[r[bounds]]
    buckets: list[NeighborBucket] = []
    for code in codes_present.tolist():
        w = 1 << int(code)
        b_lo, b_hi = np.searchsorted(code_of_bound, [code, code + 1])
        first_bounds = bounds[b_lo:b_hi]  # entry offset of each row's run
        lo = int(first_bounds[0])
        hi = int(bounds[b_hi]) if b_hi < len(bounds) else nnz
        rows_w = r[first_bounds].astype(np.int32)
        counts_w = np.diff(np.r_[first_bounds, hi]).astype(np.int32)
        n, chunk = bucket_geometry(
            len(rows_w), w, num_shards, workspace_elems, features, stable_shapes
        )
        rows = np.full(n, -1, dtype=np.int32)
        rows[: len(rows_w)] = rows_w
        deg = np.zeros(n, dtype=np.int32)
        deg[: len(rows_w)] = counts_w
        # slot index per entry: which row-run of this bucket it belongs to
        slot = np.repeat(
            np.arange(len(rows_w), dtype=np.int64), counts_w.astype(np.int64)
        )
        flat = slot * w + pos[lo:hi]
        del slot
        idx = np.zeros(n * w, dtype=np.int32)
        idx[flat] = c[lo:hi]
        val = np.zeros(n * w, dtype=np.float32)
        val[flat] = v[lo:hi]
        del flat
        buckets.append(
            NeighborBucket(rows, idx.reshape(n, w), val.reshape(n, w), deg, chunk)
        )
    return buckets


# ---------------------------------------------------------------------------
# Sharded engine
# ---------------------------------------------------------------------------


# Segments whose close() failed because numpy views still referenced the
# buffer when their arena was collected (gc order within a cycle is
# arbitrary). Holding them here silences SharedMemory.__del__ (which
# would re-raise the BufferError as an unraisable warning); the next pack
# call — or interpreter exit — sweeps them once the views are gone. The
# names are already unlinked, so at worst the mapping lives until exit.
_pending_close: list[shared_memory.SharedMemory] = []


def _sweep_pending_segments():
    still = []
    for shm in _pending_close:
        try:
            shm.close()
        except (BufferError, OSError):
            still.append(shm)
    _pending_close[:] = still


import atexit  # noqa: E402

atexit.register(_sweep_pending_segments)


class _ShmArena:
    """Owns the shared-memory segments backing one pack's bucket arrays.

    The segments are unlinked as soon as the workers have joined (the
    name disappears from /dev/shm; the parent's mapping — and therefore
    every bucket view — stays valid), and closed when the arena is
    garbage collected. Buckets keep a reference to their arena, so the
    mapping lives exactly as long as the buckets built from it; a segment
    whose views are still live at that point (collection order is not
    ours to pick) parks in ``_pending_close`` for the next sweep."""

    def __init__(self, segments: list[shared_memory.SharedMemory]):
        self._segments = segments
        self._finalizer = weakref.finalize(self, _ShmArena._close_all, segments)

    @staticmethod
    def _close_all(segments):
        for shm in segments:
            try:
                shm.close()
            except (BufferError, OSError):
                _pending_close.append(shm)

    def unlink(self):
        for shm in self._segments:
            with contextlib.suppress(FileNotFoundError):
                shm.unlink()


def _streamed_counts(row_idx, num_rows, chunk_rows):
    counts = np.zeros(num_rows, dtype=np.int64)
    for a in range(0, len(row_idx), chunk_rows):
        counts += np.bincount(row_idx[a : a + chunk_rows], minlength=num_rows)
    return counts


def _plan(row_idx, num_rows, num_shards, min_width, workspace_elems, features,
          stable_shapes, chunk_rows):
    """Row-level plan: per-row destination bases plus per-bucket geometry.

    Everything here is O(num_rows) (plus one streamed counting pass over
    the entries) and runs in the parent; workers only ever touch
    entry-level work."""
    counts = _streamed_counts(row_idx, num_rows, chunk_rows)
    widths = row_widths(counts, min_width)
    wcode = np.log2(widths).astype(np.int64)
    nz_rows = np.flatnonzero(counts > 0).astype(np.int64)
    codes = np.unique(wcode[nz_rows])
    cidx = np.searchsorted(codes, wcode).astype(np.uint8)  # [num_rows]
    # slot of a row = its rank among same-code rows, row-ascending —
    # exactly the order the reference path's (code, row) sort yields
    order_c = np.argsort(cidx[nz_rows], kind="stable")
    rows_per_code = np.bincount(cidx[nz_rows], minlength=len(codes)).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(rows_per_code)[:-1]])
    slot = np.full(num_rows, -1, dtype=np.int64)
    slot[nz_rows[order_c]] = np.arange(len(nz_rows), dtype=np.int64) - np.repeat(
        starts, rows_per_code
    )
    del order_c

    geos = [
        bucket_geometry(
            int(rows_per_code[ci]), 1 << int(code), num_shards,
            workspace_elems, features, stable_shapes,
        )
        for ci, code in enumerate(codes.tolist())
    ]
    elems = np.array(
        [n * (1 << int(code)) for (n, _), code in zip(geos, codes.tolist())],
        dtype=np.int64,
    )
    bases = np.concatenate([[0], np.cumsum(elems)[:-1]]).astype(np.int64)
    # flat arena destination of each row's first entry; entry j of the
    # row lands at dest0[row] + j
    dest0 = bases[cidx] + slot * widths
    return counts, cidx, nz_rows, codes, slot, geos, bases, int(elems.sum()), dest0


def _shard_bounds(counts, workers):
    """Contiguous row ranges balanced by entry count (prefix-sum cuts)."""
    num_rows = len(counts)
    if workers <= 1 or num_rows <= 1:
        return np.array([0, num_rows], dtype=np.int64)
    csum = np.cumsum(counts)
    total = int(csum[-1])
    targets = (np.arange(1, workers, dtype=np.int64) * total) // workers
    cuts = np.searchsorted(csum, targets, side="left") + 1
    return np.unique(np.concatenate([[0], cuts, [num_rows]])).astype(np.int64)


def _pack_range(
    row_idx, col_idx, values, lo, hi, dest0, idx_flat, val_flat, chunk_rows,
    select, stats,
):
    """Pack every entry whose row falls in [lo, hi) into the arena.

    Entry-level core shared by the in-process and worker paths. Sorts the
    range's entries by row with radix-friendly 16-bit keys (global block
    id, then row-within-block), computes per-entry arrival positions from
    the row runs, and scatters column ids / values to
    ``dest0[row] + position`` in one flat pass. ``select=False`` skips
    the membership scan when the range covers every row."""
    nnz = len(row_idx)
    t0 = time.perf_counter()
    if select:
        parts = []
        for a in range(0, nnz, chunk_rows):
            r = row_idx[a : a + chunk_rows]
            m = (r >= lo) & (r < hi)
            parts.append((np.flatnonzero(m) + a).astype(np.int64))
        sel64 = np.concatenate(parts) if parts else np.empty(0, np.int64)
        del parts
        sel = sel64.astype(np.int32) if nnz < 2**31 else sel64
        del sel64
        if not len(sel):
            stats += [time.perf_counter() - t0, 0.0, 0.0, 0.0]
            return
        loc = row_idx[sel]
        t1 = time.perf_counter()
        hi16 = (loc >> _BLOCK_BITS).astype(np.uint16)
        order1 = np.argsort(hi16, kind="stable")
        del hi16
        sel = sel[order1]
        loc = loc[order1]
        del order1
    else:
        t1 = t0
        hi16 = (row_idx >> _BLOCK_BITS).astype(np.uint16)
        order1 = np.argsort(hi16, kind="stable")
        del hi16
        sel = order1.astype(np.int32) if nnz < 2**31 else order1
        del order1
        loc = row_idx[sel]
    m = len(sel)
    # refine within each 65536-row block: keys fit uint16 -> radix
    first_block = int(loc[0]) >> _BLOCK_BITS
    last_block = int(loc[-1]) >> _BLOCK_BITS
    if last_block > first_block:
        marks = np.arange(first_block + 1, last_block + 1, dtype=np.int64) << _BLOCK_BITS
        edges = np.searchsorted(loc, marks)
        edges = np.concatenate([[0], edges, [m]])
    else:
        edges = np.array([0, m], dtype=np.int64)
    for b in range(len(edges) - 1):
        s0, s1 = int(edges[b]), int(edges[b + 1])
        if s1 - s0 <= 1:
            continue
        low = (loc[s0:s1] & (_BLOCK - 1)).astype(np.uint16)
        o2 = np.argsort(low, kind="stable")
        del low
        sel[s0:s1] = sel[s0:s1][o2]
        loc[s0:s1] = loc[s0:s1][o2]
        del o2
    t2 = time.perf_counter()

    # per-entry arrival position within its row, from run boundaries
    bnd = np.flatnonzero(np.r_[True, loc[1:] != loc[:-1]])
    run_start = np.zeros(m, dtype=np.int64 if m >= 2**31 else np.int32)
    run_start[bnd] = bnd.astype(run_start.dtype)
    np.maximum.accumulate(run_start, out=run_start)
    del bnd
    dest = dest0[loc]
    dest += np.arange(m, dtype=np.int64)
    dest -= run_start.astype(np.int64)
    del run_start, loc
    t3 = time.perf_counter()

    idx_flat[dest] = col_idx[sel]
    val_flat[dest] = values[sel]
    del dest, sel
    t4 = time.perf_counter()
    stats += [t1 - t0, t2 - t1, t3 - t2, t4 - t3]


def _worker_main(shard, lo, hi, row_idx, col_idx, values, dest0, idx_flat,
                 val_flat, chunk_rows, stats_arr):
    """Worker process entry point (fork: all array args are inherited
    copy-on-write; idx/val/stats views are shared mappings)."""
    stats: list[float] = []
    _pack_range(
        row_idx, col_idx, values, lo, hi, dest0, idx_flat, val_flat,
        chunk_rows, True, stats,
    )
    stats_arr[shard, : len(stats)] = stats


def _assemble(codes, geos, bases, counts, cidx, nz_rows, slot, idx_flat,
              val_flat, arena):
    buckets = []
    for ci in range(len(codes)):
        n, chunk = geos[ci]
        w = 1 << int(codes[ci])
        rows_c = np.full(n, -1, dtype=np.int32)
        deg_c = np.zeros(n, dtype=np.int32)
        rc = nz_rows[cidx[nz_rows] == ci]
        s = slot[rc]
        rows_c[s] = rc.astype(np.int32)
        deg_c[s] = counts[rc].astype(np.int32)
        b0 = int(bases[ci])
        bucket = NeighborBucket(
            rows_c,
            idx_flat[b0 : b0 + n * w].reshape(n, w),
            val_flat[b0 : b0 + n * w].reshape(n, w),
            deg_c,
            chunk,
        )
        if arena is not None:
            # keep the shared mapping alive exactly as long as its views
            bucket._arena = arena  # type: ignore[attr-defined]
        buckets.append(bucket)
    return buckets


def pack_neighbor_buckets(
    row_idx: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    num_rows: int,
    num_shards: int = 1,
    min_width: int = 8,
    workspace_elems: int = 1 << 27,
    features: int = 50,
    stable_shapes: bool = True,
    options: Optional[PackingOptions] = None,
) -> list[NeighborBucket]:
    """Sharded packing engine; bit-identical to the reference path.

    Resolves the worker count from ``options`` (in-process below
    ``_MIN_PARALLEL_NNZ`` entries or on one core), packs each contiguous
    row range into a preallocated flat arena, and assembles buckets as
    zero-copy views. See the module docstring for the layout/determinism
    contract and ``last_pack_stats`` for per-phase wall seconds."""
    row_idx = np.asarray(row_idx)
    col_idx = np.asarray(col_idx)
    values = np.asarray(values)
    nnz = len(row_idx)
    last_pack_stats.clear()
    _sweep_pending_segments()
    if not num_rows or not nnz:
        return []
    opts = options or PackingOptions()
    workers = opts.resolve_workers(nnz, num_rows)

    t0 = time.perf_counter()
    counts, cidx, nz_rows, codes, slot, geos, bases, total_elems, dest0 = _plan(
        row_idx, num_rows, num_shards, min_width, workspace_elems, features,
        stable_shapes, opts.chunk_rows,
    )
    t_plan = time.perf_counter() - t0

    arena_bytes = total_elems * 8  # int32 idx + float32 val
    if workers > 1 and arena_bytes > opts.shm_budget_mb * (1 << 20):
        logger.warning(
            "packing arena (%.0f MB) exceeds oryx.ml.als.packing shared-mem "
            "budget (%d MB); falling back to in-process packing",
            arena_bytes / (1 << 20), opts.shm_budget_mb,
        )
        workers = 1

    arena = None
    t0 = time.perf_counter()
    if workers > 1:
        try:
            seg_idx = shared_memory.SharedMemory(create=True, size=max(1, total_elems * 4))
            seg_val = shared_memory.SharedMemory(create=True, size=max(1, total_elems * 4))
            seg_stats = shared_memory.SharedMemory(create=True, size=max(1, workers * 4 * 8))
        except OSError as e:
            logger.warning(
                "shared-memory allocation failed (%s); falling back to "
                "in-process packing", e,
            )
            workers = 1
        else:
            arena = _ShmArena([seg_idx, seg_val, seg_stats])
            idx_flat = np.frombuffer(seg_idx.buf, dtype=np.int32, count=total_elems)
            val_flat = np.frombuffer(seg_val.buf, dtype=np.float32, count=total_elems)
            stats_arr = np.frombuffer(seg_stats.buf, dtype=np.float64).reshape(workers, 4)
    if workers == 1:
        idx_flat = np.zeros(total_elems, dtype=np.int32)
        val_flat = np.zeros(total_elems, dtype=np.float32)
        stats_arr = np.zeros((1, 4), dtype=np.float64)
    t_alloc = time.perf_counter() - t0

    t0 = time.perf_counter()
    if workers == 1:
        stats: list[float] = []
        _pack_range(
            row_idx, col_idx, values, 0, num_rows, dest0, idx_flat, val_flat,
            opts.chunk_rows, False, stats,
        )
        stats_arr[0, : len(stats)] = stats
    else:
        bounds = _shard_bounds(counts, workers)
        ctx = get_context("fork")
        procs = []
        for s in range(len(bounds) - 1):
            p = ctx.Process(
                target=_worker_main,
                args=(
                    s, int(bounds[s]), int(bounds[s + 1]), row_idx, col_idx,
                    values, dest0, idx_flat, val_flat, opts.chunk_rows,
                    stats_arr,
                ),
                daemon=True,
            )
            p.start()
            procs.append(p)
        deadline = time.monotonic() + opts.worker_timeout_sec
        failed = None
        try:
            pending = list(enumerate(procs))
            while pending and failed is None:
                still = []
                for s, p in pending:
                    p.join(timeout=0.05)
                    if p.exitcode is None:
                        still.append((s, p))
                    elif p.exitcode != 0:
                        failed = (s, p.exitcode)
                        break
                pending = still
                if pending and time.monotonic() > deadline:
                    failed = (pending[0][0], "timeout")
                    break
        finally:
            if failed is not None:
                for p in procs:
                    if p.exitcode is None:
                        p.terminate()
            for p in procs:
                p.join(timeout=5.0)
        if arena is not None:
            arena.unlink()
        if failed is not None:
            s, what = failed
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            raise RuntimeError(
                f"packing worker {s} (rows [{lo}, {hi})) "
                + (
                    "timed out"
                    if what == "timeout"
                    else f"exited with code {what}"
                )
                + "; all workers terminated"
            )
    t_pack = time.perf_counter() - t0

    t0 = time.perf_counter()
    buckets = _assemble(
        codes, geos, bases, counts, cidx, nz_rows, slot, idx_flat, val_flat,
        arena,
    )
    t_fill = time.perf_counter() - t0

    sel_s, sort_s, pos_s, scat_s = (float(x) for x in stats_arr.sum(axis=0))
    last_pack_stats.update(
        workers=float(workers),
        plan=t_plan,
        alloc=t_alloc,
        select=sel_s,
        sort=sort_s,
        position=pos_s,
        scatter=scat_s,
        pack_wall=t_pack,
        fill=t_fill,
        total=t_plan + t_alloc + t_pack + t_fill,
    )
    return buckets
