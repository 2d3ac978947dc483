"""IVF approximate-retrieval tier for the serving scan (counterpart of
``oryx_tpu/ops/ivf.py``).

The exact int8 scan streams every item per query, which caps one card
near a few million items. The IVF tier clusters the catalog and scans
only the cells a query probes:

1. **Coarse quantizer**: round(sqrt(n)) cells trained on a sample by the
   port's ``ops/kmeans.py`` (k-means|| init, mini-batch Lloyd through the
   B3 sweep kernel); every item is then assigned to its nearest centroid
   by blocked float32 products and an argmin on the card.
2. **Cell-contiguous layout**: items are permuted so every cell occupies
   a contiguous, tile-aligned run of the exact scan's two-plane int8
   codes (the same per-row rules, ``streaming_topn._quantize_rows`` and
   ``_quantize_residual``, so an item's codes equal a fresh upload's).
   The primary plane is also kept item-major, so a probed run is one
   contiguous block. One all-padding guard tile closes the slot space.
3. **Routing**: queries dot the [feat, cells] centroid matrix and keep
   the top ``nprobe`` cells. Empty cells are masked to -inf first (the
   JAX package ranks them like any other, so a probe can be spent on a
   cell that holds nothing): a query still scans a superset of the
   occupied cells it would have probed.
4. **Probed scan and rescore**: a query group's probed cells union into
   a tile list; the union is gathered from the item-major plane, turned
   to float32 and multiplied by the group's queries in pieces of at most
   ``_PIECE_BYTES``, reduced to per-chunk maxes; each query's top chunks
   are rescored through ``streaming_topn.gathered_pair_scores`` and merged
   with the pending overlay. The routing result is the one host round
   trip of a batch (``COUNTS["route_syncs"]``).

With ``nprobe >= cells`` every live slot is a candidate in ascending item
id order (``_full_topk``): the two-plane score of every item, ties to the
lowest id.

Fold-ins (``update_rows``) tombstone an item's slot and put its
dequantized row in a pending overlay that every query scans exactly; a
full overlay spills its oldest entries to a host queue that
``compact_ivf`` folds back into the layout (``serving/maintain.py`` runs
it in the background).

All of this is PyTorch ops (XLA in the JAX package, no Pallas kernel);
the B3 sweep kernel runs inside ``train_kmeans``. Every float32 product
runs with TF32 off. ``HOST_STAGE1`` resolves on only for an index that
lives on the CPU: its probed scan then takes the numpy path over a
host-resident dequantized plane, as the JAX package does on its CPU
backend. The tiered host store (``attach_tiered_plane`` with a plane) is
not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch.device import full_float32, resolve
from oryx_tpu_torch.ops import streaming_topn as stn

# -- knobs (oryx.serving.scan.ann.*, pushed by ServingLayer) ------------------

# master switch for the serving tier (ops-level entry points work either way)
ANN_ENABLED = False
# coarse cells; 0 = auto round(sqrt(n))
N_CELLS = 0
# cells probed per query; 0 = derive from PROBE_FRACTION
NPROBE = 0
# fraction of cells a query probes when NPROBE is 0
PROBE_FRACTION = 0.01
# catalogs below this stay on the exact scan
MIN_ITEMS = 100_000
# pending-overlay rows (speed-layer updates between index rebuilds)
OVERLAY_CAPACITY = 4096
# queries per scan group: a group's probed-cell union shares one pass
QUERY_BLOCK = 8
# chunks per scan tile; cells pad to a tile multiple
TILE_CHUNKS = 8
# None = on only for an index on the CPU (numpy block-take + BLAS over a
# host-resident dequantized plane); True/False force the choice
HOST_STAGE1 = None

# rows assigned to centroids per product during build
_ASSIGN_BLOCK = 65536
# rows quantized and uploaded per slice during build (bounds the host
# transient at 10M+ items), quantized in pieces of _QUANTIZE_ROWS
_SLICE_ROWS = 1_000_000
_QUANTIZE_ROWS = 16_384
# float32 bytes of one piece of a group's stage-1 slab: a group whose
# union reaches the whole catalog walks it in pieces (per-chunk maxes do
# not change under the split)
_PIECE_BYTES = 1 << 28
# per-segment items of the full-probe rescore
_SEG_ITEMS = 8192

# batches by path, host round trips of the routing result, and the device
# path's query groups and stage-1 pieces
COUNTS = {"device": 0, "host": 0, "full": 0, "route_syncs": 0, "groups": 0, "pieces": 0}
# batches by the probe count they ran at (the overload ladder's
# reduced-probe rung shows up as a smaller nprobe)
NPROBE_COUNTS: dict[int, int] = {}
_counts_lock = threading.Lock()
# wall seconds of the most recent build_ivf, by stage (kmeans, assign,
# quantize, upload, layout); overwritten per build
last_build_seconds: dict[str, float] = {}


def _count(name: str) -> None:
    with _counts_lock:
        COUNTS[name] += 1


def reset_counts() -> None:
    with _counts_lock:
        for name in COUNTS:
            COUNTS[name] = 0
        NPROBE_COUNTS.clear()


def nprobe_counts() -> dict[int, int]:
    """Batches by probe count since the last ``reset_counts``."""
    with _counts_lock:
        return dict(NPROBE_COUNTS)


def counts() -> dict[str, int]:
    with _counts_lock:
        return dict(COUNTS)


def configure_ann(
    enabled=None,
    cells=None,
    nprobe=None,
    probe_fraction=None,
    min_items=None,
    overlay_capacity=None,
    query_block=None,
    tile_chunks=None,
    host_stage1=None,
):
    """Set the IVF defaults (config: oryx.serving.scan.ann.*); None
    leaves a knob unchanged. The host stage-1 plane only materializes at
    build time, so set ``host_stage1`` before building."""
    global ANN_ENABLED, N_CELLS, NPROBE, PROBE_FRACTION
    global MIN_ITEMS, OVERLAY_CAPACITY, QUERY_BLOCK, TILE_CHUNKS, HOST_STAGE1
    if enabled is not None:
        ANN_ENABLED = bool(enabled)
    if cells is not None:
        N_CELLS = int(cells)
    if nprobe is not None:
        NPROBE = int(nprobe)
    if probe_fraction is not None:
        PROBE_FRACTION = float(probe_fraction)
    if min_items is not None:
        MIN_ITEMS = int(min_items)
    if overlay_capacity is not None:
        OVERLAY_CAPACITY = int(overlay_capacity)
    if query_block is not None:
        QUERY_BLOCK = int(query_block)
    if tile_chunks is not None:
        TILE_CHUNKS = int(tile_chunks)
    if host_stage1 is not None:
        HOST_STAGE1 = bool(host_stage1)


def _host_stage1_active(device: torch.device) -> bool:
    if HOST_STAGE1 is not None:
        return HOST_STAGE1
    return device.type == "cpu"


def ann_active(n_items: int) -> bool:
    """Should the serving tier route this catalog through IVF?"""
    return ANN_ENABLED and n_items >= MIN_ITEMS


@dataclasses.dataclass(frozen=True, eq=False)
class IVFIndex:
    """Cell-contiguous two-plane int8 item matrix + routing table.

    Tensors are never written in place: ``update_rows`` returns a new
    handle (scans in flight may still read the old one). The host-side
    tables (``id_to_slot``, ``ov_map``, the spill queue) are bookkeeping
    for the update path, mutated in place under the caller's
    serialization (the serving model's cache lock), never read at query
    time.
    """

    # permuted, per-cell tile-padded planes in the exact scan's
    # feature-major layout; padding slots carry scale 1 / codes 0
    mat_t: torch.Tensor  # [kf_pad, n_slots] int8
    resid: torch.Tensor  # [kf_pad, n_slots] int8
    # item-major copy of the PRIMARY plane for the probed scan
    mat_rows: torch.Tensor  # [n_slots, kf_pad] int8
    scales: torch.Tensor  # [1, n_slots] f32
    resid_scales: torch.Tensor  # [1, n_slots] f32
    norms: torch.Tensor  # [1, n_slots] f32 (original f32 row norms)
    # slot -> original item id; -1 = padding or superseded by the overlay
    slot_ids: torch.Tensor  # [n_slots] int32
    # routing table
    centroids_t: torch.Tensor  # [kf_pad, n_cells] f32
    centroid_norms: torch.Tensor  # [n_cells] f32
    chunk_start: torch.Tensor  # [n_cells] int32, in chunk units
    chunk_count: torch.Tensor  # [n_cells] int32 (occupied chunks only)
    # pending overlay: dequantized rows of updated items, scanned exactly
    ov_rows: torch.Tensor  # [cap, kf_pad] f32
    ov_ids: torch.Tensor  # [cap] int32, -1 = empty
    ov_norms: torch.Tensor  # [cap] f32
    n_items: int
    features: int  # true feature count before int8 padding
    chunk: int  # items per candidate chunk (layout constant)
    tile_chunks: int  # chunks per scan tile (layout constant)
    # host-side routing/update bookkeeping
    chunk_count_host: np.ndarray  # [n_cells] int64
    tile_start_host: np.ndarray  # [n_cells] int64, in tile units
    tile_count_host: np.ndarray  # [n_cells] int64
    id_to_slot: np.ndarray  # [n_items at build] int32, -1 = overlay/none
    ov_map: dict  # item id -> overlay slot (dict order = age order)
    ov_used: int
    # host stage-1 mirrors (None when HOST_STAGE1 resolves off): the
    # dequantized two-plane f32 rows (q1*s1 + q2*s2)
    host_plane: np.ndarray | None = None  # [n_slots, kf_pad] f32
    slot_ids_host: np.ndarray | None = None  # [n_slots] int32
    norms_host: np.ndarray | None = None  # [n_slots] f32
    ov_rows_host: np.ndarray | None = None  # [cap, kf_pad] f32
    ov_ids_host: np.ndarray | None = None  # [cap] int32
    ov_norms_host: np.ndarray | None = None  # [cap] f32
    # RAW pre-quantization values of each overlay slot: compaction
    # requantizes from these, so compacted codes equal a fresh build's
    ov_raw_host: np.ndarray | None = None  # [cap, kf_pad] f32
    # item id -> fold-in wall-clock seconds (freshness accounting)
    ov_born: dict | None = None
    # overlay-overflow spill queue: item id -> (raw row [kf_pad] f32,
    # born seconds); invisible to queries until the next compaction
    pending_spill: dict | None = None

    @property
    def n_cells(self) -> int:
        return self.centroids_t.shape[1]

    @property
    def n_slots(self) -> int:
        return self.mat_t.shape[1]

    @property
    def device(self) -> torch.device:
        return self.mat_t.device

    def resolve_nprobe(self, nprobe: int | None = None) -> int:
        """Probed cells per query: explicit arg > NPROBE knob > fraction."""
        p = nprobe if nprobe is not None else NPROBE
        if not p:
            p = int(round(PROBE_FRACTION * self.n_cells))
        return max(1, min(int(p), self.n_cells))


# -- build --------------------------------------------------------------------


def _assign_cells(mat: np.ndarray, centers: np.ndarray, device) -> np.ndarray:
    """Nearest-centroid id per row (argmax of y.c - |c|^2/2, ties to the
    lowest cell) in blocks of float32 products on ``device``; one
    download at the end."""
    dev = resolve(device)
    n = len(mat)
    cent_t = torch.from_numpy(np.ascontiguousarray(centers.T, dtype=np.float32)).to(dev)
    half = 0.5 * np.einsum("kd,kd->k", centers, centers)[None, :]
    half = torch.from_numpy(half.astype(np.float32)).to(dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    for beg in range(0, n, _ASSIGN_BLOCK):
        blk = torch.from_numpy(np.ascontiguousarray(mat[beg : beg + _ASSIGN_BLOCK], np.float32))
        with full_float32():
            s = blk.to(dev) @ cent_t - half
        out[beg : beg + len(blk)] = torch.argmin(-s, dim=1).to(torch.int32)
    return out.cpu().numpy()


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _quantized_rows(mat: np.ndarray, beg: int, end: int, pool):
    """(q, s, q2, s2, norms) of rows [beg, end) by the exact scan's per-row
    rules, in pieces of _QUANTIZE_ROWS over ``pool``'s threads (numpy lets
    go of the GIL; small pieces reuse their temporaries instead of
    faulting in fresh pages); the result is the same."""

    def one(lo):
        sub = mat[lo : min(end, lo + _QUANTIZE_ROWS)]
        q, s = stn._quantize_rows(sub)
        q2, s2 = stn._quantize_residual(sub, q, s)
        return q, s, q2, s2, np.linalg.norm(sub, axis=1)

    starts = range(beg, end, _QUANTIZE_ROWS)
    parts = list(pool.map(one, starts) if pool is not None else map(one, starts))
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(5))


class _Timer:
    """Wall seconds by stage into ``last_build_seconds``."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}

    def add(self, stage: str, t0: float) -> float:
        t = time.perf_counter()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + t - t0
        return t

    def publish(self) -> None:
        last_build_seconds.clear()
        last_build_seconds.update(self.seconds)


def build_ivf(
    matrix: np.ndarray,
    *,
    n_cells: int | None = None,
    seed: int = 0,
    train_sample: int = 200_000,
    iterations: int = 8,
    overlay_capacity: int | None = None,
    centroids: np.ndarray | None = None,
    device=None,
) -> IVFIndex:
    """Cluster, permute cell-contiguous, quantize, and ship to ``device``.

    The coarse quantizer trains on a uniform sample (mini-batch Lloyd
    over k-means|| seeds); the whole catalog is then assigned to the
    trained centroids on the card. ``centroids`` [cells, feat] skips the
    training: the catalog lays out onto the given coarse quantizer, which
    is how a replica adopts a published index generation."""
    dev = resolve(device)
    timer = _Timer()
    t = time.perf_counter()
    mat = np.asarray(matrix, dtype=np.float32)
    n, feat = mat.shape
    if n == 0:
        raise ValueError("cannot build an IVF index over zero items")
    if centroids is not None:
        centers = np.ascontiguousarray(centroids, dtype=np.float32)[:, :feat]
    else:
        cells = int(n_cells if n_cells is not None else (N_CELLS or round(math.sqrt(n))))
        cells = max(1, min(cells, n))
        from oryx_tpu_torch.ops.kmeans import train_kmeans

        rng = np.random.default_rng(seed)
        sample = mat[rng.choice(n, train_sample, replace=False)] if n > train_sample else mat
        minibatch = 32_768 if len(sample) > 65_536 else None
        centers, _counts, _cost = train_kmeans(
            sample, cells, iterations=iterations, init="k-means||", seed=seed,
            minibatch_size=minibatch, device=dev,
        )
        centers = np.asarray(centers, dtype=np.float32)
        t = timer.add("kmeans", t)
    cell = _assign_cells(mat, centers, dev).astype(np.int64)
    timer.add("assign", t)
    workers = min(8, os.cpu_count() or 1)
    threaded = workers > 1 and n > _QUANTIZE_ROWS
    with ThreadPoolExecutor(workers) if threaded else contextlib.nullcontext() as pool:
        index = _assemble(
            None, cell, centers, lambda beg, end: _quantized_rows(mat, beg, end, pool),
            feat=feat, cap=_pow2_ceil(overlay_capacity or OVERLAY_CAPACITY), n_items=n,
            host1=_host_stage1_active(dev), device=dev, timer=timer,
        )
    timer.publish()
    return index


def _assemble(
    ids: np.ndarray | None,
    cell: np.ndarray,
    centers: np.ndarray,
    source,
    *,
    feat: int,
    cap: int,
    n_items: int,
    host1: bool,
    device: torch.device,
    timer: _Timer | None = None,
    chunk: int | None = None,
    tile_chunks: int | None = None,
) -> IVFIndex:
    """Lay rows out cell-contiguous and tile-aligned (``build_ivf``'s
    layout stage and ``_assemble_layout``). Row r of the input has item id
    ``ids[r]`` (``r`` when ids is None) and cell ``cell[r]``;
    ``source(beg, end)`` returns (q, s, q2, s2, norms) of rows [beg, end).
    Within a cell items order by ascending id (the exact path's tie
    direction). The planes are written item-major on the device, slice by
    slice of the input rows (each scattered to its slots), then transposed
    there."""
    timer = timer or _Timer()
    t = time.perf_counter()
    chunk = chunk or max(8, int(stn._CHUNK))
    tile_chunks = tile_chunks or max(1, TILE_CHUNKS)
    tile_slots = tile_chunks * chunk
    n = len(cell)
    cells = len(centers)
    if ids is None:
        ids = np.arange(n, dtype=np.int64)
        order = np.argsort(cell, kind="stable")
    else:
        order = np.lexsort((ids, cell))  # cell-major, ascending id within
    counts = np.bincount(cell, minlength=cells).astype(np.int64)
    chunk_counts = -(-counts // chunk)  # occupied chunks; empty cells keep 0
    tile_counts = -(-chunk_counts // tile_chunks)
    spans = tile_counts * tile_slots
    item_starts = np.zeros(cells + 1, np.int64)
    np.cumsum(counts, out=item_starts[1:])
    slot_base = np.zeros(cells + 1, np.int64)
    np.cumsum(spans, out=slot_base[1:])
    # +1 guard tile: the all-padding landing zone for starved selections
    n_slots = int(slot_base[-1]) + tile_slots
    pos_in_cell = np.arange(n, dtype=np.int64) - np.repeat(item_starts[:-1], counts)
    slot_of_row = np.empty(n, np.int64)
    slot_of_row[order] = np.repeat(slot_base[:-1], counts) + pos_in_cell

    kf_pad = stn._ceil_to(feat, stn._INT8_FEAT_MULTIPLE)
    slot_ids = np.full(n_slots, -1, np.int32)
    slot_ids[slot_of_row] = ids
    id_to_slot = np.full(n_items, -1, np.int32)
    id_to_slot[ids] = slot_of_row.astype(np.int32)
    host_plane = np.zeros((n_slots, kf_pad), np.float32) if host1 else None
    norms_host = np.zeros(n_slots, np.float32)
    rows1 = torch.zeros((n_slots, kf_pad), dtype=torch.int8, device=device)
    rows2 = torch.zeros((n_slots, kf_pad), dtype=torch.int8, device=device)
    scales = torch.ones((1, n_slots), dtype=torch.float32, device=device)
    rscales = torch.ones((1, n_slots), dtype=torch.float32, device=device)
    t = timer.add("layout", t)
    for beg in range(0, n, _SLICE_ROWS):
        end = min(n, beg + _SLICE_ROWS)
        sl = slot_of_row[beg:end]
        q, s, q2, s2, nv = source(beg, end)
        q, q2 = q[:, :feat], q2[:, :feat]
        norms_host[sl] = nv
        if host_plane is not None:
            host_plane[sl, :feat] = (
                q.astype(np.float32) * s[:, None] + q2.astype(np.float32) * s2[:, None]
            )
        t = timer.add("quantize", t)
        sl_t = torch.from_numpy(sl).to(device)
        q_t = torch.from_numpy(np.ascontiguousarray(q)).to(device)
        q2_t = torch.from_numpy(np.ascontiguousarray(q2)).to(device)
        s_t = torch.from_numpy(np.ascontiguousarray(s, np.float32)).to(device)
        s2_t = torch.from_numpy(np.ascontiguousarray(s2, np.float32)).to(device)
        t = timer.add("upload", t)
        rows1[sl_t, :feat] = q_t
        rows2[sl_t, :feat] = q2_t
        scales[0, sl_t] = s_t
        rscales[0, sl_t] = s2_t
        t = timer.add("layout", t)
    resid = rows2.t().contiguous()
    del rows2
    mat_t = rows1.t().contiguous()
    cent_t = np.zeros((kf_pad, cells), np.float32)
    cent_t[:feat] = centers.T

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    index = IVFIndex(
        mat_t=mat_t,
        resid=resid,
        mat_rows=rows1,
        scales=scales,
        resid_scales=rscales,
        norms=put(norms_host[None, :]),
        slot_ids=put(slot_ids),
        centroids_t=put(cent_t),
        centroid_norms=put(np.linalg.norm(centers, axis=1).astype(np.float32)),
        chunk_start=put((slot_base[:-1] // chunk).astype(np.int32)),
        chunk_count=put(chunk_counts.astype(np.int32)),
        ov_rows=torch.zeros((cap, kf_pad), dtype=torch.float32, device=device),
        ov_ids=torch.full((cap,), -1, dtype=torch.int32, device=device),
        ov_norms=torch.zeros((cap,), dtype=torch.float32, device=device),
        n_items=n_items,
        features=feat,
        chunk=chunk,
        tile_chunks=tile_chunks,
        chunk_count_host=chunk_counts,
        tile_start_host=slot_base[:-1] // tile_slots,
        tile_count_host=tile_counts,
        id_to_slot=id_to_slot,
        ov_map={},
        ov_used=0,
        host_plane=host_plane,
        slot_ids_host=slot_ids.copy() if host1 else None,
        norms_host=norms_host if host1 else None,
        ov_rows_host=np.zeros((cap, kf_pad), np.float32) if host1 else None,
        ov_ids_host=np.full((cap,), -1, np.int32) if host1 else None,
        ov_norms_host=np.zeros((cap,), np.float32) if host1 else None,
        ov_raw_host=np.zeros((cap, kf_pad), np.float32),
        ov_born={},
        pending_spill={},
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the layout's device work ends here
    timer.add("layout", t)
    return index


# -- query: routing -----------------------------------------------------------


def _route_cells(index: IVFIndex, q: torch.Tensor, nprobe: int, cosine: bool) -> torch.Tensor:
    """[b, nprobe] probed cells by centroid dot (cosine: over centroid
    norms, |q| being constant per row), empty cells at -inf, ties to the
    lowest cell."""
    with full_float32():
        route = q @ index.centroids_t
    if cosine:
        route = route / torch.clamp_min(index.centroid_norms[None, :], 1e-12)
    route = torch.where(index.chunk_count[None, :] > 0, route, -math.inf)
    return stn._stable_topk(route, nprobe)[1]


def _group_tile_lists(index: IVFIndex, cells_np: np.ndarray, g: int):
    """Union each query group's probed cells into ragged tile lists.

    Scanning the union instead of per-query lists keeps the scan dense:
    a query only ever sees EXTRA cells, never fewer."""
    b = cells_np.shape[0]
    groups = -(-b // g)
    per_group = []
    for gi in range(groups):
        uc = np.unique(cells_np[gi * g : (gi + 1) * g].ravel())
        uc = uc[index.tile_count_host[uc] > 0]  # empty cells contribute no tiles
        cnt = index.tile_count_host[uc]
        starts = index.tile_start_host[uc]
        total = int(cnt.sum())
        if total == 0:
            per_group.append(np.empty(0, np.int64))
            continue
        # ragged [start, start+cnt) ranges flattened in one vector op
        base = np.repeat(starts, cnt)
        cum = np.zeros(len(uc) + 1, np.int64)
        np.cumsum(cnt, out=cum[1:])
        per_group.append(base + (np.arange(total) - np.repeat(cum[:-1], cnt)))
    return per_group


# -- query: host stage-1 path (an index on the CPU) ---------------------------


def _host_topk(index: IVFIndex, qpad: np.ndarray, cells: np.ndarray, k: int, cosine: bool):
    """Probed scan over the host-resident dequantized f32 plane: per query
    group one block-take of the probed tiles, one BLAS product, then a
    per-query (score desc, id asc) selection. The plane holds two-plane
    dequantized values, so the ranking scores are the final scores.
    Returns host (vals [n, k] f32, ids [n, k] int32)."""
    n, kf = qpad.shape
    kk = max(1, int(k))
    g = max(1, min(QUERY_BLOCK, n))
    order = np.argsort(cells[:, 0], kind="stable")
    lists = _group_tile_lists(index, cells[order], g)
    ts = index.tile_chunks * index.chunk
    n_tiles = index.n_slots // ts
    plane3 = index.host_plane.reshape(n_tiles, ts, kf)
    sids3 = index.slot_ids_host.reshape(n_tiles, ts)
    norms3 = index.norms_host.reshape(n_tiles, ts)
    used = index.ov_used
    qn = np.linalg.norm(qpad, axis=1) if cosine else None
    if used:
        ov_sc = qpad @ index.ov_rows_host[:used].T  # [n, used] exact
        if cosine:
            ov_sc = ov_sc / np.maximum(index.ov_norms_host[None, :used] * qn[:, None], 1e-12)
        ov_ids = index.ov_ids_host[:used].astype(np.int64)
    out_v = np.full((n, kk), -np.inf, np.float32)
    out_i = np.full((n, kk), -1, np.int32)
    for gi, tl in enumerate(lists):
        rows = order[gi * g : (gi + 1) * g]
        qg = qpad[rows]
        if len(tl):
            slab = plane3[tl].reshape(-1, kf)  # contiguous block take
            sc = slab @ qg.T  # [S, group] final-precision scores
            ssid = sids3[tl].reshape(-1).astype(np.int64)
            if cosine:
                nr = norms3[tl].reshape(-1)
                sc = sc / np.maximum(nr[:, None] * qn[rows][None, :], 1e-12)
            sc[ssid < 0, :] = -np.inf  # padding + tombstoned slots
        else:  # every probed cell was empty: overlay-only candidates
            sc = np.empty((0, len(rows)), np.float32)
            ssid = np.empty(0, np.int64)
        kp = min(kk, sc.shape[0])
        if kp and sc.shape[0] > kp:
            part = np.argpartition(-sc, kp - 1, axis=0)[:kp]  # [kp, group]
        else:
            part = np.broadcast_to(np.arange(sc.shape[0])[:, None], (sc.shape[0], len(rows)))
        for j, qi in enumerate(rows):
            pv = sc[part[:, j], j]
            pi = ssid[part[:, j]]
            if used:
                pv = np.concatenate([pv, ov_sc[qi]])
                pi = np.concatenate([pi, ov_ids])
            if not len(pv):
                continue
            # score desc, item id asc: the exact path's tie direction
            o = np.lexsort((pi, -pv))[:kk]
            pv, pi = pv[o], pi[o]
            fin = np.isfinite(pv)
            out_v[qi, : len(pv)] = np.where(fin, pv, -np.inf)
            out_i[qi, : len(pv)] = np.where(fin, pi, -1).astype(np.int32)
    return out_v, out_i


# -- query: probed scan + rescore on the device --------------------------------


def _merge_overlay(sc, sid, q, qn, ov, k: int, cosine: bool):
    """The final top-k of the scan's candidates (scores [g, m], ids) and
    the pending overlay's exact float32 scores; starved windows pad with
    id -1 and -inf."""
    ov_rows, ov_ids, ov_norms = ov
    with full_float32():
        osc = q @ ov_rows.T
    if cosine:
        osc = osc / torch.clamp_min(ov_norms[None, :] * qn, 1e-12)
    osc = torch.where(ov_ids[None, :] >= 0, osc, -math.inf)
    allv = torch.cat([sc, osc], dim=1)
    alli = torch.cat([sid, ov_ids[None, :].expand(q.shape[0], -1)], dim=1)
    ke = min(k, allv.shape[1])
    v, p = stn._stable_topk(allv, ke)
    ids = torch.gather(alli, 1, p)
    ids = torch.where(torch.isfinite(v), ids, -1)
    if ke < k:
        v = torch.nn.functional.pad(v, (0, k - ke), value=-math.inf)
        ids = torch.nn.functional.pad(ids, (0, k - ke), value=-1)
    return v, ids.to(torch.int32)


def _probe_topk(index: IVFIndex, q: torch.Tensor, tiles: torch.Tensor, e_pad: int, k: int,
                cosine: bool, ov):
    """One query group [g, kf] over its probed tiles [E] -> (vals, ids)
    [g, k].

    Stage 1 is the chunk-max ranking restricted to the probed tiles: the
    union gathers from the item-major primary plane as contiguous blocks,
    converts to float32 and meets the group's queries in one product per
    piece of at most _PIECE_BYTES, reduced to per-chunk maxes. Stage 2
    takes each query's top ``kc`` chunks (``e_pad`` is the list's
    power-of-two bucket, which sets kc as in the JAX package) and rescores
    their items through the two-plane epilogue, then merges the overlay."""
    chunk, tile = index.chunk, index.tile_chunks
    ts = tile * chunk
    kf = index.mat_rows.shape[1]
    n_tiles = index.n_slots // ts
    guard_chunk = index.n_slots // chunk - 1  # inside the guard tile: all masked
    rows3 = index.mat_rows.view(n_tiles, ts, kf)
    scales_t = index.scales.view(n_tiles, ts)
    sids_t = index.slot_ids.view(n_tiles, ts)
    norms_t = index.norms.view(n_tiles, ts)
    g = q.shape[0]
    qn = torch.linalg.vector_norm(q, dim=1, keepdim=True) if cosine else None
    per = max(1, _PIECE_BYTES // (ts * kf * 4))
    maxes = []
    _count("groups")
    for beg in range(0, tiles.shape[0], per):
        _count("pieces")
        tl = tiles[beg : beg + per]
        slab = rows3.index_select(0, tl).reshape(-1, kf).float()
        with full_float32():
            sc = slab @ q.T  # [P*ts, g] plane-1 ranking scores
        sc = sc * scales_t.index_select(0, tl).reshape(-1, 1)
        if cosine:
            nr = norms_t.index_select(0, tl).reshape(-1, 1)
            sc = sc / torch.clamp_min(nr * qn[:, 0][None, :], 1e-12)
        sc = torch.where(sids_t.index_select(0, tl).reshape(-1, 1) >= 0, sc, -math.inf)
        maxes.append(sc.view(-1, chunk, g).amax(dim=1))  # [P*tile, g]
    allc = (maxes[0] if len(maxes) == 1 else torch.cat(maxes)).T  # [g, E*tile]
    kc = stn._chunk_k(k, e_pad * tile)
    cv, cpos = stn._stable_topk(allc, min(kc, allc.shape[1]))
    tchunk = tiles[cpos // tile] * tile + cpos % tile  # global chunk ids
    # starved selections (-inf chunk max) land on the guard chunk so the
    # gather below cannot touch an unprobed cell's items
    tchunk = torch.where(torch.isfinite(cv), tchunk, guard_chunk)
    iid = (tchunk[:, :, None] * chunk + torch.arange(chunk, device=q.device)).reshape(g, -1)
    sid = index.slot_ids[iid]
    sc = stn.gathered_pair_scores(
        index.mat_t, index.resid, index.scales, index.resid_scales, index.norms,
        q, qn, iid, cosine=cosine,
    )
    sc = torch.where(sid >= 0, sc, -math.inf)
    return _merge_overlay(sc, sid, q, qn, ov, k, cosine)


def _full_topk(index: IVFIndex, q: torch.Tensor, k: int, cosine: bool, ov):
    """nprobe == n_cells: every live slot is a candidate, in ascending item
    id order, scored by the two-plane epilogue segment by segment; the
    stable selections then break score ties toward the lowest item id,
    as the exact scan does. O(n) gathers per query group: this mode is for
    the exactness contract and small catalogs."""
    sid_all = index.slot_ids
    key = torch.where(sid_all >= 0, sid_all, torch.iinfo(torch.int32).max)
    order = torch.sort(key, stable=True)[1]  # ascending id, padding last
    n_live = int(index.chunk_count_host.sum()) * index.chunk  # covers every live slot
    n_live = min(n_live, index.n_slots)
    outs_v, outs_i = [], []
    g = max(1, min(QUERY_BLOCK, q.shape[0]))
    for gb in range(0, q.shape[0], g):
        qg = q[gb : gb + g]
        qn = torch.linalg.vector_norm(qg, dim=1, keepdim=True) if cosine else None
        kk = max(1, min(k, _SEG_ITEMS))
        vs, ids = [], []
        for beg in range(0, max(1, n_live), _SEG_ITEMS):
            ii = order[beg : beg + _SEG_ITEMS][None, :].expand(qg.shape[0], -1)
            ss = sid_all[ii]
            sc = stn.gathered_pair_scores(
                index.mat_t, index.resid, index.scales, index.resid_scales, index.norms,
                qg, qn, ii, cosine=cosine,
            )
            sc = torch.where(ss >= 0, sc, -math.inf)
            v, p = stn._stable_topk(sc, min(kk, sc.shape[1]))
            vs.append(v)
            ids.append(torch.gather(ss, 1, p))
        v, i = _merge_overlay(torch.cat(vs, 1), torch.cat(ids, 1), qg, qn, ov, k, cosine)
        outs_v.append(v)
        outs_i.append(i)
    return torch.cat(outs_v), torch.cat(outs_i)


# -- query: entry points ------------------------------------------------------


def _padded_queries(index: IVFIndex, queries) -> torch.Tensor:
    """[n, kf_pad] float32 queries on the index's device."""
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=index.device, dtype=torch.float32)
    else:
        q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(index.device)
    if q.dim() == 1:
        q = q[None]
    return stn._pad_queries(q, index.mat_t.shape[0]).contiguous()


def _overlay(index: IVFIndex):
    """The overlay's (rows, ids, norms); an empty overlay shrinks to one
    masked row, so an idle overlay costs no product over its capacity."""
    if index.ov_used == 0:
        return index.ov_rows[:1], index.ov_ids[:1], index.ov_norms[:1]
    return index.ov_rows, index.ov_ids, index.ov_norms


def top_k_device(index: IVFIndex, queries, k: int, *, nprobe: int | None = None,
                 cosine: bool = False):
    """(vals [n, k] f32, ids [n, k] int32) tensors on the index's device;
    ids are ORIGINAL item row indices (-1 pads starved windows)."""
    np_ = index.resolve_nprobe(nprobe)
    with _counts_lock:
        NPROBE_COUNTS[np_] = NPROBE_COUNTS.get(np_, 0) + 1
    kk = max(1, int(k))
    q = _padded_queries(index, queries)
    n = q.shape[0]
    ov = _overlay(index)
    if np_ >= index.n_cells:
        _count("full")
        return _full_topk(index, q, kk, cosine, ov)
    cells = _route_cells(index, q, np_, cosine).cpu().numpy()  # the batch's host round trip
    _count("route_syncs")
    if index.host_plane is not None:
        _count("host")
        vals, ids = _host_topk(index, q.cpu().numpy(), cells, kk, cosine)
        return torch.from_numpy(vals).to(index.device), torch.from_numpy(ids).to(index.device)
    _count("device")
    # probe-locality sort: queries sharing a best cell land in the same
    # scan group, shrinking each group's union
    order = np.argsort(cells[:, 0], kind="stable")
    g = max(1, min(QUERY_BLOCK, n))
    lists = _group_tile_lists(index, cells[order], g)
    guard = index.n_slots // (index.tile_chunks * index.chunk) - 1
    lists = [t if len(t) else np.array([guard], np.int64) for t in lists]
    bounds = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(t) for t in lists], out=bounds[1:])
    tiles_all = torch.from_numpy(np.concatenate(lists)).to(index.device)
    order_t = torch.from_numpy(order).to(index.device)
    qs = q[order_t]
    out_v = torch.empty((n, kk), dtype=torch.float32, device=index.device)
    out_i = torch.empty((n, kk), dtype=torch.int32, device=index.device)
    for gi in range(len(lists)):
        rows = order_t[gi * g : (gi + 1) * g]
        v, i = _probe_topk(
            index, qs[gi * g : (gi + 1) * g], tiles_all[bounds[gi] : bounds[gi + 1]],
            _pow2_ceil(len(lists[gi])), kk, cosine, ov,
        )
        out_v[rows] = v
        out_i[rows] = i
    return out_v, out_i


def top_k(index: IVFIndex, queries, k: int, *, nprobe: int | None = None, cosine: bool = False):
    """Blocking host-side form: (ids [n, k] int32, vals [n, k] f32)."""
    vals, ids = top_k_device(index, queries, k, nprobe=nprobe, cosine=cosine)
    return ids.cpu().numpy(), vals.cpu().numpy()


def top_k_device_indexed(index: IVFIndex, x_dev: torch.Tensor, indices, k: int, *,
                         nprobe: int | None = None, cosine: bool = False):
    """Index-submit twin: queries are rows of the card-resident X,
    gathered on the card."""
    idx = torch.from_numpy(np.atleast_1d(np.asarray(indices, dtype=np.int64)))
    return top_k_device(index, x_dev[idx.to(x_dev.device)], k, nprobe=nprobe, cosine=cosine)


# -- update path (speed-layer fold-ins) ---------------------------------------


def update_rows(index: IVFIndex, rows: np.ndarray, values: np.ndarray,
                n_items: int | None = None) -> IVFIndex:
    """Fold updated item rows into the index via the pending overlay.

    Each touched row's slot is tombstoned (slot id -> -1) and its fresh
    vector lands in the overlay, which queries scan exactly, so a fold-in
    is visible on the next request whatever cell it belongs to. Overlay
    rows hold the two-plane DEQUANTIZED values (q1*s1 + q2*s2).

    A full overlay spills its oldest entries to ``index.pending_spill``
    (raw values + fold-in time) and reuses their slots; spilled rows are
    invisible until ``compact_ivf`` folds them back. Re-updating an
    overlaid item refreshes its recency (and supersedes a spilled value)."""
    rows = np.asarray(rows, dtype=np.int64)
    values = np.ascontiguousarray(np.atleast_2d(values), dtype=np.float32)
    if len(rows) == 0:
        return index
    count = int(index.n_items if n_items is None else n_items)
    # last write wins for duplicate ids in one batch
    last = {}
    for i, r in enumerate(rows):
        last[int(r)] = i
    ids = np.fromiter(last.keys(), dtype=np.int64, count=len(last))
    vals = values[np.fromiter(last.values(), dtype=np.int64, count=len(last))]

    cap = index.ov_rows.shape[0]
    kf_pad = index.mat_t.shape[0]
    ov_map = index.ov_map
    spill = index.pending_spill if index.pending_spill is not None else {}
    born = index.ov_born if index.ov_born is not None else {}
    now = time.time()
    used = index.ov_used
    pos = np.empty(len(ids), np.int64)
    fresh = 0
    for i, item in enumerate(ids):
        item = int(item)
        spill.pop(item, None)  # a fresh value supersedes any spilled one
        if item in ov_map:
            # keep the slot but refresh recency (dict order = age order)
            pos[i] = ov_map.pop(item)
            ov_map[item] = int(pos[i])
        elif used + fresh >= cap:
            if ov_map:
                # overlay full: evict the OLDEST entry to the spill queue
                # and reuse its slot
                old_id, old_slot = next(iter(ov_map.items()))
                ov_map.pop(old_id)
                spill[old_id] = (index.ov_raw_host[old_slot].copy(), born.pop(old_id, now))
                pos[i] = old_slot
                ov_map[item] = int(old_slot)
            else:
                # every slot belongs to THIS batch's fresh entries (they
                # join ov_map after the scatter): the row spills directly
                raw = np.zeros(kf_pad, np.float32)
                raw[: vals.shape[1]] = vals[i]
                spill[item] = (raw, now)
                born.pop(item, None)
                pos[i] = -1
        else:
            pos[i] = used + fresh
            fresh += 1
    dead = np.array(
        [index.id_to_slot[item] for item in ids
         if item < len(index.id_to_slot) and index.id_to_slot[item] >= 0],
        dtype=np.int64,
    )
    dev = index.device
    slot_ids = index.slot_ids
    if len(dead):
        slot_ids = slot_ids.clone()
        slot_ids[torch.from_numpy(dead).to(dev)] = -1
        if index.slot_ids_host is not None:
            index.slot_ids_host[dead] = -1  # tombstone in the host mirror

    keep = pos >= 0
    if not keep.all():
        # direct-spilled rows skip the overlay scatter, but any base-slot
        # versions of them still die (dead above covers them)
        for i in np.flatnonzero(~keep):
            item = int(ids[i])
            if item < len(index.id_to_slot):
                index.id_to_slot[item] = -1
        ids, vals, pos = ids[keep], vals[keep], pos[keep]
        if len(ids) == 0:
            return dataclasses.replace(
                index, slot_ids=slot_ids, n_items=max(count, index.n_items),
                ov_used=used + fresh,
            )

    q, s = stn._quantize_rows(vals)
    q2, s2 = stn._quantize_residual(vals, q, s)
    deq = q.astype(np.float32) * s[:, None] + q2.astype(np.float32) * s2[:, None]
    deq_pad = np.zeros((len(ids), kf_pad), np.float32)
    deq_pad[:, : vals.shape[1]] = deq
    nrm = np.linalg.norm(vals, axis=1).astype(np.float32)
    pos_t = torch.from_numpy(pos).to(dev)
    ov_rows = index.ov_rows.clone()
    ov_rows[pos_t] = torch.from_numpy(deq_pad).to(dev)
    ov_ids = index.ov_ids.clone()
    ov_ids[pos_t] = torch.from_numpy(ids.astype(np.int32)).to(dev)
    ov_norms = index.ov_norms.clone()
    ov_norms[pos_t] = torch.from_numpy(nrm).to(dev)

    # host bookkeeping (serialized by the caller)
    if index.ov_rows_host is not None:
        index.ov_rows_host[pos] = deq_pad
        index.ov_ids_host[pos] = ids.astype(np.int32)
        index.ov_norms_host[pos] = nrm
    raw_pad = np.zeros((len(ids), kf_pad), np.float32)
    raw_pad[:, : vals.shape[1]] = vals
    index.ov_raw_host[pos] = raw_pad
    for i, item in enumerate(ids):
        item = int(item)
        ov_map[item] = int(pos[i])
        born[item] = now
        if item < len(index.id_to_slot):
            index.id_to_slot[item] = -1
    return dataclasses.replace(
        index, slot_ids=slot_ids, ov_rows=ov_rows, ov_ids=ov_ids, ov_norms=ov_norms,
        n_items=max(count, index.n_items), ov_used=used + fresh,
    )


def capacity(index: IVFIndex) -> int:
    """Rows the handle represents without a rebuild: the built catalog
    plus the free overlay slots."""
    return index.n_items + (index.ov_rows.shape[0] - index.ov_used)


# -- maintenance (background compaction; serving/maintain.py drives) ----------


@dataclasses.dataclass
class PendingSnapshot:
    """A consistent copy of what compaction folds in: the overlay's raw
    rows plus the spill queue, with per-item fold-in times."""

    ids: np.ndarray  # [m] int64 item ids
    raw: np.ndarray  # [m, kf_pad] f32 RAW (pre-quantization) values
    born: dict  # item id -> fold-in wall-clock seconds
    taken_at: float  # wall-clock seconds at snapshot


def snapshot_pending(index: IVFIndex) -> PendingSnapshot:
    """Copy the overlay + spill queue out of the index, under the owner's
    serialization (the serving model's cache lock): ``compact_ivf`` then
    runs on immutable tensors plus these copies while fold-ins go on."""
    ids: list[int] = []
    rows: list[np.ndarray] = []
    born: dict[int, float] = {}
    src_born = index.ov_born or {}
    now = time.time()
    for item, slot in index.ov_map.items():
        ids.append(item)
        rows.append(index.ov_raw_host[slot].copy())
        born[item] = src_born.get(item, now)
    for item, (raw, b) in (index.pending_spill or {}).items():
        ids.append(item)
        rows.append(np.asarray(raw, dtype=np.float32))
        born[item] = float(b)
    kf_pad = index.mat_t.shape[0]
    raw = np.vstack(rows).astype(np.float32, copy=False) if rows else np.zeros((0, kf_pad), np.float32)
    return PendingSnapshot(np.asarray(ids, np.int64), raw, born, now)


def needs_maintenance(index, watermark: float = 0.5) -> bool:
    """True once anything spilled (those rows are invisible until
    compaction) or the overlay passed the watermark."""
    if not isinstance(index, IVFIndex):
        return False
    if index.pending_spill:
        return True
    return index.ov_used >= max(1, int(float(watermark) * index.ov_rows.shape[0]))


def compact_ivf(index: IVFIndex, pending: PendingSnapshot | None = None, *, seed: int = 0,
                split_max_items: int = 0, merge_min_items: int = 0) -> tuple[IVFIndex, dict]:
    """Fold the overlay + spill queue into a fresh cell-contiguous layout
    WITHOUT retraining the coarse quantizer.

    - retained rows keep their quantized codes, scales and norms, so the
      planes equal a fresh ``build_ivf`` over the same items and
      centroids;
    - pending rows quantize from their RAW values and go to their
      nearest centroid;
    - tombstoned slots are dropped;
    - cells past ``split_max_items`` split by a local 2-means (through
      ``train_kmeans``, hence the sweep kernel); cells below
      ``merge_min_items`` dissolve into their members' nearest surviving
      centroid. Zero thresholds derive from the mean cell load (4x mean
      splits, mean/8 merges).

    Returns ``(new_index, stats)``; the new index starts with an empty
    overlay and spill queue. Runs on the caller's thread, off the request
    path."""
    if pending is None:
        pending = snapshot_pending(index)
    feat = index.features
    ts = index.tile_chunks * index.chunk
    cells0 = index.n_cells
    dev = index.device

    # slot -> cell from the tile spans (cells are laid out contiguously
    # from slot 0 in cell order; the guard tile maps to no cell)
    spans = (index.tile_count_host * ts).astype(np.int64)
    slot_cell = np.full(index.n_slots, -1, np.int64)
    slot_cell[: int(spans.sum())] = np.repeat(np.arange(cells0, dtype=np.int64), spans)

    sids = index.slot_ids.cpu().numpy()
    live = np.flatnonzero(sids >= 0)
    live_t = torch.from_numpy(live).to(dev)
    r_ids = sids[live].astype(np.int64)
    r_cell = slot_cell[live]
    r_q = index.mat_rows[live_t][:, :feat].cpu().numpy()
    r_q2 = index.resid[:, live_t].t()[:, :feat].contiguous().cpu().numpy()
    r_s = index.scales[0, live_t].cpu().numpy()
    r_s2 = index.resid_scales[0, live_t].cpu().numpy()
    r_n = index.norms[0, live_t].cpu().numpy()

    centers = np.ascontiguousarray(index.centroids_t.cpu().numpy().T[:, :feat])
    p_ids = pending.ids
    if len(p_ids):
        p_raw = np.ascontiguousarray(pending.raw[:, :feat])
        p_cell = _assign_cells(p_raw, centers, dev).astype(np.int64)
        p_q, p_s = stn._quantize_rows(p_raw)
        p_q2, p_s2 = stn._quantize_residual(p_raw, p_q, p_s)
        p_n = np.linalg.norm(p_raw, axis=1)
        ids = np.concatenate([r_ids, p_ids])
        cell = np.concatenate([r_cell, p_cell])
        q = np.vstack([r_q, p_q])
        q2 = np.vstack([r_q2, p_q2])
        s = np.concatenate([r_s, p_s])
        s2 = np.concatenate([r_s2, p_s2])
        nv = np.concatenate([r_n, p_n])
    else:
        ids, cell, q, q2, s, s2, nv = r_ids, r_cell, r_q, r_q2, r_s, r_s2, r_n
    n = len(ids)
    if n == 0:
        raise ValueError("compaction would produce an empty index")

    mean = max(1, n // max(1, cells0))
    merge_min = int(merge_min_items) or max(1, mean // 8)
    split_max = int(split_max_items) or max(mean * 4, merge_min + 1)

    def dequantized(mem):
        return q[mem].astype(np.float32) * s[mem, None] + q2[mem].astype(np.float32) * s2[mem, None]

    # -- merges: starved cells dissolve into their nearest survivor ------
    counts = np.bincount(cell, minlength=cells0)
    victims = np.flatnonzero(counts < merge_min)
    merges = 0
    if len(victims) == cells0:  # keep the fattest cell alive
        victims = victims[victims != int(np.argmax(counts))]
    if len(victims):
        surv = np.setdiff1d(np.arange(cells0), victims, assume_unique=True)
        remap = np.full(cells0, -1, np.int64)
        remap[surv] = np.arange(len(surv))
        cell = remap[cell]
        mov = np.flatnonzero(cell < 0)
        if len(mov):
            cell[mov] = _assign_cells(dequantized(mov), centers[surv], dev).astype(np.int64)
        centers = np.ascontiguousarray(centers[surv])
        merges = int(len(victims))

    # -- splits: overloaded cells split via a local 2-means --------------
    splits = 0
    counts = np.bincount(cell, minlength=len(centers))
    big = np.flatnonzero(counts > split_max)
    if len(big):
        from oryx_tpu_torch.ops.kmeans import train_kmeans

        order_c = np.argsort(cell, kind="stable")
        bounds = np.zeros(len(centers) + 1, np.int64)
        np.cumsum(counts, out=bounds[1:])
        extra: list[np.ndarray] = []
        for c in big:
            mem = order_c[bounds[c] : bounds[c + 1]]
            deq = dequantized(mem)
            minibatch = 32_768 if len(deq) > 65_536 else None
            sub_c, _cnt, _cost = train_kmeans(
                deq, 2, iterations=4, init="k-means||", seed=seed + 17 * int(c),
                minibatch_size=minibatch, device=dev,
            )
            sub_c = np.asarray(sub_c, dtype=np.float32)
            half = _assign_cells(deq, sub_c, dev)
            if half.min() == half.max():
                continue  # degenerate split (all rows one side): skip
            centers[c] = sub_c[0]
            cell[mem[half == 1]] = len(centers) + len(extra)
            extra.append(sub_c[1])
            splits += 1
        if extra:
            centers = np.vstack([centers] + [e[None, :] for e in extra])

    n_items = max(index.n_items, int(ids.max()) + 1)
    new_index = _assemble_layout(
        ids, cell, centers, q, q2, s, s2, nv, feat=feat, chunk=index.chunk,
        tile_chunks=index.tile_chunks, cap=index.ov_rows.shape[0], n_items=n_items,
        host1=index.slot_ids_host is not None, device=dev,
    )
    stats = {
        "folded": int(len(p_ids)),
        "live": int(len(r_ids)),
        "cells": int(len(centers)),
        "splits": int(splits),
        "merges": merges,
        "born": dict(pending.born),
        "taken_at": pending.taken_at,
    }
    return new_index, stats


def _assemble_layout(ids, cell, centers, q, q2, s, s2, norms_v, *, feat: int, chunk: int,
                     tile_chunks: int, cap: int, n_items: int, host1: bool,
                     device=None) -> IVFIndex:
    """Lay (ids, cell assignment, codes) out cell-contiguous and
    tile-aligned: ``build_ivf``'s layout stage over PRE-QUANTIZED rows."""
    return _assemble(
        np.asarray(ids, np.int64), np.asarray(cell, np.int64), centers,
        lambda beg, end: (q[beg:end], s[beg:end], q2[beg:end], s2[beg:end], norms_v[beg:end]),
        feat=feat, cap=cap, n_items=n_items, host1=host1, device=resolve(device),
        chunk=chunk, tile_chunks=tile_chunks,
    )


# -- tiered host plane --------------------------------------------------------


def attach_tiered_plane(index: IVFIndex, plane=None) -> IVFIndex:
    """The identity while tiering is off, which is all the port serves:
    the tiered HBM->RAM->disk cell store is not ported (a config that
    enables it is refused by ``refuse_tier_store``)."""
    if plane is not None:
        raise NotYetPortedError(
            "the tiered host plane (oryx.serving.store.tier) is not yet ported to oryx_tpu_torch"
        )
    return index


def refuse_tier_store(config) -> None:
    """Raise for ``oryx.serving.store.tier.enabled = true``: IVF host planes
    would not move into the tiered item store, which is not ported."""
    if config.get_optional_bool("oryx.serving.store.tier.enabled"):
        raise NotYetPortedError(
            "oryx.serving.store.tier.enabled = true, but the tiered item store is not yet "
            "ported to oryx_tpu_torch"
        )
