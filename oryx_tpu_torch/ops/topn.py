"""Top-N scoring facade: upload, incremental update and async submit
(counterpart of ``oryx_tpu/ops/topn.py``).

A handle is the feature-major :class:`StreamingItemMatrix`, for every
score dtype (float32, bfloat16, int8 two-plane), whose scans run the
hand-written kernels of :mod:`oryx_tpu_torch.ops.streaming_topn`, or an
:class:`~oryx_tpu_torch.ops.ivf.IVFIndex` (the IVF tier over int8 codes),
which every entry point here routes to :mod:`oryx_tpu_torch.ops.ivf`.

``submit_top_k`` and its multi-group forms are asynchronous: the scan is
launched on a dedicated CUDA stream, its results are copied into pinned
host buffers without blocking, and an event recorded after the copy is
what ``result()`` waits on. The batcher submits on one thread and
collects on another, so the handle synchronises on its own event, never
on whatever stream happens to be current. On the CPU (the tests) the
same calls run synchronously.

``upload_random`` generates a random item matrix on the card, in the
handle form of ``upload``.

``upload_sharded`` / ``top_k_sharded`` shard the item rows over a device
mesh (``parallel/mesh.py``): each shard holds a streaming handle of its
rows and scans it with the same kernels as one card (B1 ``topn_scan`` for
b <= 256, B2 ``topn_candidates`` above, each merged by ``topn_merge``, an
int8 shard rescoring its candidates against its residual plane); the
shards' [b, k] lists, their ids moved to global rows, are all-gathered and
merged once more by ``topn_merge``. The JAX package runs this scan in XLA
(``jnp.dot`` + ``lax.top_k`` per shard, both int8 planes summed in full);
the port's per-shard scan is its hand kernel, as on one card. Ties go to
the lowest global id; rows past the catalog never score.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from oryx_tpu_torch.device import resolve
from oryx_tpu_torch.ops import ivf as ivf_ops
from oryx_tpu_torch.ops.ivf import IVFIndex
from oryx_tpu_torch.ops.streaming_topn import (
    _INT8_FEAT_MULTIPLE,
    BLOCK_N,
    MAX_KERNEL_K,
    StreamingItemMatrix,
    _ceil_to,
    _quantize_residual,
    _quantize_rows,
    top_k_streaming,
    top_k_streaming_device,
    top_k_streaming_device_multi,
    top_k_streaming_device_multi_indexed,
    topn_merge,
    topn_merge_plain,
    torch_dtype,
    upload_streaming,
)


def upload(matrix: np.ndarray, dtype=None, device=None) -> StreamingItemMatrix:
    """Move a packed [n, k] float32 item matrix to the card as a
    streaming handle; ``dtype`` is float32 (default), bfloat16 or int8
    (row-quantized codes plus a residual plane)."""
    return upload_streaming(matrix, dtype=torch_dtype(dtype), device=device)


def top_k_scores(uploaded, query: np.ndarray, k: int, cosine: bool = False):
    """(indices, scores) of the k best items for one query vector."""
    if isinstance(uploaded, IVFIndex):
        idx, vals = ivf_ops.top_k(uploaded, query, k, cosine=cosine)
    elif isinstance(uploaded, ShardedItemMatrix):
        idx, vals = top_k_sharded(uploaded, query, k, cosine=cosine)
    else:
        idx, vals = top_k_streaming(uploaded, query, k, cosine=cosine)
    return idx[0], vals[0]


def top_k_scores_batch(uploaded, queries: np.ndarray, k: int, cosine: bool = False):
    """Batched top-k for [b, k] query vectors; b > 256 takes the
    candidates kernel."""
    if isinstance(uploaded, IVFIndex):
        return ivf_ops.top_k(uploaded, queries, k, cosine=cosine)
    if isinstance(uploaded, ShardedItemMatrix):
        return top_k_sharded(uploaded, queries, k, cosine=cosine)
    return top_k_streaming(uploaded, queries, k, cosine=cosine)


# -- mesh-sharded scan --------------------------------------------------------


@dataclass
class ShardedItemMatrix:
    """Item matrix row-sharded over a device mesh: every shard holds the
    streaming handle of its ``per`` rows (the multi-card serving layout:
    a 40M x 200 float32 model is 32 GB on one card, 8 GB a card over
    four)."""

    shards: list  # this process's shards' StreamingItemMatrix, in shard order
    bases: list  # each of those shards' first global row
    n_items: int
    mesh: object
    per: int  # rows per shard, padding included


def upload_sharded(matrix: np.ndarray, mesh, dtype=None) -> ShardedItemMatrix:
    """Shard a packed [n, k] item matrix row-wise over ``mesh``'s shards
    (padded so every shard gets an equal slice). ``dtype=int8``
    row-quantizes each shard's rows as the streaming handle does, so the
    codes equal one card's."""
    from oryx_tpu_torch.parallel.mesh import pad_to_multiple

    matrix = np.asarray(matrix, dtype=np.float32)
    n, k = matrix.shape
    d = mesh.size
    per = pad_to_multiple(max(n, d), d) // d
    dtype = torch_dtype(dtype)
    shards, bases = [], []
    for i in mesh.local:
        lo, hi = i * per, min(n, (i + 1) * per)
        rows = matrix[lo:hi] if hi > lo else np.zeros((0, k), np.float32)
        shards.append(upload_streaming(rows, dtype=dtype, device=mesh.shards[i].device))
        bases.append(lo)
    return ShardedItemMatrix(shards=shards, bases=bases, n_items=n, mesh=mesh, per=per)


def top_k_sharded(
    up: ShardedItemMatrix, queries: np.ndarray, k: int, cosine: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """(indices [b, k], scores [b, k]) over the mesh-sharded matrix."""
    from oryx_tpu_torch.parallel.mesh import all_gather

    q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    k = max(1, min(int(k), up.n_items))
    b = q.shape[0]
    vals, ids = [], []
    for h, base in zip(up.shards, up.bases):
        v = torch.full((b, k), -math.inf, dtype=torch.float32, device=h.device)
        # a shard short of k rows fills with its last padding row at -inf
        i = torch.full((b, k), base + up.per - 1, dtype=torch.int32, device=h.device)
        if h.n_items:
            kk = min(k, h.n_items)
            sv, si = top_k_streaming_device(h, q, kk, cosine=cosine)
            v[:, :kk] = sv
            i[:, :kk] = si + base
        vals.append(v[None])
        ids.append(i[None])
    all_v = all_gather(up.mesh, vals)[0]  # [S, b, k], shard s's ids below shard s+1's
    all_i = all_gather(up.mesh, ids)[0]
    merge = topn_merge if k <= MAX_KERNEL_K else topn_merge_plain
    mv, mi = merge(all_v.contiguous(), all_i.contiguous(), k)
    return mi.cpu().numpy(), mv.cpu().numpy()


def capacity(uploaded) -> int:
    """Row capacity of the handle (padding included); rows beyond
    ``n_items`` can be appended with :func:`update_rows`. For an IVF
    handle, the built catalog plus the free overlay slots."""
    if isinstance(uploaded, IVFIndex):
        return ivf_ops.capacity(uploaded)
    return uploaded.mat_t.shape[1]


def update_rows(uploaded, rows: np.ndarray, values: np.ndarray, n_items: int | None = None):
    """Scatter ``values`` [len(rows), k] into ``rows`` of a new handle —
    the incremental-refresh path. ``n_items`` may grow into the padded
    capacity. int8 rows requantize on the host with the upload's own
    functions, so a touched row is bit-identical to a fresh upload. An
    IVF handle folds the rows in through its pending overlay.

    The handle is copied, not updated in place: scans already in flight
    on the scan stream may still be reading the old planes."""
    if isinstance(uploaded, IVFIndex):
        return ivf_ops.update_rows(uploaded, rows, values, n_items=n_items)
    rows = np.asarray(rows, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.float32)
    if len(rows) == 0:
        return uploaded
    dev = uploaded.device
    r = torch.from_numpy(rows).to(dev)
    count = uploaded.n_items if n_items is None else n_items
    norms = uploaded.norms.clone()
    norms[0, r] = torch.from_numpy(np.linalg.norm(values, axis=1).astype(np.float32)).to(dev)
    if uploaded.scales is not None:
        qr, sr = _quantize_rows(values)
        q2r, s2r = _quantize_residual(values, qr, sr)
        kf_pad = uploaded.mat_t.shape[0]

        def put(plane, codes):
            padded = np.zeros((kf_pad, len(rows)), dtype=np.int8)
            padded[: codes.shape[1]] = codes.T
            out = plane.clone()
            out[:, r] = torch.from_numpy(padded).to(dev)
            return out

        def put_row(row, vals):
            out = row.clone()
            out[0, r] = torch.from_numpy(vals).to(dev)
            return out

        return StreamingItemMatrix(
            mat_t=put(uploaded.mat_t, qr),
            norms=norms,
            n_items=count,
            scales=put_row(uploaded.scales, sr),
            features=uploaded.features,
            resid=put(uploaded.resid, q2r),
            resid_scales=put_row(uploaded.resid_scales, s2r),
        )
    mat_t = uploaded.mat_t.clone()
    mat_t[:, r] = torch.from_numpy(values.T.copy()).to(dev).to(mat_t.dtype)
    return StreamingItemMatrix(mat_t=mat_t, norms=norms, n_items=count)


def upload_queries(queries: np.ndarray, device=None) -> torch.Tensor:
    """Stage a [m, feat] query-vector matrix on the card (float32), for
    index-submitted scans."""
    q = np.ascontiguousarray(np.atleast_2d(np.asarray(queries, np.float32)))
    return torch.from_numpy(q).to(resolve(device))


RANDOM_CHUNK_ROWS = 1 << 20  # rows upload_random draws (and quantizes) at a time


def _random_chunks(n_items: int, num_features: int, seed: int, device: torch.device):
    """(first row, [rows, num_features] float32 standard normal block) in
    order, drawn by one seeded generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for start in range(0, n_items, RANDOM_CHUNK_ROWS):
        rows = min(RANDOM_CHUNK_ROWS, n_items - start)
        yield start, torch.randn(
            (rows, num_features), generator=gen, device=device, dtype=torch.float32
        )


def random_items(n_items: int, num_features: int, seed: int = 0, device=None) -> torch.Tensor:
    """The [n_items, num_features] float32 matrix that
    ``upload_random(..., seed=seed)`` draws, on ``device``."""
    dev = resolve(device)
    return torch.cat([block for _, block in _random_chunks(n_items, num_features, seed, dev)])


def _int8_planes(block: torch.Tensor):
    """``_quantize_rows`` and ``_quantize_residual`` on the device, op for
    op, so that the codes and scales equal the host's bit for bit: the
    divisors are tensors (a Python-number divisor is a multiply by its
    reciprocal on the card), and ``torch.round`` rounds half to even as
    ``np.rint`` does."""

    def quantize(rows: torch.Tensor):
        absmax = rows.abs().amax(dim=1)
        s = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
        return torch.clamp(torch.round(rows / s[:, None]), -127, 127).to(torch.int8), s

    q, s = quantize(block)
    q2, s2 = quantize(block - q.to(torch.float32) * s[:, None])
    return q, s, q2, s2


def upload_random(
    n_items: int,
    num_features: int,
    dtype=None,
    seed: int = 0,
    streaming: bool | None = None,
    device=None,
) -> StreamingItemMatrix:
    """Benchmark helper: a random item matrix generated on the card, in the
    same handle form as :func:`upload` (float32, bfloat16, or int8 codes,
    scales and residual). Its bytes cross the host link in neither
    direction and never sit in host memory: the planes are drawn,
    quantized, normed and laid out on the card RANDOM_CHUNK_ROWS rows at a
    time. Every plane equals ``upload()`` of :func:`random_items` read
    back bit for bit, except the item norms: the card sums each row in
    another order than numpy, so they agree to float32 rounding.

    ``streaming`` is the JAX package's switch between its two layouts; the
    port has the streaming one only (as ``upload`` does), so False raises."""
    if streaming is False:
        raise ValueError("the port's item handles are all streaming: streaming=False")
    dev = resolve(device)
    dtype = torch_dtype(dtype)
    n_pad = max(BLOCK_N, _ceil_to(n_items, BLOCK_N))
    norms = torch.zeros((1, n_pad), dtype=torch.float32, device=dev)
    quantized = dtype == torch.int8
    kf = _ceil_to(num_features, _INT8_FEAT_MULTIPLE) if quantized else num_features
    mat_t = torch.zeros((kf, n_pad), dtype=dtype, device=dev)
    if quantized:
        resid = torch.zeros((kf, n_pad), dtype=torch.int8, device=dev)
        scales = torch.ones((1, n_pad), dtype=torch.float32, device=dev)
        rscales = torch.ones((1, n_pad), dtype=torch.float32, device=dev)
    for start, block in _random_chunks(n_items, num_features, seed, dev):
        cols = slice(start, start + block.shape[0])
        norms[0, cols] = torch.linalg.vector_norm(block, dim=1)
        if quantized:
            q, s, q2, s2 = _int8_planes(block)
            mat_t[:num_features, cols] = q.T
            resid[:num_features, cols] = q2.T
            scales[0, cols] = s
            rscales[0, cols] = s2
        else:
            mat_t[:, cols] = block.T.to(dtype)
        del block
    if not quantized:
        return StreamingItemMatrix(mat_t=mat_t, norms=norms, n_items=n_items)
    return StreamingItemMatrix(
        mat_t=mat_t, norms=norms, n_items=n_items, scales=scales,
        features=num_features if kf != num_features else None,
        resid=resid, resid_scales=rscales,
    )


def update_query_rows(x_dev: torch.Tensor, rows: np.ndarray, values: np.ndarray) -> torch.Tensor:
    """Scatter rows of a staged query matrix into a copy of it (in-flight
    index scans may still read the old one)."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return x_dev
    out = x_dev.clone()
    vals = np.ascontiguousarray(values, dtype=np.float32)
    out[torch.from_numpy(rows).to(x_dev.device)] = torch.from_numpy(vals).to(x_dev.device)
    return out


def _auto_download_dtype(uploaded: StreamingItemMatrix):
    """Scores of bf16 and int8 planes return as bf16 (selection runs in
    f32): the JAX package ships them so, and /recommend values carry
    that rounding. float32 planes return float32."""
    return torch.bfloat16 if uploaded.mat_t.dtype in (torch.bfloat16, torch.int8) else None


def _group_pad(arr: np.ndarray, scan_batch: int) -> tuple[np.ndarray, int]:
    """Zero-pad rows to a multiple of the per-scan batch and reshape to
    [groups, b, ...]; returns (grouped, real row count)."""
    n = arr.shape[0]
    b = max(1, min(scan_batch, n))
    groups = (n + b - 1) // b
    if groups * b != n:
        pad = np.zeros((groups * b - n,) + arr.shape[1:], arr.dtype)
        arr = np.concatenate([arr, pad])
    return arr.reshape((groups, b) + arr.shape[1:]), n


class _InFlight:
    """Scores and ids of one submitted scan on their way to the host."""

    def __init__(self, vals: torch.Tensor, idxs: torch.Tensor, event=None, keep=()) -> None:
        self._vals = vals
        self._idxs = idxs
        self._event = event
        self._keep = keep  # inputs the scan stream reads until the event

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
            self._keep = ()
        # scores may travel as bf16; callers always see f32
        return self._idxs.numpy(), self._vals.float().numpy()


class TopNHandle(_InFlight):
    """In-flight async top-k request; ``result()`` blocks and returns
    (indices [b, k], scores [b, k]) as numpy arrays."""

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        return self.arrays()


class MultiTopNHandle(_InFlight):
    """In-flight multi-group scan; ``result()`` returns (indices [n, k],
    scores [n, k]) for the original n queries."""

    def __init__(self, vals, idxs, n: int, event=None, keep=()) -> None:
        super().__init__(vals, idxs, event, keep)
        self._n = n

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        idxs, vals = self.arrays()
        k = idxs.shape[-1]
        return idxs.reshape(-1, k)[: self._n], vals.reshape(-1, k)[: self._n]


_streams: dict[int, torch.cuda.Stream] = {}
_streams_lock = threading.Lock()


def _scan_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _streams_lock:
        s = _streams.get(index)
        if s is None:
            s = _streams[index] = torch.cuda.Stream(device=index)
        return s


def _submit(run, uploaded, make_handle, keep=()):
    """Run ``run()`` -> (vals, idxs) asynchronously: on the card, on the
    scan stream, with a non-blocking copy into pinned host buffers and an
    event behind it; on the CPU, in place."""
    dev = uploaded.device
    if dev.type != "cuda":
        vals, idxs = run()
        return make_handle(vals, idxs, None, ())
    stream = _scan_stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        vals, idxs = run()
        host_v = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        host_i = torch.empty(idxs.shape, dtype=idxs.dtype, pin_memory=True)
        host_v.copy_(vals, non_blocking=True)
        host_i.copy_(idxs, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return make_handle(host_v, host_i, event, (vals, idxs, uploaded) + tuple(keep))


def submit_top_k(
    uploaded, queries: np.ndarray, k: int, cosine: bool = False, nprobe: int | None = None
) -> TopNHandle:
    """Enqueue a batched top-k without waiting. ``nprobe`` overrides an
    IVF index's probe count for this call (the overload ladder's
    reduced-probe rung); the exact scan ignores it."""
    q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    if isinstance(uploaded, IVFIndex):
        return _submit(
            lambda: ivf_ops.top_k_device(uploaded, q, k, cosine=cosine, nprobe=nprobe),
            uploaded,
            lambda v, i, ev, keep: TopNHandle(v, i, ev, keep),
        )
    dl = _auto_download_dtype(uploaded)
    return _submit(
        lambda: top_k_streaming_device(uploaded, q, k, cosine=cosine, download_dtype=dl),
        uploaded,
        lambda v, i, ev, keep: TopNHandle(v, i, ev, keep),
    )


def submit_top_k_multi(
    uploaded,
    queries: np.ndarray,
    k: int,
    cosine: bool = False,
    scan_batch: int = 256,
    nprobe: int | None = None,
) -> MultiTopNHandle:
    """ceil(n / scan_batch) full-matrix scans submitted at once; one
    handle collects them all. An IVF handle takes the whole batch at once
    (it groups the queries itself), at ``nprobe`` when given."""
    q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    if isinstance(uploaded, IVFIndex):
        return _submit(
            lambda: ivf_ops.top_k_device(uploaded, q, k, cosine=cosine, nprobe=nprobe),
            uploaded,
            lambda v, i, ev, keep: MultiTopNHandle(v, i, q.shape[0], ev, keep),
        )
    q_kb, n = _group_pad(q, scan_batch)
    dl = _auto_download_dtype(uploaded)
    return _submit(
        lambda: top_k_streaming_device_multi(uploaded, q_kb, k, cosine=cosine, download_dtype=dl),
        uploaded,
        lambda v, i, ev, keep: MultiTopNHandle(v, i, n, ev, keep),
    )


def submit_top_k_multi_indexed(
    uploaded,
    x_dev: torch.Tensor,
    indices: np.ndarray,
    k: int,
    cosine: bool = False,
    scan_batch: int = 256,
    nprobe: int | None = None,
) -> MultiTopNHandle:
    """submit_top_k_multi with the query vectors already on the card: the
    host ships int32 row indices into ``x_dev`` and the gather runs on
    the card ahead of the scans."""
    idx = np.atleast_1d(np.asarray(indices, dtype=np.int32))
    if isinstance(uploaded, IVFIndex):
        return _submit(
            lambda: ivf_ops.top_k_device_indexed(
                uploaded, x_dev, idx, k, cosine=cosine, nprobe=nprobe
            ),
            uploaded,
            lambda v, i, ev, keep: MultiTopNHandle(v, i, len(idx), ev, keep),
            keep=(x_dev,),
        )
    idx_kb, n = _group_pad(idx, scan_batch)
    dl = _auto_download_dtype(uploaded)
    return _submit(
        lambda: top_k_streaming_device_multi_indexed(
            uploaded, x_dev, idx_kb, k, cosine=cosine, download_dtype=dl
        ),
        uploaded,
        lambda v, i, ev, keep: MultiTopNHandle(v, i, n, ev, keep),
        keep=(x_dev,),
    )
