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

Not ported yet: ``upload_sharded`` / ``top_k_sharded`` and
``upload_random``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from oryx_tpu_torch.device import resolve
from oryx_tpu_torch.ops import ivf as ivf_ops
from oryx_tpu_torch.ops.ivf import IVFIndex
from oryx_tpu_torch.ops.streaming_topn import (
    StreamingItemMatrix,
    _quantize_residual,
    _quantize_rows,
    top_k_streaming,
    top_k_streaming_device,
    top_k_streaming_device_multi,
    top_k_streaming_device_multi_indexed,
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
    else:
        idx, vals = top_k_streaming(uploaded, query, k, cosine=cosine)
    return idx[0], vals[0]


def top_k_scores_batch(uploaded, queries: np.ndarray, k: int, cosine: bool = False):
    """Batched top-k for [b, k] query vectors; b > 256 takes the
    candidates kernel."""
    if isinstance(uploaded, IVFIndex):
        return ivf_ops.top_k(uploaded, queries, k, cosine=cosine)
    return top_k_streaming(uploaded, queries, k, cosine=cosine)


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
