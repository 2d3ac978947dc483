"""Streaming item scan + top-k for ALS serving (counterpart of
``oryx_tpu/ops/pallas_topn.py``).

The serving hot loop scores every item against the query vectors and
keeps the best k. The item plane lives on the card feature-major,
``[k_feat, n_pad]`` (float32, bfloat16, or row-quantized int8 plus an
int8 residual plane), padded to a ``BLOCK_N`` multiple exactly as the
JAX package pads it, so capacities and quantization codes agree between
the two packages bit for bit.

The scan itself runs in hand-written CUDA kernels (``csrc/topn.cu``):

- ``topn_scan`` (replaces ``pallas_topn._topn_kernel``, B1) for scan
  batches of at most ``LOCAL_TOPK_BATCH`` rows, followed by
  ``topn_merge`` across the scan's item splits;
- ``topn_candidates`` (replaces ``pallas_topn._topn_candidates_kernel``,
  B2) for larger batches, followed by the same ``topn_merge``.

Both scan on the tensor cores (wgmma) for every plane type; the launch
counts name the path (``topn_scan.tc`` for bfloat16 and int8 planes,
``topn_scan.tc_f32`` for float32 ones, ...). An int8 plane scores the
float32 query exactly, as three bfloat16 pieces; a float32 plane splits
its items alike and scores at float32 accuracy (six bfloat16 passes, as
the JAX package's ``Precision.HIGHEST``); a bfloat16 plane scores the
query rounded to bfloat16, in the kernel and in its plain version
alike. A plane of any feature count scans: past 1,024 features the
query pieces no longer stay in shared memory for the whole scan but
stream through the kernel's ring beside the items (``ScanPlan.streamed``).

Each kernel has a plain PyTorch version of the same function here
(``*_plain``). A wrapper runs the plain version only for tensors on the
CPU (the tests); for a CUDA tensor it launches the kernel or raises.
Around the kernels — the int8 residual rescore, the large-k
materialized scan and the download rounding — the code is plain
PyTorch, as it was XLA in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from oryx_tpu_torch.device import resolve

# Items per padding block: the plane's column count is a multiple of it
# (pallas_topn.BLOCK_N), so capacity() agrees with the JAX package.
BLOCK_N = 16384

# Scan batches past this row count take the block-local candidates
# kernel (B2) instead of the running-list kernel (B1), as in the JAX
# package; both give the same answer.
LOCAL_TOPK_BATCH = 256

# Oversampling factor for quantized scans: the int8 plane ranks the scan,
# then the top (RESCORE_OVERSAMPLE * k) candidates are re-scored against
# the residual plane before the final top-k. 0 disables rescoring.
RESCORE_OVERSAMPLE = 4

# above this k the kernels' top-m lists stop fitting the design; one
# materialized matmul + stable sort takes the wide selection instead
MAX_KERNEL_K = 128

# Items per CTA of the candidates kernel (B2): one block of the plane.
CANDIDATE_BLOCK = BLOCK_N

# int8 planes pad their feature count to a 32 multiple (zero-filled;
# queries pad alike) so codes match the JAX package's layout
_INT8_FEAT_MULTIPLE = 32

# items per CTA tile of the scan in csrc/topn.cu
_TC_TILE_ITEMS = 128


def configure_scan(*, oversample: int | None = None) -> None:
    """Apply ``oryx.serving.scan.oversample`` at serving-layer startup.
    The JAX package's ``chunk`` and ``block`` tune its CPU-only XLA twin
    of the scan, which the port does not have (on the CPU it runs the
    plain versions of the kernels)."""
    global RESCORE_OVERSAMPLE
    if oversample is not None:
        RESCORE_OVERSAMPLE = int(oversample)


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a dtype named as torch, numpy or a string."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    if "bfloat16" in name:
        return torch.bfloat16
    name = np.dtype(dtype).name
    return {"float32": torch.float32, "int8": torch.int8}[name]


@dataclass(frozen=True)
class StreamingItemMatrix:
    """Card-resident item factors in the kernels' feature-major layout."""

    mat_t: torch.Tensor  # [k_feat(_pad), n_padded]; f32, bf16, or int8 codes
    norms: torch.Tensor  # [1, n_padded] f32 (L2 norms of the ORIGINAL f32 rows)
    n_items: int
    # int8 handles only: per-item dequantization scale (absmax/127, f32,
    # 1.0 for all-zero rows)
    scales: torch.Tensor | None = None
    # true feature count before int8 padding (None = no padding)
    features: int | None = None
    # int8 handles only: residual plane — int8 codes of (row - codes * s)
    # with its own per-row scale; only scan candidates gather it
    resid: torch.Tensor | None = None
    resid_scales: torch.Tensor | None = None

    @property
    def num_features(self) -> int:
        return self.features if self.features is not None else self.mat_t.shape[0]

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @property
    def device(self) -> torch.device:
        return self.mat_t.device


def _quantize_rows(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise symmetric int8: q = rint(row / s), s = absmax/127 (1.0 for
    all-zero rows) — the JAX package's rule, so codes agree bit for bit."""
    absmax = np.max(np.abs(mat), axis=1)
    s = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(mat / s[:, None]), -127, 127).astype(np.int8)
    return q, s


def _quantize_residual(
    mat: np.ndarray, q: np.ndarray, s: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Second int8 plane: quantize what the first plane dropped
    (``row - q * s``) with its own per-row absmax/127 scale."""
    r = mat - q.astype(np.float32) * s[:, None]
    am = np.max(np.abs(r), axis=1)
    s2 = np.where(am > 0, am / 127.0, 1.0).astype(np.float32)
    q2 = np.clip(np.rint(r / s2[:, None]), -127, 127).astype(np.int8)
    return q2, s2


def upload_streaming(
    matrix: np.ndarray, dtype=torch.float32, device=None
) -> StreamingItemMatrix:
    """Pad items up to a BLOCK_N multiple and move [k, n] to the card.

    ``dtype=torch.int8`` row-quantizes: int8 codes plus one f32 scale per
    item, and a residual plane for the candidate rescore."""
    device = resolve(device)
    dtype = torch_dtype(dtype)
    n, k_feat = matrix.shape
    n_pad = max(BLOCK_N, _ceil_to(n, BLOCK_N))
    mat = np.asarray(matrix, dtype=np.float32)
    norms = np.zeros((1, n_pad), dtype=np.float32)
    norms[0, :n] = np.linalg.norm(mat, axis=1)
    if dtype == torch.int8:
        q, s = _quantize_rows(mat)
        q2, s2 = _quantize_residual(mat, q, s)
        kf_pad = _ceil_to(k_feat, _INT8_FEAT_MULTIPLE)
        mat_t = np.zeros((kf_pad, n_pad), dtype=np.int8)
        mat_t[:k_feat, :n] = q.T
        resid = np.zeros((kf_pad, n_pad), dtype=np.int8)
        resid[:k_feat, :n] = q2.T
        scales = np.ones((1, n_pad), dtype=np.float32)
        scales[0, :n] = s
        rscales = np.ones((1, n_pad), dtype=np.float32)
        rscales[0, :n] = s2
        return handle_from_numpy(
            mat_t, norms, n, scales=scales, resid=resid, resid_scales=rscales,
            features=k_feat if kf_pad != k_feat else None, device=device,
        )
    mat_t = np.zeros((k_feat, n_pad), dtype=np.float32)
    mat_t[:, :n] = mat.T
    return StreamingItemMatrix(
        mat_t=torch.from_numpy(mat_t).to(device=device, dtype=dtype),
        norms=torch.from_numpy(norms).to(device),
        n_items=n,
    )


def handle_from_numpy(
    mat_t: np.ndarray,
    norms: np.ndarray,
    n_items: int,
    scales: np.ndarray | None = None,
    resid: np.ndarray | None = None,
    resid_scales: np.ndarray | None = None,
    features: int | None = None,
    device=None,
) -> StreamingItemMatrix:
    """A handle over planes given as numpy arrays — e.g. the arrays of a
    JAX ``StreamingItemMatrix`` — so two packages scan identical bytes.
    A bfloat16 plane may come as ``ml_dtypes.bfloat16`` or as float32
    holding bf16 values; ``mat_t``'s dtype decides the handle's dtype."""
    device = resolve(device)

    def put(a, dtype=None):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).astype(np.int32) << 16).view(torch.float32)
            return t.to(device=device, dtype=torch.bfloat16)
        t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
        return t.to(device=device, dtype=dtype or t.dtype)

    return StreamingItemMatrix(
        mat_t=put(mat_t),
        norms=put(norms, torch.float32),
        n_items=int(n_items),
        scales=put(scales, torch.float32),
        features=features,
        resid=put(resid),
        resid_scales=put(resid_scales, torch.float32),
    )


def _fold_aux(norms, scales, cosine: bool):
    """The kernels' aux row: item norms (unquantized) or the folded
    dequant multiplier (quantized — cosine divides the norms into the
    per-row scale here, so scoring is one multiply either way)."""
    if scales is None:
        return norms
    if cosine:
        return scales / torch.clamp_min(norms, 1e-12)
    return scales


def _pad_queries(q: torch.Tensor, k_feat: int) -> torch.Tensor:
    # int8 feature padding: zero features cannot change any score
    if q.shape[1] < k_feat:
        q = torch.nn.functional.pad(q, (0, k_feat - q.shape[1]))
    return q


def _scan_k(k: int, n_items: int, resid) -> int:
    """Candidates the scan keeps per query before the residual rescore
    trims back to k, capped at MAX_KERNEL_K so it stays on the kernels."""
    if resid is None or RESCORE_OVERSAMPLE <= 1:
        return k
    m = min(max(RESCORE_OVERSAMPLE * k, 32), MAX_KERNEL_K, n_items)
    return max(m, k)


def _stable_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1 with ties to the lowest index (lax.top_k's rule;
    torch.topk promises no tie order on CUDA)."""
    v, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _rescore_topk(vals, idxs, q, qn, resid, resid_scales, norms, *, k, cosine):
    """Trim oversampled int8 candidates to the final top-k by adding the
    residual plane's contribution for just those candidates. Candidates
    are re-sorted by item id first so the stable top-k keeps breaking
    ties toward the lowest index."""
    order = torch.argsort(idxs, dim=1)
    ii = torch.gather(idxs, 1, order).long()  # [b, m] ascending ids
    vv = torch.gather(vals, 1, order)
    cand = resid[:, ii].float()  # [kf, b, m]
    corr = torch.einsum("bf,fbm->bm", q, cand)
    aux2 = resid_scales[0]
    if cosine:
        aux2 = aux2 / torch.clamp_min(norms[0], 1e-12)
    corr = corr * aux2[ii]
    if cosine:
        corr = corr / torch.clamp_min(qn, 1e-12)
    # padding candidates carry -inf from the scan; keep them out
    sc = torch.where(torch.isfinite(vv), vv + corr, torch.full_like(vv, -math.inf))
    v, pos = _stable_topk(sc, k)
    return v, torch.gather(ii, 1, pos).to(torch.int32)


def _materialized_topk(up: StreamingItemMatrix, queries: torch.Tensor, k: int, cosine: bool):
    """Large-k scan (k > MAX_KERNEL_K) over the same layout: materialize
    [b, n] scores once, then one stable sort. Quantized handles sum both
    planes in full."""
    quantized = up.scales is not None
    q = queries.float()
    if not quantized:
        q = q.to(up.mat_t.dtype).float()  # bf16 planes score bf16 queries
    q = _pad_queries(q, up.mat_t.shape[0])
    scores = q @ up.mat_t.float()
    if quantized:
        scores = scores * up.scales
        if up.resid is not None:
            scores = scores + (q @ up.resid.float()) * up.resid_scales
    if cosine:
        qn = torch.linalg.vector_norm(queries.float(), dim=1, keepdim=True)
        scores = scores / torch.clamp_min(up.norms * qn, 1e-12)
    cols = torch.arange(scores.shape[1], device=scores.device)
    scores = torch.where(cols[None, :] < up.n_items, scores, -math.inf)
    v, i = _stable_topk(scores, k)
    return v, i.to(torch.int32)


# -- the kernels and their plain versions -------------------------------------

_launch_lock = threading.Lock()
# one count per kernel and path: "tc" the tensor-core scan on bfloat16
# and int8 planes (one or three bf16 passes), "tc_f32" on float32 planes
# (six)
LAUNCHES = {
    "topn_scan.tc": 0, "topn_scan.tc_f32": 0, "topn_candidates.tc": 0,
    "topn_candidates.tc_f32": 0, "topn_merge": 0,
}
# the scan batches' row counts per kernel and path: {key: {b: launches}}
SCAN_BATCHES: dict[str, dict[int, int]] = {}


def _count(name: str, b: int | None = None) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1
        if b is not None:
            hist = SCAN_BATCHES.setdefault(name, {})
            hist[b] = hist.get(b, 0) + 1


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        SCAN_BATCHES.clear()


def launch_counts() -> dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def scan_batch_histogram() -> dict[str, dict[int, int]]:
    """Launches of each scan path by batch rows since the last reset."""
    with _launch_lock:
        return {name: dict(sorted(h.items())) for name, h in SCAN_BATCHES.items()}


_MODES = {(False, False): 0, (True, False): 1, (False, True): 2, (True, True): 3}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from oryx_tpu_torch.ops import _build

        lib = _build.load("topn")
        scan_args = [_P, _I, _I, _P, _I, _L, _P, _I, _I, _I, _L, _I, _P, _L, _P, _P, _P]
        for name in ("topn_scan", "topn_candidates"):
            fn = getattr(lib, name)
            fn.argtypes = scan_args
            fn.restype = _I
        lib.topn_merge.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P]
        lib.topn_merge.restype = _I
        lib.topn_tc_plan.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_L)]
        lib.topn_tc_plan.restype = _I
        _lib = lib
    return _lib


class ScanPlan(NamedTuple):
    """The scan kernel's plan (csrc/topn.cu ``tc_plan``)."""

    tile: int  # query tile N; 0 if none fits
    stages: int  # ring stages
    smem: int  # dynamic shared memory bytes
    ctas_per_sm: int
    streamed: bool  # the query pieces stream with the items (wide planes)
    scratch_bytes: int  # device memory the streamed pieces come from


def tc_plan(b: int, kf: int, m: int, dtype: torch.dtype) -> ScanPlan:
    """The scan's plan for b queries over kf features keeping m on a
    plane of ``dtype``. Asks the card, so the CUDA context must exist."""
    out = (_L * 6)()
    _kernels().topn_tc_plan(int(b), int(kf), int(m), _KERNEL_DTYPES[dtype], out)
    return ScanPlan(out[0], out[1], out[2], out[3], bool(out[4]), out[5])


def _score_plain(q, mat_t, aux, n_items, cosine, quantized):
    """[b, n_pad] scores in the order of pallas_topn._score_tile, masked
    past n_items. A bfloat16 plane scores the queries rounded to bfloat16
    (their norm too), as the JAX package casts them to the plane's type."""
    q = q.float()
    if mat_t.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).float()
    scores = q @ mat_t.float()
    if quantized:
        scores = scores * aux
        if cosine:
            qn = torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))
            scores = scores / torch.clamp_min(qn, 1e-12)
    elif cosine:
        qn = torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))
        scores = scores / torch.clamp_min(aux * qn, 1e-12)
    cols = torch.arange(scores.shape[1], device=scores.device)
    return torch.where(cols[None, :] < n_items, scores, -math.inf)


def topn_scan_plain(q, mat_t, aux, n_items, m, cosine, quantized):
    """Plain version of topn_scan: the whole plane as one split,
    [1, b, m] values and int32 ids, best first, ties to the lowest id."""
    v, i = _stable_topk(_score_plain(q, mat_t, aux, n_items, cosine, quantized), m)
    return v[None], i.to(torch.int32)[None]


def topn_candidates_plain(q, mat_t, aux, n_items, m, cosine, quantized, block=CANDIDATE_BLOCK):
    """Plain version of topn_candidates: each ``block``-item block's own
    top-m, [blocks, b, m]."""
    scores = _score_plain(q, mat_t, aux, n_items, cosine, quantized)
    b, n_pad = scores.shape
    blocks = n_pad // block
    v, i = torch.sort(
        scores.reshape(b, blocks, block), dim=2, descending=True, stable=True
    )
    base = torch.arange(blocks, device=scores.device)[None, :, None] * block
    ids = (i[:, :, :m] + base).to(torch.int32)
    return v[:, :, :m].permute(1, 0, 2).contiguous(), ids.permute(1, 0, 2).contiguous()


def topn_merge_plain(cand_v, cand_i, m):
    """Plain version of topn_merge: [S, b, m] lists, the s-th covering
    ids below the (s+1)-th's, to the best m per row. Laid out in (list,
    rank) order, a stable sort breaks ties toward the lowest id."""
    s, b, mm = cand_v.shape
    allv = cand_v.permute(1, 0, 2).reshape(b, s * mm)
    alli = cand_i.permute(1, 0, 2).reshape(b, s * mm)
    v, pos = _stable_topk(allv, m)
    return v, torch.gather(alli, 1, pos)


def _check_scan_args(q, mat_t, aux, m):
    """Raise ValueError for what the scan kernels do not take (CUDA
    tensors last, so that the shape rules can be checked anywhere)."""
    if q.dtype != torch.float32 or aux.dtype != torch.float32:
        raise ValueError("queries and aux must be float32")
    if mat_t.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"item plane dtype {mat_t.dtype} is not float32, bfloat16 or int8")
    if q.dim() != 2 or mat_t.dim() != 2 or q.shape[1] != mat_t.shape[0]:
        raise ValueError(f"queries {tuple(q.shape)} do not match plane {tuple(mat_t.shape)}")
    if tuple(aux.shape) != (1, mat_t.shape[1]):
        raise ValueError(f"aux {tuple(aux.shape)} does not match plane {tuple(mat_t.shape)}")
    if mat_t.shape[1] % CANDIDATE_BLOCK:  # whole blocks, hence whole tiles of either scan
        raise ValueError(f"plane width {mat_t.shape[1]} is not a {CANDIDATE_BLOCK} multiple")
    if mat_t.dtype == torch.int8 and mat_t.shape[0] % _INT8_FEAT_MULTIPLE:
        # the tensor-core scan reads int8 codes 32 features at a time
        raise ValueError(
            f"int8 plane has {mat_t.shape[0]} features, not a {_INT8_FEAT_MULTIPLE} multiple"
        )
    if not (q.is_contiguous() and mat_t.is_contiguous() and aux.is_contiguous()):
        raise ValueError("the scan kernels take contiguous tensors")
    if not 1 <= m <= MAX_KERNEL_K:
        raise ValueError(f"m = {m} is outside [1, {MAX_KERNEL_K}]")
    if q.shape[0] < 1:
        raise ValueError("no queries")
    if q.device.type != "cuda":
        raise ValueError(f"the scan kernels take CUDA tensors, not {q.device}")
    for name, t in (("mat_t", mat_t), ("aux", aux)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, queries on {q.device}")


@functools.lru_cache(maxsize=1024)
def _plan(b: int, kf: int, m: int, dtype, device) -> ScanPlan:
    with torch.cuda.device(device):
        plan = tc_plan(b, kf, m, dtype)
    if plan.tile == 0 or plan.ctas_per_sm == 0:
        raise ValueError(f"no query tile of the scan fits kf = {kf}, m = {m}")
    return plan


@functools.lru_cache(maxsize=1024)
def _scan_splits(b: int, n_pad: int, kf: int, m: int, dtype, device) -> tuple[int, int]:
    """(span, splits) of topn_scan: each CTA walks a contiguous run of
    whole tiles, with as many CTAs as the card holds at once (one wave)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = _plan(b, kf, m, dtype, device)
    tiles = n_pad // _TC_TILE_ITEMS
    splits = max(1, min(tiles, math.ceil(plan.ctas_per_sm * sms / math.ceil(b / plan.tile))))
    per = math.ceil(tiles / splits)
    return per * _TC_TILE_ITEMS, math.ceil(tiles / per)


def _launch_scan(name, q, mat_t, aux, n_items, m, mode, span, grid_y):
    b = q.shape[0]
    path = "tc_f32" if mat_t.dtype == torch.float32 else "tc"
    out_v = torch.empty((grid_y, b, m), dtype=torch.float32, device=q.device)
    out_i = torch.empty((grid_y, b, m), dtype=torch.int32, device=q.device)
    # a wide plane's query pieces, split once for the scan to stream
    scratch_bytes = _plan(b, q.shape[1], m, mat_t.dtype, q.device).scratch_bytes
    scratch = (
        torch.empty(scratch_bytes, dtype=torch.uint8, device=q.device) if scratch_bytes else None
    )
    rc = getattr(_kernels(), name)(
        q.data_ptr(), b, q.shape[1], mat_t.data_ptr(), _KERNEL_DTYPES[mat_t.dtype],
        mat_t.shape[1], aux.data_ptr(), int(n_items), int(m), mode, span, grid_y,
        0 if scratch is None else scratch.data_ptr(), scratch_bytes,
        out_v.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _count(f"{name}.{path}", b)
    return out_v, out_i


def topn_scan(q, mat_t, aux, n_items, m, cosine, quantized):
    """B1: per-split top-m lists [splits, b, m] (values f32, ids int32),
    each best first. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return topn_scan_plain(q, mat_t, aux, n_items, m, cosine, quantized)
    _check_scan_args(q, mat_t, aux, m)
    span, splits = _scan_splits(
        q.shape[0], mat_t.shape[1], mat_t.shape[0], m, mat_t.dtype, q.device
    )
    return _launch_scan(
        "topn_scan", q, mat_t, aux, n_items, m, _MODES[(cosine, quantized)], span, splits
    )


def topn_candidates(q, mat_t, aux, n_items, m, cosine, quantized):
    """B2: each CANDIDATE_BLOCK-item block's top-m, [blocks, b, m]. The
    same query rule as topn_scan. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return topn_candidates_plain(q, mat_t, aux, n_items, m, cosine, quantized)
    _check_scan_args(q, mat_t, aux, m)
    return _launch_scan(
        "topn_candidates", q, mat_t, aux, n_items, m, _MODES[(cosine, quantized)],
        CANDIDATE_BLOCK, mat_t.shape[1] // CANDIDATE_BLOCK,
    )


def _check_merge_args(cand_v, cand_i, m):
    """Raise ValueError for what the merge kernel does not take (CUDA
    tensors last, as _check_scan_args)."""
    if cand_v.dtype != torch.float32 or cand_i.dtype != torch.int32:
        raise ValueError("topn_merge takes float32 values and int32 ids")
    if cand_v.dim() != 3 or cand_v.shape != cand_i.shape or cand_v.shape[2] != m:
        raise ValueError(f"candidates {tuple(cand_v.shape)} are not [S, b, {m}]")
    if not 1 <= m <= MAX_KERNEL_K:
        raise ValueError(f"m = {m} is outside [1, {MAX_KERNEL_K}]")
    if min(cand_v.shape) < 1:
        raise ValueError(f"candidates {tuple(cand_v.shape)} are empty")
    if not (cand_v.is_contiguous() and cand_i.is_contiguous()):
        raise ValueError("topn_merge takes contiguous tensors")
    if cand_v.device.type != "cuda" or cand_i.device != cand_v.device:
        raise ValueError(f"topn_merge takes CUDA tensors, not {cand_v.device}")


def topn_merge(cand_v, cand_i, m):
    """[S, b, m] sorted lists -> the best m per row, [b, m]. CPU tensors
    take the plain version."""
    if cand_v.device.type == "cpu":
        return topn_merge_plain(cand_v, cand_i, m)
    _check_merge_args(cand_v, cand_i, m)
    s, b, _ = cand_v.shape
    out_v = torch.empty((b, m), dtype=torch.float32, device=cand_v.device)
    out_i = torch.empty((b, m), dtype=torch.int32, device=cand_v.device)
    rc = _kernels().topn_merge(
        cand_v.data_ptr(), cand_i.data_ptr(), s, b, m, out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(cand_v.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"topn_merge kernel launch failed: CUDA error {rc}")
    _count("topn_merge")
    return out_v, out_i


# -- entry points -------------------------------------------------------------


def _scan_queries(up: StreamingItemMatrix, queries: torch.Tensor, k: int, cosine: bool):
    """(values [b, k] f32, ids [b, k] int32) on the plane's device for f32
    queries already there (pallas_topn._streaming_topk_impl)."""
    if k > MAX_KERNEL_K:
        return _materialized_topk(up, queries, k, cosine)
    k_feat = up.mat_t.shape[0]
    quantized = up.scales is not None
    q = _pad_queries(queries.float(), k_feat).contiguous()
    aux = _fold_aux(up.norms, up.scales, cosine).contiguous()
    m = _scan_k(k, up.n_items, up.resid)
    scan = topn_candidates if q.shape[0] > LOCAL_TOPK_BATCH else topn_scan
    vals, idxs = topn_merge(*scan(q, up.mat_t, aux, up.n_items, m, cosine, quantized), m)
    if up.resid is None or RESCORE_OVERSAMPLE <= 1:
        return vals, idxs
    qn = torch.linalg.vector_norm(q, dim=1, keepdim=True) if cosine else None
    return _rescore_topk(
        vals, idxs, q, qn, up.resid, up.resid_scales, up.norms, k=k, cosine=cosine
    )


def _as_queries(queries, device) -> torch.Tensor:
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=device, dtype=torch.float32)
    else:
        q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(device)
    return q[None] if q.dim() == 1 else q


def _download(vals, download_dtype):
    return vals.to(torch_dtype(download_dtype)) if download_dtype is not None else vals


def top_k_streaming_device(
    up: StreamingItemMatrix, queries, k: int, cosine: bool = False, download_dtype=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [b, k], ids [b, k]) as tensors on the plane's device, for
    [b, feat] (or [feat]) queries. ``download_dtype`` rounds the returned
    scores; selection always runs in float32."""
    k = max(1, min(int(k), up.n_items))
    vals, idxs = _scan_queries(up, _as_queries(queries, up.device), k, cosine)
    return _download(vals, download_dtype), idxs


def top_k_streaming_device_multi(
    up: StreamingItemMatrix, queries_kb, k: int, cosine: bool = False, download_dtype=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [K, b, k], ids [K, b, k]) for [K, b, feat] query groups:
    one scan per group."""
    k = max(1, min(int(k), up.n_items))
    q_kb = _as_queries(queries_kb, up.device)
    outs = [_scan_queries(up, q_kb[g], k, cosine) for g in range(q_kb.shape[0])]
    vals = torch.stack([v for v, _ in outs])
    return _download(vals, download_dtype), torch.stack([i for _, i in outs])


def top_k_streaming_device_multi_indexed(
    up: StreamingItemMatrix,
    x_dev: torch.Tensor,
    idx_kb,
    k: int,
    cosine: bool = False,
    download_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [K, b, k], ids [K, b, k]) for [K, b] row indices into the
    card-resident query matrix ``x_dev``: each group's vectors are
    gathered on the card, so only indices cross the bus."""
    k = max(1, min(int(k), up.n_items))
    if not isinstance(idx_kb, torch.Tensor):
        idx_kb = torch.from_numpy(np.asarray(idx_kb, dtype=np.int64))
    idx_kb = idx_kb.to(device=up.device, dtype=torch.long)
    outs = [
        _scan_queries(up, x_dev[idx_kb[g]].float(), k, cosine) for g in range(idx_kb.shape[0])
    ]
    vals = torch.stack([v for v, _ in outs])
    return _download(vals, download_dtype), torch.stack([i for _, i in outs])


def top_k_streaming(
    up: StreamingItemMatrix, queries, k: int, cosine: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """(ids [b, k], scores [b, k]) of the best items per query row."""
    vals, idxs = top_k_streaming_device(up, queries, k, cosine=cosine)
    return idxs.cpu().numpy(), vals.cpu().numpy()
