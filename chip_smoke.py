#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``oryx_tpu_torch``) runs on the GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each printing one JSON line:

1. card and build: the card, torch and CUDA versions, and the seconds
   ``nvcc`` took to build the kernels from ``oryx_tpu_torch/csrc``;
2. kernels: every kernel of the serving path (``topn_scan`` and
   ``topn_candidates`` on the tensor cores for every plane type,
   ``topn_merge``) against its plain PyTorch version on the same inputs,
   at 1,000,000 items x 250 features, dot and cosine: float32, bfloat16
   and int8 at every batcher bucket (b = 8 to 256), and the candidates
   kernel at b = 512; planted exact ties (duplicated item columns) must
   come back in lowest-id order; the widest query tile (N = 128) at
   b = 128 and 256 on a 50-feature plane (bfloat16, int8) and a
   10-feature one (float32); wide planes of 1,056, 2,048 and 4,096
   features x 262,144 items, whose query pieces stream beside the items,
   every plane type, topn_scan at b = 8 and 256 and topn_candidates at
   b = 512, dot and cosine, on the ``tc`` / ``tc_f32`` launch keys; the
   merge bit for bit on synthetic lists
   (S = 1 to 1221 lists, m = 1 to 128, b = 1 and 512, padding, equal
   values across lists); with CUDA-event times of the kernel (on the
   device alone, and calls back to back), the plain version and two
   PyTorch library yardsticks that the port never calls
   (``torch.matmul`` with a stable ``torch.sort``; ``torch.matmul`` in
   the plane's working type with ``torch.topk``);
3. serving, int8: the port's ServingLayer fed MODEL + UP messages over
   the update topic and bulk-loaded with 1,000,000 items and users,
   answering concurrent /recommend (index submit through the batcher),
   /recommendToAnonymous, /similarity and /estimate; /recommend recall@10
   against an exact float32 scan on the card must reach 0.99, and so
   must a 512-query batch through ``topn.top_k_scores_batch`` (the
   candidates kernel); every scan takes the ``tc`` path;
4. serving, float32, on the same factors: /recommend ids must equal the
   exact top-10 (ties to the lowest id), and a 512-query batch through
   ``topn.top_k_scores_batch`` (the candidates kernel) must too; every
   scan takes the ``tc_f32`` path (six bf16 passes);
5. kmeans-kernels: the Lloyd sweep (``pallas_kmeans.sweep``, one launch
   of ``kmeans_sweep.tc``) against its plain version on Gaussian blobs at
   200,000 x 20 (k = 10, the repo's k-means shape), 10,000,000 x 20
   (k = 10) and 1,000,000 x 256 (k = 256), and at the shapes of the
   kernel's other paths: 100,000 x 7 (k = 5: d * 4 not a multiple of 16,
   also from an address that is not 16-byte aligned), 200,000 x 32
   (k = 300: more centers than one tile of 256), 200,000 x 768 (k = 10)
   and 50,000 x 601 (k = 300: rows staged in chunks) and 20,000 x 16
   (k = 10,000): counts equal but for near ties (two smallest
   distances within 1e-5 relative), sums within rtol 1e-5 of max |sum|
   (plus the near ties' share), cost within rtol 1e-5, two launches bit
   for bit, NaN and inf rows to no center; with CUDA-event times of the
   sweep (on the device alone, and calls back to back), its plain version
   and a PyTorch yardstick that the port never calls (f32 matmul
   distances, ``torch.min``, ``index_add_``, ``bincount``);
6. kmeans-batch: the port's BatchLayer with KMeansUpdate on an inproc
   bus (reference.conf defaults: 30 iterations, 3 runs, k-means||,
   SILHOUETTE, test-fraction 0.1) trains on 200,000 CSV points of 20
   features in 10 blobs; the port's ServingLayer answers /assign and
   /distanceToNearest for 1,000 sampled points exactly as a float64
   numpy nearest-center search does, and every true blob center has a
   trained center within 0.5; a second generation with mini-batch size
   10,000 warm-starts from the champion under the same checks;
7. kmeans-lambda: the k-means lambda loop as three OS processes
   (``python -m oryx_tpu_torch batch|speed|serving``) on one ``file:``
   bus: wave 1, the phase-6 training set (200,000 x 20, k = 10), POSTed
   to serving's /add and trained by the batch process (which must have
   launched ``kmeans_sweep.tc``, read from its metrics UI), served as in
   phase 6; the batch process is then stopped, so that its next
   generation cannot replace the speed layer's folds; wave 2, 20,000
   points around blob 0 moved by +1.0 in every feature, folded by the
   speed process and served as the float64 running mean (within 1e-9
   relative); the speed process restarted; wave 3, 20,000 more, with
   every cluster's count the model's plus waves 2 and 3 (nothing
   consumed twice or lost); with the generation and micro-batch
   seconds and each wave's staleness (last POST to serving's answer);
8. the kernel table: launches on the main paths (ALS during phases 3-4,
   k-means during phase 6, each counted from zero just before; the scans
   also by batch rows, per path) and the numbers of phases 2 and 5;
9. the card's name and power limit, then ``{"ok": true, "device": ...}``.

Any failure raises and the exit code is not 0. Without CUDA, or run
from a directory that holds no ``oryx_tpu_torch``, it exits 2 before
printing any result. Weights are random, made from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# peak operations per second by the type of the function's product (see
# kernel_bound()); float32 is the least time of an f32-accurate product
# on this card: six bf16 tensor-core passes over three-piece splits of
# both operands, the TPU's Precision.HIGHEST
PEAK_OPS = {"float32": 989e12 / 6, "bfloat16": 989e12, "int8": 989e12}
SOURCES = {
    "topn_scan.tc": "oryx_tpu_torch/csrc/topn.cu",
    "topn_scan.tc_f32": "oryx_tpu_torch/csrc/topn.cu",
    "topn_merge": "oryx_tpu_torch/csrc/topn.cu",
    "topn_candidates.tc": "oryx_tpu_torch/csrc/topn.cu",
    "topn_candidates.tc_f32": "oryx_tpu_torch/csrc/topn.cu",
    "kmeans_sweep.tc": "oryx_tpu_torch/csrc/kmeans.cu",
}
REPLACES = {
    "topn_scan.tc": "oryx_tpu/ops/pallas_topn.py:300",
    "topn_scan.tc_f32": "oryx_tpu/ops/pallas_topn.py:300",
    "topn_merge": "oryx_tpu/ops/pallas_topn.py:300",
    "topn_candidates.tc": "oryx_tpu/ops/pallas_topn.py:364",
    "topn_candidates.tc_f32": "oryx_tpu/ops/pallas_topn.py:364",
    "kmeans_sweep.tc": "oryx_tpu/ops/pallas_kmeans.py:59",
}
RTOL = 1e-5
# batch rows of the phase-2 scans: the batcher's buckets (serving/batcher.py
# _b_bucket, up to LOCAL_TOPK_BATCH), and one batch past them
SCAN_BATCHES = (8, 16, 32, 64, 128, 256)
CANDIDATES_BATCH = 512
# the wide scans: feature counts past the 1,024 whose query pieces stay
# resident in shared memory, on planes of this many items
WIDE_FEATURES = (1056, 2048, 4096)
WIDE_ITEMS = 262_144
WIDE_RUNS = ((8, "topn_scan"), (256, "topn_scan"), (CANDIDATES_BATCH, "topn_candidates"))
# the merge check's synthetic shapes: lists (1221 = the candidates kernel's
# blocks at 20M items), list length and rows
MERGE_LISTS = (1, 2, 7, 33, 1221)
MERGE_M = (1, 16, 64, 128)
MERGE_ROWS = (1, CANDIDATES_BATCH)
# (points, features, clusters) of the k-means kernel phase; the first is
# the repo's k-means training shape (tools/train_benchmark.py:161-170)
KMEANS_SHAPES = ((200_000, 20, 10), (10_000_000, 20, 10), (1_000_000, 256, 256))
# shapes that take the kernel's other paths: d * 4 not a multiple of 16
# (checked from an unaligned address too), kp > 256 (two center tiles),
# rows too wide for a whole 64-point tile in shared memory (staged in
# chunks; 601 features also by 4-byte copies, with two center tiles), and
# more centers than |c|^2 keeps in shared memory
KMEANS_EXTRA_SHAPES = (
    (100_000, 7, 5), (200_000, 32, 300), (200_000, 768, 10), (50_000, 601, 300),
    (20_000, 16, 10_000),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--items", type=int, default=1_000_000)
    p.add_argument("--users", type=int, default=1_000_000)
    p.add_argument("--features", type=int, default=250)
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--concurrency", type=int, default=64)
    p.add_argument("--seed", type=int, default=7)
    return p.parse_args(argv)


def factors(gen, rows: int, features: int) -> np.ndarray:
    """Random ALS factors, N(0, 1/features) so that scores are near 1."""
    return gen.standard_normal((rows, features), dtype=np.float32) * (1.0 / np.sqrt(features))


def full_float32(torch) -> None:
    """The float32 references (plain versions, exact_top) in full float32,
    never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(log) -> list[str]:
    """Each kernel of the build log (``-Xptxas -v``) with its registers,
    stack frame and spills, as 'kernel<template args>: ...'."""
    out, name, frame = [], None, ""
    for _, line in log:
        if "Compiling entry function" in line:
            found = re.search(r"\d+([a-z_]+_kernel)(I(?:Li\d+E)+E)?", line)
            args = re.findall(r"Li(\d+)E", found.group(2) or "")
            name = found.group(1) + (f"<{','.join(args)}>" if args else "")
        elif "stack frame" in line:
            frame = line
        elif line.startswith("ptxas info    : Used") and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {frame}")
            name, frame = None, ""
    return out


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int) -> float:
    """CUDA-event time of reps launches of fn on the device alone: a sleep
    kernel holds the stream while the host queues all of them, so the
    host's own time per call (Python, the wrapper's checks) does not
    count, as it does in time_ms when the host is the slower side."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_topk(what, got_v, got_i, ref_v, ref_i, rtol=RTOL) -> float:
    """Values within rtol*|ref| + rtol*max|ref|; ids identical except at
    positions whose reference score lies within that tolerance of a
    neighbour (a near-tie the two summation orders may break apart).
    Returns the largest absolute value difference."""
    gv, gi = np.asarray(got_v, np.float64), np.asarray(got_i)
    rv, ri = np.asarray(ref_v, np.float64), np.asarray(ref_i)
    if gv.shape != rv.shape or gi.shape != ri.shape:
        raise AssertionError(f"{what}: shapes {gv.shape} vs {rv.shape}")
    if not np.isfinite(gv).all():
        raise AssertionError(f"{what}: non-finite values")
    err = np.abs(gv - rv)
    tol = rtol * np.abs(rv) + rtol * float(np.abs(rv).max())
    if (err > tol).any():
        raise AssertionError(f"{what}: max |err| {err.max()} exceeds tolerance")
    near = np.zeros(ri.shape, bool)
    near[:, 1:] |= np.abs(rv[:, 1:] - rv[:, :-1]) <= tol[:, 1:]
    near[:, :-1] |= np.abs(rv[:, :-1] - rv[:, 1:]) <= tol[:, :-1]
    near[:, -1] = True
    bad = (gi != ri) & ~near
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise AssertionError(f"{what}: id {gi[r, c]} != {ri[r, c]} at row {r} rank {c}")
    return float(err.max())


def kernel_bound(dtype: str, b: int, kf: int, n: int, out_bytes: int) -> tuple[float, str]:
    """Least time for a scan: the bytes it must move (item plane at its
    dtype, the aux row, the queries, the outputs) over 3.35 TB/s against
    2*b*kf*n operations over the peak for their type. float32 planes
    score at float32 accuracy, as the TPU kernel does at
    Precision.HIGHEST; the fastest such product on this card is six
    bfloat16 tensor-core passes (989/6 TFLOP/s). bfloat16 and int8
    planes score a bfloat16 product with float32 accumulation, as the TPU
    kernel does (int8 codes are exact in bfloat16 and take bfloat16 MXU
    passes there), so both count at the bfloat16 tensor-core rate (989
    TFLOP/s), whatever passes the port's kernel makes."""
    item_bytes = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    moved = kf * n * item_bytes + 4 * n + 4 * b * kf + out_bytes
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * kf * n / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2 --------------------------------------------------------------------


def library_sort(torch, q, plane, m):
    """The first yardstick: PyTorch's own matmul and stable sort over the
    whole plane (no aux, no masking); the port never calls it."""
    v, i = torch.sort(torch.matmul(q, plane), dim=1, descending=True, stable=True)
    return v[:, :m], i[:, :m]


def library_topk(torch, q, plane, m):
    """The second yardstick: matmul in the plane's working type and
    torch.topk (no tie order, no aux, no masking); the port never calls
    it."""
    return torch.topk(torch.matmul(q, plane), m, dim=1)


def scan_queries(torch, stn, gen, b: int, features: int, kf: int):
    q = torch.from_numpy(gen.standard_normal((b, features), dtype=np.float32)).cuda()
    return stn._pad_queries(q, kf).contiguous()


def launched(stn, before: dict) -> str:
    """The one launch key whose count grew since ``before`` (a
    ``launch_counts()``): the kernel and path a scan took."""
    grew = [name for name, count in stn.launch_counts().items() if count > before.get(name, 0)]
    if len(grew) != 1:
        raise AssertionError(f"one scan launched {grew}")
    return grew[0]


def phase_kernels(torch, stn, y: np.ndarray, seed: int) -> dict:
    """Every kernel against its plain version on the card; returns, by
    launch key, the record of the representative cases (topn_scan at
    b = 256 and topn_candidates at b = 512, dot: int8 for the ``tc``
    path, float32 for ``tc_f32``; topn_merge after the int8 scan at
    b = 256) with the largest error seen over all cases of that kernel.
    The path of each case is read from the launch counts, so the same
    cases run on another checkout's package (``scan_bench.py --root``)."""
    gen = np.random.default_rng(seed + 1)
    rec: dict[str, dict] = {}
    worst: dict[str, float] = {"topn_merge": 0.0}
    n = y.shape[0]
    k = 16  # the batcher's smallest k bucket
    for dtype in ("float32", "bfloat16", "int8"):
        up = stn.upload_streaming(y, dtype=stn.torch_dtype(dtype), device="cuda")
        quantized = up.scales is not None
        kf = up.mat_t.shape[0]
        m = stn._scan_k(k, n, up.resid)
        sort_plane = up.mat_t.float() if dtype != "bfloat16" else up.mat_t
        work_plane = up.mat_t if dtype != "int8" else up.mat_t.to(torch.bfloat16)
        runs = [(b, "topn_scan") for b in SCAN_BATCHES] + [(CANDIDATES_BATCH, "topn_candidates")]
        for cosine in (False, True):
            aux = stn._fold_aux(up.norms, up.scales, cosine).contiguous()
            for b, kernel in runs:
                q = scan_queries(torch, stn, gen, b, y.shape[1], kf)
                scan = getattr(stn, kernel)
                plain = getattr(stn, kernel + "_plain")
                before = stn.launch_counts()
                cv, ci = scan(q, up.mat_t, aux, n, m, cosine, quantized)
                name = launched(stn, before)
                kv, ki = stn.topn_merge(cv, ci, m)
                pv, pi = stn.topn_merge_plain(*plain(q, up.mat_t, aux, n, m, cosine, quantized), m)
                torch.cuda.synchronize()
                case = f"{kernel} {dtype} {'cosine' if cosine else 'dot'} b={b} m={m}"
                err = check_topk(case, kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())
                worst[name] = max(worst.get(name, 0.0), err)
                # the merge kernel against its plain version on the same lists
                mv, mi = stn.topn_merge_plain(cv, ci, m)
                if not (torch.equal(mv, kv) and torch.equal(mi, ki)):
                    raise AssertionError(f"topn_merge disagrees with its plain version: {case}")
                merge_err = float(torch.where(mv == kv, 0.0, (mv - kv).abs()).max())
                worst["topn_merge"] = max(worst["topn_merge"], merge_err)
                run = lambda: scan(q, up.mat_t, aux, n, m, cosine, quantized)  # noqa: E731
                ms = device_ms(torch, run, 10)
                call_ms = time_ms(torch, run, 10)
                plain_ms = time_ms(
                    torch, lambda: plain(q, up.mat_t, aux, n, m, cosine, quantized), 3
                )
                qs, qw = q.to(sort_plane.dtype), q.to(work_plane.dtype)
                library_ms = time_ms(torch, lambda: library_sort(torch, qs, sort_plane, m), 3)
                library_topk_ms = time_ms(torch, lambda: library_topk(torch, qw, work_plane, m), 3)
                merge_ms = device_ms(torch, lambda: stn.topn_merge(cv, ci, m), 10)
                merge_plain_ms = time_ms(torch, lambda: stn.topn_merge_plain(cv, ci, m), 3)
                flat = cv.permute(1, 0, 2).reshape(b, -1).contiguous()
                merge_lib_ms = time_ms(
                    torch, lambda: torch.sort(flat, dim=1, descending=True, stable=True), 10
                )
                merge_topk_ms = time_ms(torch, lambda: torch.topk(flat, m, dim=1), 10)
                cand_bytes = cv.numel() * 8
                bound_ms, bound_by = kernel_bound(dtype, b, y.shape[1], n, cand_bytes)
                merge_bound = (cand_bytes + b * m * 8) / HBM_BYTES_PER_S * 1e3
                emit({
                    "phase": "kernels", "case": case, "path": name, "lists": int(cv.shape[0]),
                    "max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "library_topk_ms": library_topk_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms,
                    "merge_max_abs_err": merge_err, "merge_ms": merge_ms,
                    "merge_plain_ms": merge_plain_ms, "merge_library_ms": merge_lib_ms,
                    "merge_library_topk_ms": merge_topk_ms, "merge_bound_ms": merge_bound,
                })
                if not cosine and dtype in ("float32", "int8") and b in (256, CANDIDATES_BATCH):
                    rec[name] = dict(
                        ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                        library_topk_ms=library_topk_ms, bound_ms=bound_ms, bound_by=bound_by,
                    )
                    if dtype == "int8" and b == 256:
                        rec["topn_merge"] = dict(
                            ms=merge_ms, plain_ms=merge_plain_ms, library_ms=merge_lib_ms,
                            library_topk_ms=merge_topk_ms, bound_ms=merge_bound,
                            bound_by="bytes",
                        )
                del cv, ci, kv, ki, pv, pi, mv, mi, flat
        del up, sort_plane, work_plane
        torch.cuda.empty_cache()
    check_planted_ties(torch, stn, y, seed)
    check_merge(torch, stn, seed)
    for name in rec:
        rec[name]["max_abs_err"] = worst[name]
    return rec


def check_planted_ties(torch, stn, y: np.ndarray, seed: int) -> None:
    """Exact ties through the scan, every plane type: item 1234 scaled by 3 and
    copied into items 60,000-60,299 of a 131,067-item plane (bit-identical
    columns, so every summation order ties them exactly), and row 0 of
    each query batch is that item, so its whole top-m is the tie run. The
    kernel's ids must be the plain version's exactly (the lowest ids of
    the run, in order), its row-0 values one value; the other rows are
    held to check_topk."""
    gen = np.random.default_rng(seed + 2)
    n, dup = 131_072 - 5, 1234
    yt = y[:n].copy()
    yt[dup] *= 3.0
    yt[60_000:60_300] = yt[dup]
    for dtype in ("float32", "bfloat16", "int8"):
        up = stn.upload_streaming(yt, dtype=stn.torch_dtype(dtype), device="cuda")
        quantized = up.scales is not None
        kf = up.mat_t.shape[0]
        m = stn._scan_k(16, n, up.resid)
        want = [dup] + list(range(60_000, 60_000 + m - 1))
        for cosine in (False, True):
            aux = stn._fold_aux(up.norms, up.scales, cosine).contiguous()
            runs = ((8, "topn_scan"), (64, "topn_scan"), (CANDIDATES_BATCH, "topn_candidates"))
            for b, kernel in runs:
                q = torch.from_numpy(gen.standard_normal((b, y.shape[1]), dtype=np.float32))
                q[0] = torch.from_numpy(yt[dup])
                q = stn._pad_queries(q.cuda(), kf).contiguous()
                scan = getattr(stn, kernel)
                plain = getattr(stn, kernel + "_plain")
                kv, ki = stn.topn_merge(*scan(q, up.mat_t, aux, n, m, cosine, quantized), m)
                pv, pi = stn.topn_merge_plain(*plain(q, up.mat_t, aux, n, m, cosine, quantized), m)
                kv, ki, pv, pi = kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu()
                case = f"planted ties {kernel} {dtype} {'cosine' if cosine else 'dot'} b={b} m={m}"
                if pi[0].tolist() != want:
                    raise AssertionError(f"{case}: the plain version does not see the ties")
                if ki[0].tolist() != want:
                    raise AssertionError(f"{case}: ids {ki[0].tolist()[:8]}... out of id order")
                if len(set(kv[0].tolist())) != 1:
                    raise AssertionError(f"{case}: the tied scores differ in the kernel")
                err = check_topk(case, kv[1:], ki[1:], pv[1:], pi[1:])
                emit({"phase": "kernels", "case": case, "ties_in_lowest_id_order": True,
                      "tied_value": float(kv[0, 0]), "plain_tied_value": float(pv[0, 0]),
                      "other_rows_max_abs_err": err})
        del up
        torch.cuda.empty_cache()


def check_widest_query_tile(torch, stn, n: int, seed: int) -> None:
    """The scan's widest query tile, N = 128, which the 250-feature plane
    never gets (its staged products and candidate buffers leave no room):
    at the reference's narrower published shape, 50 features, a bfloat16
    plane at k = 16 (m = 16) and an int8 plane at k = 8 (m = 32, a direct
    call: the batcher asks for k >= 16); a float32 plane, whose three
    resident query pieces leave room for N = 128 only up to 32 features,
    at the ALS default of 10 features, k = 16. Each takes it at b = 128
    and 256, as ``tc_plan`` must confirm; each case, dot and cosine,
    against its plain version under check_topk."""
    gen = np.random.default_rng(seed + 3)
    planes = {d: factors(gen, n, d) for d in (50, 10)}
    for dtype, k, d in (("bfloat16", 16, 50), ("int8", 8, 50), ("float32", 16, 10)):
        up = stn.upload_streaming(planes[d], dtype=stn.torch_dtype(dtype), device="cuda")
        quantized = up.scales is not None
        kf = up.mat_t.shape[0]
        m = stn._scan_k(k, n, up.resid)
        for b in (128, 256):
            tile = stn.tc_plan(b, kf, m, up.mat_t.dtype)[0]
            if tile != 128:
                raise AssertionError(f"{dtype} b={b} m={m} kf={d} took query tile {tile}, not 128")
            q = scan_queries(torch, stn, gen, b, d, kf)
            for cosine in (False, True):
                aux = stn._fold_aux(up.norms, up.scales, cosine).contiguous()
                case = f"topn_scan {dtype} {'cosine' if cosine else 'dot'} b={b} m={m} kf={d}"
                kv, ki = stn.topn_merge(*stn.topn_scan(q, up.mat_t, aux, n, m, cosine, quantized),
                                        m)
                pv, pi = stn.topn_merge_plain(
                    *stn.topn_scan_plain(q, up.mat_t, aux, n, m, cosine, quantized), m
                )
                err = check_topk(case, kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())
                ms = device_ms(
                    torch, lambda: stn.topn_scan(q, up.mat_t, aux, n, m, cosine, quantized), 10
                )
                bound_ms, bound_by = kernel_bound(dtype, b, d, n, 0)
                emit({"phase": "kernels", "case": case, "query_tile": tile, "max_abs_err": err,
                      "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by})
        del up
        torch.cuda.empty_cache()


def check_wide_scans(torch, stn, seed: int) -> None:
    """The scans past 1,024 features, whose query pieces no longer stay in
    shared memory and stream beside the items (``ScanPlan.streamed``):
    every plane type, dot and cosine, topn_scan at b = 8 and 256 and
    topn_candidates at b = 512, at WIDE_FEATURES x WIDE_ITEMS, each
    against its plain version under check_topk and on the ``tc`` /
    ``tc_f32`` launch key of its plane type, with its device time beside
    kernel_bound() and the matmul + topk yardstick."""
    gen = np.random.default_rng(seed + 5)
    for d in WIDE_FEATURES:
        y = factors(gen, WIDE_ITEMS, d)
        for dtype in ("float32", "bfloat16", "int8"):
            up = stn.upload_streaming(y, dtype=stn.torch_dtype(dtype), device="cuda")
            quantized = up.scales is not None
            kf = up.mat_t.shape[0]
            m = stn._scan_k(16, WIDE_ITEMS, up.resid)
            work_plane = up.mat_t if dtype != "int8" else up.mat_t.to(torch.bfloat16)
            path = "tc_f32" if dtype == "float32" else "tc"
            for cosine in (False, True):
                aux = stn._fold_aux(up.norms, up.scales, cosine).contiguous()
                for b, kernel in WIDE_RUNS:
                    q = scan_queries(torch, stn, gen, b, d, kf)
                    scan = getattr(stn, kernel)
                    plain = getattr(stn, kernel + "_plain")
                    case = f"wide {kernel} {dtype} {'cosine' if cosine else 'dot'} b={b} m={m} kf={d}"
                    plan = stn.tc_plan(b, kf, m, up.mat_t.dtype)
                    if not plan.streamed:
                        raise AssertionError(f"{case}: the plan keeps the query resident: {plan}")
                    before = stn.launch_counts()
                    cv, ci = scan(q, up.mat_t, aux, WIDE_ITEMS, m, cosine, quantized)
                    name = launched(stn, before)
                    if name != f"{kernel}.{path}":
                        raise AssertionError(f"{case}: took {name}, not {kernel}.{path}")
                    kv, ki = stn.topn_merge(cv, ci, m)
                    pv, pi = stn.topn_merge_plain(
                        *plain(q, up.mat_t, aux, WIDE_ITEMS, m, cosine, quantized), m
                    )
                    torch.cuda.synchronize()
                    err = check_topk(case, kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())
                    del kv, ki, pv, pi
                    ms = device_ms(
                        torch, lambda: scan(q, up.mat_t, aux, WIDE_ITEMS, m, cosine, quantized), 5
                    )
                    qw = q.to(work_plane.dtype)
                    library_topk_ms = time_ms(
                        torch, lambda: library_topk(torch, qw, work_plane, m), 3
                    )
                    bound_ms, bound_by = kernel_bound(dtype, b, d, WIDE_ITEMS, cv.numel() * 8)
                    emit({
                        "phase": "kernels", "case": case, "path": name,
                        "plan": {"query_tile": plan.tile, "stages": plan.stages,
                                 "streamed": plan.streamed},
                        "max_abs_err": err, "ms": ms, "library_topk_ms": library_topk_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms,
                    })
                    del cv, ci, qw
            del up, work_plane
            torch.cuda.empty_cache()
        del y


def merge_lists(torch, gen, s: int, b: int, m: int):
    """[S, b, m] lists as the scans leave them: each best first, values on
    a coarse grid (so equal values meet within and across lists), ids of
    list s below list s + 1's and ascending among equal values, each list
    ending in a random run of (-inf, INT_MAX) padding (whole lists
    included); at b > 1, row 1 holds a single value in every list and
    row 0 is padding but for the first half of list 0, so that padding
    reaches the merged list."""
    dev = "cuda"
    # + 0.0 leaves no -0.0, which the ordering of one sort or another may
    # set apart from 0.0
    v = torch.round(torch.randn((s, b, m), generator=gen, device=dev) * 2) / 4 + 0.0
    v = torch.sort(v, dim=2, descending=True).values
    rank = torch.arange(m, device=dev)
    ids = (torch.arange(s, device=dev)[:, None, None] * m + rank).expand(s, b, m)
    kept = m - torch.randint(0, m + 1, (s, b, 1), generator=gen, device=dev)
    if b > 1:
        v[:, 1] = 0.5
        kept[:, 0] = 0
        kept[0, 0] = m // 2
    v = torch.where(rank >= kept, -math.inf, v)
    ids = torch.where(rank >= kept, 2**31 - 1, ids)
    return v.contiguous(), ids.to(torch.int32).contiguous()


def check_merge(torch, stn, seed: int) -> None:
    """topn_merge bit for bit against topn_merge_plain on synthetic lists
    (merge_lists) at every S of MERGE_LISTS, m of MERGE_M and b of
    MERGE_ROWS; at b = 512 with its time beside both yardsticks (a stable
    torch.sort and torch.topk over the flattened lists, which the port
    never calls) and its byte bound."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 4)
    for s in MERGE_LISTS:
        for m in MERGE_M:
            for b in MERGE_ROWS:
                cv, ci = merge_lists(torch, gen, s, b, m)
                kv, ki = stn.topn_merge(cv, ci, m)
                pv, pi = stn.topn_merge_plain(cv, ci, m)
                case = f"topn_merge S={s} b={b} m={m}"
                if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
                    raise AssertionError(f"{case}: disagrees with its plain version")
                out = {"phase": "kernels", "case": case, "bit_identical": True}
                if b > 1:
                    flat = cv.permute(1, 0, 2).reshape(b, -1).contiguous()
                    out.update(
                        ms=device_ms(torch, lambda: stn.topn_merge(cv, ci, m), 10),
                        plain_ms=time_ms(torch, lambda: stn.topn_merge_plain(cv, ci, m), 3),
                        library_ms=time_ms(
                            torch, lambda: torch.sort(flat, dim=1, descending=True, stable=True),
                            3,
                        ),
                        library_topk_ms=time_ms(torch, lambda: torch.topk(flat, m, dim=1), 3),
                        bound_ms=(cv.numel() + b * m) * 8 / HBM_BYTES_PER_S * 1e3,
                        bound_by="bytes",
                    )
                    del flat
                emit(out)
                del cv, ci, kv, ki, pv, pi
    torch.cuda.empty_cache()


# -- phases 3 and 4 ---------------------------------------------------------------


def http_get(url: str) -> tuple[int, bytes, float]:
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, resp.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def exact_top(torch, stn, y_dev, x_rows: np.ndarray, k: int):
    """Exact float32 top-k on the card (plain scan, ties to the lowest
    id): (values, ids) as numpy."""
    q = torch.from_numpy(np.ascontiguousarray(x_rows)).cuda()
    aux = y_dev.norms
    v, i = stn.topn_merge_plain(
        *stn.topn_scan_plain(q, y_dev.mat_t, aux, y_dev.n_items, k, False, False), k
    )
    return v.cpu().numpy(), i.cpu().numpy()


def serve(torch, args, score_dtype: str, x: np.ndarray, y: np.ndarray, probe_users):
    """Start the port's ServingLayer, feed it over the update topic and
    the batched setters, fire the requests; returns (layer, model,
    {user: ids}, {user: values}, latencies, statuses)."""
    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app import pmml as app_pmml
    from oryx_tpu_torch.common import config as config_utils, pmml as pmml_io
    from oryx_tpu_torch.common.text import join_json
    from oryx_tpu_torch.serving.layer import ServingLayer

    broker_loc = f"inproc://chip-smoke-{score_dtype}"
    cfg = config_utils.get_default().with_overlay(
        f"""
        oryx {{
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          als.serving.score-dtype = "{score_dtype}"
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"
            application-resources = "oryx_tpu_torch.app.als"
          }}
        }}
        """
    )
    layer = ServingLayer(cfg)
    layer.start()
    n_topic = 256  # users and items that arrive as UP lines on the topic
    root = pmml_io.build_skeleton_pmml()
    app_pmml.add_extension(root, "features", args.features)
    app_pmml.add_extension(root, "implicit", "true")
    app_pmml.add_extension_content(root, "XIDs", [f"u{j}" for j in range(n_topic)])
    app_pmml.add_extension_content(root, "YIDs", [f"i{j}" for j in range(n_topic)])
    with bus.get_broker(broker_loc).producer("OryxUpdate") as p:
        p.send("MODEL", pmml_io.to_string(root))
        for j in range(n_topic):
            p.send("UP", join_json(["Y", f"i{j}", [float(v) for v in y[j]]]))
        for j in range(n_topic):
            known = [f"i{(j + 1) % n_topic}"]
            p.send("UP", join_json(["X", f"u{j}", [float(v) for v in x[j]], known]))
    base = f"http://127.0.0.1:{layer.port}"
    deadline = time.monotonic() + 120
    while http_get(base + "/ready")[0] != 200:
        if time.monotonic() > deadline:
            raise AssertionError("/ready never turned 200")
        time.sleep(0.05)
    model = layer.model_manager.get_model()
    # the rest arrives through the batched setters the columnar replay uses
    t0 = time.perf_counter()
    model.set_item_vectors([f"i{j}" for j in range(n_topic, len(y))], y[n_topic:])
    model.set_user_vectors([f"u{j}" for j in range(n_topic, len(x))], x[n_topic:])
    load_s = time.perf_counter() - t0
    # first request builds the card copy of Y and starts the X restage
    status, _, first_s = http_get(f"{base}/recommend/u{probe_users[0]}")
    if status != 200:
        raise AssertionError(f"warm-up /recommend answered {status}")
    model._x_restage_thread.join(600)
    if model._x_matrix is None:
        raise AssertionError("the user matrix was not staged on the card")
    urls = [f"{base}/recommend/u{u}" for u in probe_users]
    urls = (urls * (args.requests // len(urls) + 1))[: max(args.requests, len(urls))]
    with ThreadPoolExecutor(args.concurrency) as pool:
        results = list(pool.map(http_get, urls))
    statuses = [r[0] for r in results]
    bodies = {}
    for url, (status, body, _) in zip(urls, results):
        if status == 200:
            bodies[url.rsplit("/u", 1)[1]] = json.loads(body)
    others = [
        f"{base}/recommendToAnonymous/i{n_topic + 1}=1.0/i{n_topic + 2}",
        f"{base}/similarity/i{n_topic + 3}/i{n_topic + 4}",
        f"{base}/estimate/u{probe_users[1]}/i0/i{n_topic + 5}",
    ]
    for url in others:
        status, body, _ = http_get(url)
        statuses.append(status)
        if status != 200 or not json.loads(body):
            raise AssertionError(f"{url} answered {status}")
    lat = sorted(r[2] * 1e3 for r in results)
    return layer, model, bodies, statuses, lat, dict(load_s=load_s, first_request_s=first_s)


# -- phases 5 and 6: k-means -------------------------------------------------------


def gaussian_blobs(n: int, d: int, k: int, seed: int):
    """(points [n, d] f32, true centers [k, d]): k centers at 6 N(0, 1),
    unit noise, as tools/train_benchmark.py:163-166 makes them."""
    gen = np.random.default_rng(seed)
    centers = 6.0 * gen.standard_normal((k, d))
    labels = gen.integers(0, k, n)
    pts = centers[labels].astype(np.float32)
    pts += gen.standard_normal((n, d), dtype=np.float32)
    return pts, centers


def sweep_bound(n: int, d: int, kp: int, k: int) -> tuple[float, str]:
    """Least time for one Lloyd sweep: the bytes it must move (points,
    centers in, sums, counts and cost out) over 3.35 TB/s against
    2*n*k*d + n*d float32 operations (the TPU kernel's HIGHEST; the
    kp - k padded centers need no product) at the card's f32-accurate
    rate, six bf16 tensor-core passes (PEAK_OPS)."""
    t_bytes = (n * d + 2 * kp * d + kp + 1) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = (2.0 * n * k * d + n * d) / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_sweep(torch, what, pts, ctr, n, k, got, ref):
    """Kernel sweep ``got`` against the plain ``ref`` (each sums, counts,
    cost): counts equal except where a point's two smallest distances lie
    within 1e-5 relative (a near tie the two summation orders may break
    apart); sums within rtol 1e-5 of max |sum| plus those points' share;
    cost within rtol 1e-5. Returns the comparison's numbers."""
    sums, counts, cost = (t.double() for t in got)
    rsums, rcounts, rcost = (t.double() for t in ref)
    d2 = torch.cat([
        torch.topk(
            torch.where(
                torch.arange(ctr.shape[0], device=ctr.device)[None, :] < k,
                torch.sum(blk * blk, 1, keepdim=True) - 2.0 * (blk @ ctr.T)
                + torch.sum(ctr * ctr, 1)[None, :],
                torch.inf,
            ),
            2, dim=1, largest=False,
        ).values
        for blk in torch.split(pts[:n], 1 << 20)
    ])
    near = (d2[:, 1] - d2[:, 0]) <= 1e-5 * d2[:, 1].abs()
    n_near = int(near.sum())
    share = float(pts[:n][near].abs().sum(0).max()) if n_near else 0.0
    count_diff = (counts - rcounts).abs()
    sums_err = float((sums - rsums).abs().max())
    scale = float(rsums.abs().max())
    cost_rel = float((cost - rcost).abs().max() / rcost.abs().max())
    out = {
        "near_ties": n_near, "count_abs_diff": float(count_diff.sum()),
        "sums_max_abs_err": sums_err, "sums_scale": scale, "near_share": share,
        "cost_rel_err": cost_rel,
    }
    if float(count_diff.max()) > n_near or float(count_diff.sum()) > 2 * n_near:
        raise AssertionError(
            f"{what}: counts differ by {count_diff.sum()} with {n_near} near ties"
        )
    if sums_err > RTOL * scale + share:
        raise AssertionError(f"{what}: sums differ by {sums_err} (scale {scale}, share {share})")
    if cost_rel > RTOL:
        raise AssertionError(f"{what}: cost differs by {cost_rel} relative")
    if float(counts.sum()) != n:
        raise AssertionError(f"{what}: counts sum to {float(counts.sum())}, not {n}")
    return out


def library_sweep(torch, pts, ctr, n: int, k: int):
    """The yardstick: the fewest PyTorch calls that compute the sweep (f32
    matmul distances, padded centers masked, torch.min, index_add_,
    bincount, the cost's sum); the port never calls it."""
    p = pts[:n]
    d2 = torch.sum(p * p, 1, keepdim=True) - 2.0 * (p @ ctr.T) + torch.sum(ctr * ctr, 1)
    d2[:, k:] = torch.inf
    mind2, a = torch.min(d2, dim=1)
    sums = torch.zeros_like(ctr).index_add_(0, a, p)
    counts = torch.bincount(a, minlength=ctr.shape[0])
    return sums, counts, mind2.clamp_min(0).sum()


def check_non_finite_rows(torch, pk, pts, ctr, k) -> dict:
    """The sweep against its plain version on 3,000 rows (2,900 real) with a
    NaN row, a row with one inf feature, a row whose squared norm
    overflows float32, and a NaN padding row: counts equal, sums within
    rtol 1e-5 and finite, cost NaN in both."""
    bad = pts[:3000].clone()
    n = 2900
    bad[5] = math.nan
    bad[777, 2] = math.inf
    bad[1500] = 1e20
    bad[2950] = math.nan  # padding: counts for nothing
    got = pk.sweep(bad, ctr, n, k)
    ref = pk.sweep_plain(bad, ctr, n, k)
    torch.cuda.synchronize()
    what = "sweep non-finite rows"
    if not torch.equal(got[1], ref[1]):
        raise AssertionError(f"{what}: counts differ")
    if float(got[1].sum()) != n - 2:  # the NaN and inf rows go to no center
        raise AssertionError(f"{what}: counts sum to {float(got[1].sum())}, not {n - 2}")
    if not (bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(ref[0]).all())):
        raise AssertionError(f"{what}: a sum is not finite")
    err = float((got[0].double() - ref[0].double()).abs().max())
    if err > RTOL * float(ref[0].abs().max()):
        raise AssertionError(f"{what}: sums differ by {err}")
    if not (math.isnan(float(got[2][0])) and math.isnan(float(ref[2][0]))):
        raise AssertionError(f"{what}: cost {float(got[2][0])}, plain {float(ref[2][0])}")
    out = {"phase": "kmeans-kernels", "case": what, "counts": float(got[1].sum()),
           "sums_max_abs_err": err, "cost": "nan"}
    emit(out)
    return out


def phase_kmeans_kernels(torch, pk, seed: int, scale: float = 1.0, device="cuda") -> dict:
    """The sweep against its plain version on the card at KMEANS_SHAPES and
    KMEANS_EXTRA_SHAPES (the odd-d one also from an unaligned address),
    the sweep through the public ``pk.sweep`` only, so that ``scan_bench.py
    --phase kmeans`` runs it on another checkout's package; returns the record of
    the first shape (the main path's) with the largest error and the near
    ties over all shapes, keyed by the launch key the sweeps took."""
    dev = torch.device(device)
    first = None
    worst, near_ties = 0.0, 0
    shapes = [(s, False) for s in KMEANS_SHAPES] + [(s, False) for s in KMEANS_EXTRA_SHAPES]
    shapes.insert(len(KMEANS_SHAPES) + 1, (KMEANS_EXTRA_SHAPES[0], True))
    for i, ((n, d, k), unaligned) in enumerate(shapes):
        n = max(1024, int(n * scale))
        pts_np, _ = gaussian_blobs(n, d, k, seed + 100 + i)
        gen = np.random.default_rng(seed + 200 + i)
        kp = pk.padded_k(k)
        pts = torch.from_numpy(pk.pad_to_block(pts_np)).to(dev)
        ctr = torch.zeros((kp, d), dtype=torch.float32, device=dev)
        ctr[:k] = torch.from_numpy(pts_np[gen.choice(n, size=k, replace=False)]).to(dev)
        del pts_np
        if unaligned:  # row 1 on: 28 bytes past the allocation, not 16-byte aligned
            pts = pts[1:]
            n -= 1
        before = pk.launch_counts()
        got = pk.sweep(pts, ctr, n, k)
        keys = sorted(name for name, c in pk.launch_counts().items() if c > before.get(name, 0))
        ref = pk.sweep_plain(pts, ctr, n, k)
        again = pk.sweep(pts, ctr, n, k)
        torch.cuda.synchronize()
        case = f"sweep n={n} d={d} k={k}" + (" unaligned" if unaligned else "")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{case}: two launches disagree")
        cmp = check_sweep(torch, case, pts, ctr, n, k, got, ref)
        if i == 0:
            check_non_finite_rows(torch, pk, pts, ctr, k)
        del ref, again
        torch.cuda.empty_cache()
        run = lambda: pk.sweep(pts, ctr, n, k)  # noqa: E731
        ms = device_ms(torch, run, 10)
        call_ms = time_ms(torch, run, 10)
        plain_ms = time_ms(torch, lambda: pk.sweep_plain(pts, ctr, n, k), 3)
        library_ms = time_ms(torch, lambda: library_sweep(torch, pts, ctr, n, k), 10)
        bound_ms, bound_by = sweep_bound(n, d, kp, k)
        worst = max(worst, cmp["sums_max_abs_err"])
        near_ties += cmp["near_ties"]
        plan = pk.sweep_plan(kp, d, n, dev)[1] if dev.type == "cuda" else None
        emit({
            "phase": "kmeans-kernels", "case": case, "kp": kp, "launch_keys": keys,
            "plan": plan, **cmp, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / ms,
        })
        if i == 0:
            first = (keys, dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bound_ms, bound_by=bound_by))
        del pts, ctr, got
        torch.cuda.empty_cache()
    keys, rec = first
    rec.update(max_abs_err=worst, near_ties=near_ties)
    return {name: dict(rec) for name in keys}


def kmeans_config(broker_loc: str, root: str, d: int, k: int, minibatch: int | None):
    from oryx_tpu_torch.common import config as config_utils

    features = ", ".join(f'"{j}"' for j in range(d))
    mb = f"ml.kmeans.minibatch-size = {minibatch}" if minibatch else ""
    return config_utils.get_default().with_overlay(
        f"""
        oryx {{
          id = "ChipSmokeKMeans"
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          input-schema {{ num-features = {d}, numeric-features = [{features}] }}
          kmeans.hyperparams.k = {k}
          batch {{
            update-class = "oryx_tpu_torch.app.kmeans.update:KMeansUpdate"
            storage {{ data-dir = "{root}/data/", model-dir = "{root}/model/" }}
          }}
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.kmeans.serving:KMeansServingModelManager"
            application-resources = "oryx_tpu_torch.app.kmeans.serving"
          }}
          {mb}
        }}
        """
    )


def check_served_clusters(what, base, clusters, lines, pts, true_centers, gen):
    """/assign and /distanceToNearest for 1,000 sampled points against a
    float64 numpy nearest-center search over the served centers (a list
    of ClusterInfo); every true center within 0.5 of a trained one."""
    ids = np.array([c.id for c in clusters])
    centers = np.stack([c.center for c in clusters]).astype(np.float64)
    for true in true_centers:
        gap = float(np.min(np.linalg.norm(centers - true, axis=1)))
        if gap > 0.5:
            raise AssertionError(f"{what}: a true center is {gap} from every trained one")
    sample = gen.choice(len(lines), size=1000, replace=False)
    exp_d = np.linalg.norm(pts[sample][:, None, :] - centers[None, :, :], axis=2)
    exp_id = ids[np.argmin(exp_d, axis=1)]
    exp_dist = exp_d.min(axis=1)
    body = "\n".join(lines[j] for j in sample).encode()
    req = urllib.request.Request(base + "/assign", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        got = [int(v) for v in json.loads(resp.read())]
    if got != exp_id.tolist():
        bad = int(np.sum(np.asarray(got) != exp_id))
        raise AssertionError(f"{what}: /assign disagrees with numpy on {bad} points")
    for n_probe, (j, e_id, e_dist) in enumerate(zip(sample, exp_id, exp_dist)):
        if n_probe < 100:  # the GET route too, on a tenth of the sample
            status, body, _ = http_get(f"{base}/assign/{lines[j]}")
            if status != 200 or int(json.loads(body)) != int(e_id):
                raise AssertionError(f"{what}: GET /assign answered {status} {body!r}")
        status, body, _ = http_get(f"{base}/distanceToNearest/{lines[j]}")
        if status != 200 or abs(float(json.loads(body)) - e_dist) > 1e-6 * e_dist:
            raise AssertionError(f"{what}: /distanceToNearest answered {status} {body!r}")


def phase_kmeans_batch(pk, seed: int, scale: float = 1.0) -> dict:
    """Two generations of the port's k-means batch layer, served by the
    port's serving layer; returns the kernels' launches (from zero at the
    start of this phase, the k-means main path)."""
    import io
    import tempfile

    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app.kmeans import common as km
    from oryx_tpu_torch.common import pmml as pmml_io
    from oryx_tpu_torch.lambda_.batch import BatchLayer
    from oryx_tpu_torch.ops import kmeans as km_ops
    from oryx_tpu_torch.serving.layer import ServingLayer

    n, d, k = max(1024, int(KMEANS_SHAPES[0][0] * scale)), 20, 10
    pts32, true_centers = gaussian_blobs(n, d, k, seed + 300)
    buf = io.StringIO()
    np.savetxt(buf, pts32, fmt="%.6f", delimiter=",")
    lines = buf.getvalue().splitlines()
    pts = np.loadtxt(io.StringIO(buf.getvalue()), delimiter=",", dtype=np.float64)
    del buf
    gen = np.random.default_rng(seed + 301)
    loc = "inproc://chip-smoke-kmeans"
    root = tempfile.mkdtemp(prefix="chip-smoke-kmeans-")
    serving = ServingLayer(kmeans_config(loc, root, d, k, None))
    serving.start()
    base = f"http://127.0.0.1:{serving.port}"
    pk.reset_launch_counts()  # the k-means main path starts here
    try:
        batch = BatchLayer(kmeans_config(loc, root, d, k, None))
        batch.prepare()
        with bus.get_broker(loc).producer("OryxInput") as producer:
            producer.send_many([(None, line) for line in lines])
        out = {"phase": "kmeans-batch", "points": n, "features": d, "k": k}
        for gen_no, minibatch in ((1, None), (2, 10_000)):
            if minibatch:
                batch.close()  # the next generation's layer resumes the group's offsets
                batch = BatchLayer(kmeans_config(loc, root, d, k, minibatch))
                batch.prepare()
            ts = int(time.time() * 1000)
            t0 = time.perf_counter()
            batch.run_one_generation(timestamp_ms=ts)
            gen_s = time.perf_counter() - t0
            update = batch._update
            if minibatch and (update.minibatch_size != minibatch
                              or update.previous_generation_id is None):
                raise AssertionError("the second generation did not warm-start mini-batch")
            published = os.path.join(root, "model", str(ts), "model.pmml")
            want = np.stack([c.center for c in km.pmml_to_clusters(pmml_io.read_pmml(published))])
            deadline = time.monotonic() + 120
            while True:
                model = serving.model_manager.get_model()
                if model is not None and http_get(base + "/ready")[0] == 200:
                    have = np.stack([c.center for c in model.clusters()])
                    if have.shape == want.shape and np.array_equal(have, want):
                        break
                if time.monotonic() > deadline:
                    raise AssertionError(f"generation {gen_no} never reached serving")
                time.sleep(0.05)
            check_served_clusters(
                f"generation {gen_no}", base, model.clusters(), lines, pts, true_centers, gen
            )
            out[f"gen{gen_no}"] = {
                "seconds": gen_s, "minibatch": minibatch,
                "warm_start_from": update.previous_generation_id,
                "train_kmeans_phase_s": dict(km_ops.last_phase_seconds),
                "mlupdate_phase_s": dict(update.last_phase_seconds),
            }
        batch.close()
    finally:
        serving.close()
    launches = pk.launch_counts()  # the k-means main path ends here
    out["launches"] = launches
    emit(out)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched on the k-means batch path")
    return launches


# -- phase 7: the k-means lambda loop as three processes ----------------------------

LAMBDA_WAVE = 20_000  # points of waves 2 and 3
LAMBDA_BODY_LINES = 4_000  # CSV lines per POST /add
LAMBDA_BATCH_INTERVAL_S = 45  # the batch process's generation interval
LAMBDA_TIMEOUT_S = 600  # the longest any one step may take


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def lambda_conf(root: str, d: int, k: int, ports: dict, batch_interval: int) -> str:
    """The three layers' config: one file: bus, oryx.id set (offsets
    persist), reference.conf defaults otherwise, the batch and speed
    metrics UIs on the given ports."""
    features = ", ".join(f'"{j}"' for j in range(d))
    return f"""
    oryx {{
      id = "ChipSmokeLambda"
      input-topic.broker = "file:{root}/bus"
      update-topic.broker = "file:{root}/bus"
      input-schema {{ num-features = {d}, numeric-features = [{features}] }}
      kmeans.hyperparams.k = {k}
      batch {{
        streaming.generation-interval-sec = {batch_interval}
        update-class = "oryx_tpu_torch.app.kmeans.update:KMeansUpdate"
        storage {{ data-dir = "{root}/data/", model-dir = "{root}/model/" }}
        ui.port = {ports["batch"]}
      }}
      speed {{
        streaming.generation-interval-sec = 1
        model-manager-class = "oryx_tpu_torch.app.kmeans.speed:KMeansSpeedModelManager"
        ui.port = {ports["speed"]}
      }}
      serving {{
        api.port = {ports["serving"]}
        model-manager-class = "oryx_tpu_torch.app.kmeans.serving:KMeansServingModelManager"
        application-resources = "oryx_tpu_torch.app.kmeans.serving"
      }}
    }}
    """


def start_layer(layer: str, conf: str, root: str, device: str, run: int):
    """``python -m oryx_tpu_torch <layer> --conf <conf>`` from the checkout,
    its output in <root>/logs/<layer>-<run>.log: (process, log path)."""
    log_path = os.path.join(root, "logs", f"{layer}-{run}.log")
    cmd = [sys.executable, "-m", "oryx_tpu_torch", layer, "--conf", conf]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=log_file, stderr=subprocess.STDOUT)
    return proc, log_path


def wait_until(what: str, pred, timeout: float = LAMBDA_TIMEOUT_S, procs=()):
    """Poll pred() every 50 ms until it is truthy (returned), failing when
    the time runs out or one of procs has exited."""
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        for name, proc in procs:
            if proc.poll() is not None:
                raise AssertionError(f"{what}: the {name} process exited ({proc.returncode})")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.05)


def log_has(path: str, text: str, count: int = 1) -> bool:
    with open(path, errors="replace") as f:
        return f.read().count(text) >= count


def post_lines(base: str, lines: list[str]) -> float:
    """POST /add in bodies of LAMBDA_BODY_LINES lines; the monotonic time
    the last answer came."""
    for i in range(0, len(lines), LAMBDA_BODY_LINES):
        body = "\n".join(lines[i : i + LAMBDA_BODY_LINES]).encode()
        req = urllib.request.Request(base + "/add", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            if resp.status != 204:
                raise AssertionError(f"POST /add answered {resp.status}")
    return time.monotonic()


def hist_summary(snapshot: dict) -> dict:
    """count, sum, mean and max of a histogram's snapshot (seconds)."""
    return {key: snapshot.get(key) for key in ("count", "sum", "mean", "max")}


def scrape(port: int) -> dict:
    """A layer's metrics registry, from its UI."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
        return json.loads(resp.read())


def update_topic_state(loc: str):
    """(clusters of the last MODEL, {id: (center, count)} after the UPs
    that followed it), read off the update topic as serving replays it."""
    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app import pmml as app_pmml
    from oryx_tpu_torch.app.kmeans import common as km

    consumer = bus.get_broker(loc).consumer("OryxUpdate", from_beginning=True)
    model, state = None, {}
    try:
        while True:
            records = consumer.poll(10_000, 0.2)
            if not records:
                break
            for rec in records:
                if rec.key in ("MODEL", "MODEL-REF"):
                    pmml = app_pmml.read_pmml_from_update_message(rec.key, rec.message)
                    model = km.pmml_to_clusters(pmml)
                    state = {c.id: (np.asarray(c.center, np.float64), c.count) for c in model}
                elif rec.key == "UP" and model is not None:
                    cid, center, count = json.loads(rec.message)
                    state[int(cid)] = (np.asarray(center, np.float64), int(count))
    finally:
        consumer.close()
    return model, state


def running_mean(state: dict, pts: np.ndarray):
    """The speed layer's fold, in float64: each point to its nearest
    center, each center the weighted mean of itself and its points.
    Returns (new state, {id: points folded})."""
    ids = sorted(state)
    centers = np.stack([state[i][0] for i in ids])
    near = np.argmin(((pts[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2), axis=1)
    new, added = dict(state), {}
    for j in np.unique(near):
        cid, (center, count) = ids[j], state[ids[j]]
        sel = pts[near == j]
        new[cid] = ((center * count + sel.sum(axis=0)) / (count + len(sel)), count + len(sel))
        added[cid] = len(sel)
    return new, added


def status_of(url: str) -> int | None:
    """The HTTP status of a GET, or None while nothing listens."""
    try:
        return http_get(url)[0]
    except (urllib.error.URLError, ConnectionError):
        return None


def served_matches(base: str, want: dict, cid: int) -> bool:
    """Serving answers cluster cid's expected center with cid at distance
    0 (within 1e-9 of its norm), and the bus's center agrees to 1e-9."""
    center = want[cid][0]
    path = ",".join(repr(float(v)) for v in center)
    status, body, _ = http_get(f"{base}/distanceToNearest/{path}")
    if status != 200 or float(json.loads(body)) > 1e-9 * float(np.linalg.norm(center)):
        return False
    status, body, _ = http_get(f"{base}/assign/{path}")
    return status == 200 and int(json.loads(body)) == cid


def phase_kmeans_lambda(seed: int, scale: float = 1.0, device: str = "cuda",
                        batch_interval: int = LAMBDA_BATCH_INTERVAL_S) -> dict:
    """The k-means lambda loop as three OS processes on one file: bus
    (``python -m oryx_tpu_torch batch|speed|serving``): wave 1, the
    training set, through serving's /add; the batch process's
    generation, served exactly; wave 2 folded by the speed process and
    served as the float64 running mean; the speed process restarted;
    wave 3 folded with no record consumed twice or lost. Returns the
    phase's record, the batch process's kernel launches included."""
    import io
    import signal
    import tempfile

    n = max(2_000, int(KMEANS_SHAPES[0][0] * scale))
    d, k = KMEANS_SHAPES[0][1], KMEANS_SHAPES[0][2]
    wave = max(200, int(LAMBDA_WAVE * scale))
    pts32, true_centers = gaussian_blobs(n, d, k, seed + 400)
    gen = np.random.default_rng(seed + 401)
    # waves 2 and 3 around blob 0 moved by +1.0 in every feature
    moved = true_centers[0] + 1.0
    later = [(moved + gen.standard_normal((wave, d))).astype(np.float32) for _ in range(2)]
    texts = []
    for block in [pts32] + later:
        buf = io.StringIO()
        np.savetxt(buf, block, fmt="%.6f", delimiter=",")
        texts.append(buf.getvalue())
    lines = [t.splitlines() for t in texts]
    values = [np.loadtxt(io.StringIO(t), delimiter=",", dtype=np.float64) for t in texts]
    del texts, pts32, later

    root = tempfile.mkdtemp(prefix="chip-smoke-lambda-")
    os.makedirs(os.path.join(root, "logs"))
    ports = {name: free_port() for name in ("batch", "speed", "serving")}
    conf = os.path.join(root, "oryx.conf")
    with open(conf, "w") as f:
        f.write(lambda_conf(root, d, k, ports, batch_interval))
    loc = f"file:{root}/bus"
    base = f"http://127.0.0.1:{ports['serving']}"
    procs: dict = {}
    logs: list[str] = []
    out = {"phase": "kmeans-lambda", "points": n, "features": d, "k": k, "wave_points": wave,
           "bus": "file:", "batch_interval_s": batch_interval}

    def start(layer: str, run: int = 1):
        procs[layer], path = start_layer(layer, conf, root, device, run)
        logs.append(path)
        return path

    def stop(layer: str) -> int:
        procs[layer].send_signal(signal.SIGTERM)
        return procs.pop(layer).wait(timeout=120)

    def live():
        return list(procs.items())

    try:
        from oryx_tpu_torch import bus

        start("serving")
        batch_log = start("batch")
        speed_log = start("speed")
        # consumer groups start at the topic's end: wave 1 waits until the
        # batch and speed layers have attached theirs
        wait_until("layers up", lambda: log_has(batch_log, "BatchLayer started")
                   and log_has(speed_log, "SpeedLayer started")
                   and status_of(base + "/ready") == 503, procs=live())
        t_post = time.monotonic()
        t_last = post_lines(base, lines[0])
        out["wave1_post_s"] = t_last - t_post

        # wave 1: the batch process's generation, served exactly
        wait_until("generation 1", lambda: http_get(base + "/ready")[0] == 200, procs=live())
        out["wave1_staleness_s"] = time.monotonic() - t_last
        model, state = update_topic_state(loc)
        check_served_clusters("wave 1", base, model, lines[0], values[0], true_centers, gen)
        metrics_batch = wait_until(
            "the batch generation's end",
            lambda: (m := scrape(ports["batch"])).get("batch.generations", {}).get("value", 0) >= 1
            and m,
            procs=live(),
        )
        input_broker = bus.get_broker(loc)
        latest = input_broker.latest_offsets("OryxInput")
        drained = input_broker.get_offsets("OryxGroup-batch-ChipSmokeLambda", "OryxInput")
        if drained != latest or sum(latest.values()) != n:
            raise AssertionError(f"generation 1 drained {drained} of {latest} ({n} posted)")
        out["batch_generation_s"] = hist_summary(metrics_batch["batch.generation.seconds"])
        out["batch_launches"] = {
            name.split(".", 1)[1].rsplit(".", 1)[0]: int(m["value"])
            for name, m in metrics_batch.items()
            if name.startswith("kernels.") and name.endswith(".launches")
        }
        # a second generation would retrain on waves 2-3 and publish a new
        # MODEL over the speed layer's folds: the batch process has done its part
        if stop("batch") != 0:
            raise AssertionError("the batch process did not stop cleanly")

        wait_until("the speed model", lambda: log_has(speed_log, "k-means speed model"),
                   procs=live())
        speed_group = "OryxGroup-speed-ChipSmokeLambda"
        _, state = update_topic_state(loc)  # the published model (and any UP since)
        expected = dict(state)
        base_counts = {cid: count for cid, (_, count) in state.items()}
        folded = {cid: 0 for cid in state}
        out["speed_batch_s"] = []
        for wave_no, (wave_lines, wave_pts) in enumerate(zip(lines[1:], values[1:]), start=2):
            if wave_no == 3:  # restart the speed process: it resumes, and replays the updates
                out["speed_batch_s"].append(
                    hist_summary(scrape(ports["speed"])["speed.batch.seconds"])
                )
                if stop("speed") != 0:
                    raise AssertionError("the speed process did not stop cleanly")
                speed_log = start("speed", run=2)
                wait_until("the restarted speed model",
                           lambda: log_has(speed_log, "k-means speed model"), procs=live())
                # the UPs behind the MODEL replay in the same pass, in
                # microseconds; a second's margin before wave 3 arrives
                time.sleep(1.0)
            expected, added = running_mean(expected, wave_pts)
            for cid, c in added.items():
                folded[cid] += c
            t_last = post_lines(base, wave_lines)
            moved_ids = sorted(added)
            wait_until(f"wave {wave_no} served",
                       lambda: all(served_matches(base, expected, c) for c in moved_ids),
                       procs=live())
            out[f"wave{wave_no}_staleness_s"] = time.monotonic() - t_last
            # every cluster as the bus has it (serving replays the same):
            # the running mean, and the model's count plus the waves' points
            _, state = update_topic_state(loc)
            for cid, (center, count) in expected.items():
                got_center, got_count = state[cid]
                rel = float(np.linalg.norm(got_center - center) / np.linalg.norm(center))
                if rel > 1e-9 or got_count != base_counts[cid] + folded[cid]:
                    raise AssertionError(
                        f"wave {wave_no}: cluster {cid} holds {got_count} points, not "
                        f"{base_counts[cid]} + {folded[cid]}, at {rel:.3g} relative from "
                        "the running mean"
                    )
            wait_until(f"wave {wave_no} committed",
                       lambda: input_broker.get_offsets(speed_group, "OryxInput")
                       == input_broker.latest_offsets("OryxInput"), timeout=30, procs=live())
            out[f"wave{wave_no}_folded"] = {str(c): added[c] for c in moved_ids}
        out["speed_batch_s"].append(hist_summary(scrape(ports["speed"])["speed.batch.seconds"]))
        for layer in list(procs):
            if stop(layer) != 0:
                raise AssertionError(f"the {layer} process did not stop cleanly")
    except BaseException:
        for path in logs:
            with open(path, errors="replace") as f:
                tail = f.read()[-3000:]
            print(f"--- {path} (tail) ---\n{tail}", file=sys.stderr, flush=True)
        raise
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait(timeout=60)
    emit(out)
    return out


def main() -> int:
    args = parse_args()
    if not os.path.isdir(os.path.join(HERE, "oryx_tpu_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    full_float32(torch)
    from oryx_tpu_torch.common.metrics import registry as metrics
    from oryx_tpu_torch.ops import _build, topn
    from oryx_tpu_torch.ops import pallas_kmeans as pk
    from oryx_tpu_torch.ops import streaming_topn as stn

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    # the build log: spills, and ptxas warnings (a serialised wgmma is
    # C7510-C7520)
    log = [
        (name, line.strip())
        for name in _build.SOURCES
        for line in _build.log_path(name).read_text().splitlines()
    ]
    emit({
        "phase": "card", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "build_s": build_s,
        "ptxas_spills": sorted({
            f"{name}: {line}" for name, line in log
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
        }),
        "ptxas_warnings": sorted({f"{name}: {line}" for name, line in log if "warning" in line}),
        "ptxas_kernels": ptxas_kernels(log),
    })

    gen = np.random.default_rng(args.seed)
    y = factors(gen, args.items, args.features)
    x = factors(gen, args.users, args.features)

    kernels = phase_kernels(torch, stn, y, args.seed)
    missing = [name for name in SOURCES if name.startswith("topn") and name not in kernels]
    if missing:
        raise AssertionError(f"no phase-2 case took {missing}")
    check_widest_query_tile(torch, stn, args.items, args.seed)
    check_wide_scans(torch, stn, args.seed)

    probe = sorted(gen.choice(np.arange(256, args.users), size=args.concurrency, replace=False))
    y_exact = stn.upload_streaming(y, dtype=torch.float32, device="cuda")
    ref_v, ref_i = exact_top(torch, stn, y_exact, x[probe], 10)
    stn.reset_launch_counts()  # the main path starts here

    layer, model, bodies, statuses, lat, info = serve(torch, args, "int8", x, y, probe)
    try:
        if any(s != 200 for s in statuses):
            raise AssertionError(f"int8 serving: statuses {sorted(set(statuses))}")
        hits = [
            len({r["id"] for r in bodies[str(u)]} & {f"i{j}" for j in ref_i[row]})
            for row, u in enumerate(probe)
        ]
        recall = sum(hits) / (10.0 * len(probe))
        indexed = metrics.counter("serving.batcher.submitted.indexed").value
        # bulk scoring: 512 users in one call takes the candidates kernel
        _, _, handle = model._ensure_y_matrix()
        bulk = np.arange(256, 768)
        bi, _ = topn.top_k_scores_batch(handle, x[bulk], 10)
        _, bulk_ref = exact_top(torch, stn, y_exact, x[bulk], 10)
        bulk_recall = sum(len(set(g) & set(r)) for g, r in zip(bi.tolist(), bulk_ref.tolist()))
        bulk_recall /= 10.0 * len(bulk)
        launches_int8 = stn.launch_counts()
        batches_int8 = stn.scan_batch_histogram()
        emit({
            "phase": "serving-int8", "requests": len(lat), "concurrency": args.concurrency,
            "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "recall_at_10": recall, "bulk_512_recall_at_10": bulk_recall,
            "indexed_entries": indexed, "launches": launches_int8, "scan_batches": batches_int8,
            **info,
        })
        if recall < 0.99 or bulk_recall < 0.99:
            raise AssertionError(f"int8 recall@10 {recall}, bulk {bulk_recall}: below 0.99")
        if indexed <= 0 or launches_int8["topn_scan.tc"] <= 0:
            raise AssertionError("int8 serving never reached index submit / topn_scan.tc")
        if launches_int8["topn_candidates.tc"] <= 0:
            raise AssertionError("the int8 bulk batch never reached topn_candidates.tc")
        if launches_int8["topn_scan.tc_f32"] or launches_int8["topn_candidates.tc_f32"]:
            raise AssertionError(f"an int8 scan took the float32 path: {launches_int8}")
    finally:
        layer.close()
    del model, layer

    layer, model, bodies, statuses, lat, info = serve(torch, args, "float32", x, y, probe)
    try:
        if any(s != 200 for s in statuses):
            raise AssertionError(f"float32 serving: statuses {sorted(set(statuses))}")
        got_i = np.array([[int(r["id"][1:]) for r in bodies[str(u)]] for u in probe])
        got_v = np.array([[r["value"] for r in bodies[str(u)]] for u in probe])
        err = check_topk("float32 /recommend", got_v, got_i, ref_v, ref_i)
        # bulk scoring: 512 users in one call takes the candidates kernel
        _, _, handle = model._ensure_y_matrix()
        bulk = np.arange(256, 768)
        bi, bv = topn.top_k_scores_batch(handle, x[bulk], 10)
        rv, ri = exact_top(torch, stn, y_exact, x[bulk], 10)
        bulk_err = check_topk("float32 top_k_scores_batch b=512", bv, bi, rv, ri)
        launches = stn.launch_counts()
        # phase 3 counted only the tc keys (checked there)
        batches_f32 = {
            name: hist for name, hist in stn.scan_batch_histogram().items()
            if name.endswith(".tc_f32")
        }
        emit({
            "phase": "serving-float32", "requests": len(lat),
            "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "recommend_max_abs_err": err, "bulk_512_max_abs_err": bulk_err,
            "scan_batches": batches_f32, **info,
        })
        for name in ("topn_scan.tc", "topn_candidates.tc"):
            if launches[name] != launches_int8[name]:
                raise AssertionError(f"a float32 scan took the bf16/int8 path ({name})")
        if launches["topn_scan.tc_f32"] <= 0 or launches["topn_candidates.tc_f32"] <= 0:
            raise AssertionError(f"float32 serving never reached the float32 scans: {launches}")
    finally:
        layer.close()
    # the main path ends here
    del model, layer, y_exact
    torch.cuda.empty_cache()

    kernels.update(phase_kmeans_kernels(torch, pk, args.seed))
    launches.update(phase_kmeans_batch(pk, args.seed))
    torch.cuda.empty_cache()  # the lambda phase's batch process shares the card
    lam = phase_kmeans_lambda(args.seed)
    if lam["batch_launches"].get("kmeans_sweep.tc", 0) <= 0:
        raise AssertionError(f"the batch process launched {lam['batch_launches']}")

    table = []
    for name in SOURCES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "parity": "ok", "library_topk_ms": None,
            **kernels[name],
        })
    emit({"kernels": table})
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
