#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``oryx_tpu_torch``) runs on the GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each printing one JSON line:

1. card and build: the card, torch and CUDA versions, and the seconds
   ``nvcc`` took to build the kernels from ``oryx_tpu_torch/csrc``;
2. kernels: every kernel of the serving path (``topn_scan``,
   ``topn_merge``, ``topn_candidates``) against its plain PyTorch
   version on the same inputs, at 1,000,000 items x 250 features, for
   float32, bfloat16 and int8 planes, dot and cosine; with CUDA-event
   times of the kernel, the plain version and one PyTorch library call
   (``torch.matmul`` and a stable ``torch.sort``, which the port never
   calls);
3. serving, int8: the port's ServingLayer fed MODEL + UP messages over
   the update topic and bulk-loaded with 1,000,000 items and users,
   answering concurrent /recommend (index submit through the batcher),
   /recommendToAnonymous, /similarity and /estimate; /recommend recall@10
   against an exact float32 scan on the card must reach 0.99;
4. serving, float32, on the same factors: /recommend ids must equal the
   exact top-10 (ties to the lowest id), and a 512-query batch through
   ``topn.top_k_scores_batch`` (the candidates kernel) must too;
5. kmeans-kernels: ``kmeans_sweep`` + ``kmeans_reduce`` (the Lloyd sweep)
   against their plain versions on Gaussian blobs at 200,000 x 20 (k = 10,
   the repo's k-means shape), 10,000,000 x 20 (k = 10) and 1,000,000 x 256
   (k = 256): counts equal but for near ties (two smallest distances
   within 1e-5 relative), sums within rtol 1e-5 of max |sum| (plus the
   near ties' share), cost within rtol 1e-5; with CUDA-event times;
6. kmeans-batch: the port's BatchLayer with KMeansUpdate on an inproc
   bus (reference.conf defaults: 30 iterations, 3 runs, k-means||,
   SILHOUETTE, test-fraction 0.1) trains on 200,000 CSV points of 20
   features in 10 blobs; the port's ServingLayer answers /assign and
   /distanceToNearest for 1,000 sampled points exactly as a float64
   numpy nearest-center search does, and every true blob center has a
   trained center within 0.5; a second generation with mini-batch size
   10,000 warm-starts from the champion under the same checks;
7. the kernel table: launches on the main paths (ALS during phases 3-4,
   k-means during phase 6, each counted from zero just before) and the
   numbers of phases 2 and 5;
8. the card's name and power limit, then ``{"ok": true, "device": ...}``.

Any failure raises and the exit code is not 0. Without CUDA, or run
from a directory that holds no ``oryx_tpu_torch``, it exits 2 before
printing any result. Weights are random, made from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 989e12}  # see kernel_bound()
SOURCES = {
    "topn_scan": "oryx_tpu_torch/csrc/topn.cu",
    "topn_merge": "oryx_tpu_torch/csrc/topn.cu",
    "topn_candidates": "oryx_tpu_torch/csrc/topn.cu",
    "kmeans_sweep": "oryx_tpu_torch/csrc/kmeans.cu",
    "kmeans_reduce": "oryx_tpu_torch/csrc/kmeans.cu",
}
REPLACES = {
    "topn_scan": "oryx_tpu/ops/pallas_topn.py:300",
    "topn_merge": "oryx_tpu/ops/pallas_topn.py:300",
    "topn_candidates": "oryx_tpu/ops/pallas_topn.py:364",
    "kmeans_sweep": "oryx_tpu/ops/pallas_kmeans.py:59",
    "kmeans_reduce": "oryx_tpu/ops/pallas_kmeans.py:59",
}
RTOL = 1e-5
# (points, features, clusters) of the k-means kernel phase; the first is
# the repo's k-means training shape (tools/train_benchmark.py:161-170)
KMEANS_SHAPES = ((200_000, 20, 10), (10_000_000, 20, 10), (1_000_000, 256, 256))
SWEEP_LIBRARY_NOTE = "no single PyTorch call computes the fused sweep"
REDUCE_LIBRARY_NOTE = "no single PyTorch call reduces the sums, counts and cost together"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--items", type=int, default=1_000_000)
    p.add_argument("--users", type=int, default=1_000_000)
    p.add_argument("--features", type=int, default=250)
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--concurrency", type=int, default=64)
    p.add_argument("--seed", type=int, default=7)
    return p.parse_args()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    score at full float32 (67 TFLOP/s outside the tensor cores).
    bfloat16 and int8 planes score a bfloat16 product with float32
    accumulation, as the TPU kernel does (int8 codes are exact in
    bfloat16 and take bfloat16 MXU passes there), so both count at the
    bfloat16 tensor-core rate (989 TFLOP/s), whatever units the port's
    kernel uses."""
    item_bytes = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    moved = kf * n * item_bytes + 4 * n + 4 * b * kf + out_bytes
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * kf * n / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2 --------------------------------------------------------------------


def library_topk(torch, q, plane, m):
    """The yardstick: PyTorch's own matmul and stable sort over the whole
    plane (no aux, no masking); the port never calls it."""
    v, i = torch.sort(torch.matmul(q, plane), dim=1, descending=True, stable=True)
    return v[:, :m], i[:, :m]


def phase_kernels(torch, stn, y: np.ndarray, seed: int) -> dict:
    """Every kernel against its plain version on the card; returns the
    per-kernel record of the representative cases (int8 dot: topn_scan
    and topn_merge at b = 256, topn_candidates at b = 512) with the
    largest error seen over all cases."""
    gen = np.random.default_rng(seed + 1)
    rec: dict[str, dict] = {}
    worst = {"topn_scan": 0.0, "topn_merge": 0.0, "topn_candidates": 0.0}
    n = y.shape[0]
    k = 16  # the batcher's smallest k bucket
    for dtype in ("float32", "bfloat16", "int8"):
        up = stn.upload_streaming(y, dtype=stn.torch_dtype(dtype), device="cuda")
        quantized = up.scales is not None
        kf = up.mat_t.shape[0]
        m = stn._scan_k(k, n, up.resid)
        lib_plane = up.mat_t.float() if dtype != "bfloat16" else up.mat_t
        for cosine in (False, True):
            aux = stn._fold_aux(up.norms, up.scales, cosine).contiguous()
            for b, kernel in ((8, "topn_scan"), (256, "topn_scan"), (512, "topn_candidates")):
                q = torch.from_numpy(gen.standard_normal((b, y.shape[1]), dtype=np.float32))
                q = q.cuda()
                if dtype == "bfloat16":
                    q = q.to(torch.bfloat16).float()
                q = stn._pad_queries(q, kf).contiguous()
                scan = getattr(stn, kernel)
                plain = getattr(stn, kernel + "_plain")
                cv, ci = scan(q, up.mat_t, aux, n, m, cosine, quantized)
                kv, ki = stn.topn_merge(cv, ci, m)
                pv, pi = stn.topn_merge_plain(*plain(q, up.mat_t, aux, n, m, cosine, quantized), m)
                torch.cuda.synchronize()
                case = f"{kernel} {dtype} {'cosine' if cosine else 'dot'} b={b} m={m}"
                err = check_topk(case, kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())
                worst[kernel] = max(worst[kernel], err)
                # the merge kernel against its plain version on the same lists
                mv, mi = stn.topn_merge_plain(cv, ci, m)
                if not (torch.equal(mv, kv) and torch.equal(mi, ki)):
                    raise AssertionError(f"topn_merge disagrees with its plain version: {case}")
                merge_err = float(torch.where(mv == kv, 0.0, (mv - kv).abs()).max())
                worst["topn_merge"] = max(worst["topn_merge"], merge_err)
                ms = time_ms(torch, lambda: scan(q, up.mat_t, aux, n, m, cosine, quantized), 10)
                plain_ms = time_ms(torch, lambda: plain(q, up.mat_t, aux, n, m, cosine, quantized), 3)
                qq = q.to(lib_plane.dtype)
                library_ms = time_ms(torch, lambda: library_topk(torch, qq, lib_plane, m), 3)
                merge_ms = time_ms(torch, lambda: stn.topn_merge(cv, ci, m), 10)
                merge_plain_ms = time_ms(torch, lambda: stn.topn_merge_plain(cv, ci, m), 3)
                flat = cv.permute(1, 0, 2).reshape(b, -1).contiguous()
                merge_lib_ms = time_ms(
                    torch, lambda: torch.sort(flat, dim=1, descending=True, stable=True), 10
                )
                cand_bytes = cv.numel() * 8
                bound_ms, bound_by = kernel_bound(dtype, b, y.shape[1], n, cand_bytes)
                merge_bound = (cand_bytes + b * m * 8) / HBM_BYTES_PER_S * 1e3
                line = {
                    "phase": "kernels", "case": case, "lists": int(cv.shape[0]),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "merge_max_abs_err": merge_err, "merge_ms": merge_ms,
                    "merge_plain_ms": merge_plain_ms,
                    "merge_library_ms": merge_lib_ms, "merge_bound_ms": merge_bound,
                }
                emit(line)
                if dtype == "int8" and not cosine and b in (256, 512):
                    rec[kernel] = dict(
                        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                    )
                    if b == 256:
                        rec["topn_merge"] = dict(
                            ms=merge_ms, plain_ms=merge_plain_ms, library_ms=merge_lib_ms,
                            bound_ms=merge_bound, bound_by="bytes",
                        )
                del cv, ci, kv, ki, pv, pi, mv, mi, flat
        del up, lib_plane
        torch.cuda.empty_cache()
    for name in rec:
        rec[name]["max_abs_err"] = worst[name]
    return rec


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


def sweep_bound(n: int, d: int, kp: int) -> tuple[float, str]:
    """Least time for one Lloyd sweep: the bytes it must move (points,
    centers in, sums, counts and cost out) over 3.35 TB/s against
    2*n*kp*d + n*d float32 operations (the TPU kernel's HIGHEST) over
    67 TFLOP/s."""
    t_bytes = (n * d + 2 * kp * d + kp + 1) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = (2.0 * n * kp * d + n * d) / PEAK_OPS["float32"] * 1e3
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


def check_non_finite_rows(torch, pk, pts, ctr, k) -> dict:
    """The sweep kernels against their plain versions on 3,000 rows (2,900
    real) with a NaN row, a row with one inf feature, a row whose squared
    norm overflows float32, and a NaN padding row: counts equal, sums
    within rtol 1e-5 and finite, cost NaN in both."""
    bad = pts[:3000].clone()
    n = 2900
    bad[5] = math.nan
    bad[777, 2] = math.inf
    bad[1500] = 1e20
    bad[2950] = math.nan  # padding: counts for nothing
    num_ctas, rows_per_cta = pk.sweep_grid(bad.shape[0], bad.device)
    got = pk.kmeans_reduce(*pk.kmeans_sweep(bad, ctr, n, k))
    ref = pk.kmeans_reduce_plain(*pk.kmeans_sweep_plain(bad, ctr, n, k, num_ctas, rows_per_cta))
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
    """kmeans_sweep and kmeans_reduce against their plain versions on the
    card at KMEANS_SHAPES; returns the per-kernel record of the first
    shape (the main path's) with the largest error over all shapes and
    the near ties of all shapes."""
    dev = torch.device(device)
    rec: dict[str, dict] = {}
    worst = {"kmeans_sweep": 0.0, "kmeans_reduce": 0.0}
    near_ties = 0
    for i, (n, d, k) in enumerate(KMEANS_SHAPES):
        n = max(1024, int(n * scale))
        pts_np, _ = gaussian_blobs(n, d, k, seed + 100 + i)
        gen = np.random.default_rng(seed + 200 + i)
        kp = pk.padded_k(k)
        pts = torch.from_numpy(pk.pad_to_block(pts_np)).to(dev)
        ctr = torch.zeros((kp, d), dtype=torch.float32, device=dev)
        ctr[:k] = torch.from_numpy(pts_np[gen.choice(n, size=k, replace=False)]).to(dev)
        del pts_np
        num_ctas, rows_per_cta = pk.sweep_grid(pts.shape[0], pts.device)
        parts = pk.kmeans_sweep(pts, ctr, n, k)
        got = pk.kmeans_reduce(*parts)
        plain_parts = pk.kmeans_sweep_plain(pts, ctr, n, k, num_ctas, rows_per_cta)
        ref = pk.kmeans_reduce_plain(*plain_parts)
        again = pk.kmeans_reduce(*pk.kmeans_sweep(pts, ctr, n, k))
        torch.cuda.synchronize()
        case = f"sweep n={n} d={d} k={k}"
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{case}: two launches disagree")
        cmp = check_sweep(torch, case, pts, ctr, n, k, got, ref)
        # the reduce kernel against its plain version on the kernel's partials
        red_ref = pk.kmeans_reduce_plain(*parts)
        if not torch.equal(got[1], red_ref[1]):
            raise AssertionError(f"{case}: kmeans_reduce counts disagree")
        red_err = max(float((a - b).abs().max()) for a, b in zip(got, red_ref))
        red_scale = max(float(b.abs().max()) for b in red_ref)
        if red_err > RTOL * red_scale:
            raise AssertionError(f"{case}: kmeans_reduce differs by {red_err}")
        if i == 0:
            check_non_finite_rows(torch, pk, pts, ctr, k)
        del plain_parts, ref, red_ref, again
        torch.cuda.empty_cache()
        ms = time_ms(torch, lambda: pk.kmeans_sweep(pts, ctr, n, k), 10)
        plain_ms = time_ms(
            torch, lambda: pk.kmeans_sweep_plain(pts, ctr, n, k, num_ctas, rows_per_cta), 3
        )
        red_ms = time_ms(torch, lambda: pk.kmeans_reduce(*parts), 10)
        red_plain_ms = time_ms(torch, lambda: pk.kmeans_reduce_plain(*parts), 10)
        bound_ms, bound_by = sweep_bound(n, d, kp)
        red_bound = (
            num_ctas * (kp * d * 8 + kp * 4 + 8) + (kp * d + kp + 1) * 4
        ) / HBM_BYTES_PER_S * 1e3
        # the sweep's error includes the points of near ties that the two
        # versions assign apart (counted in near_ties)
        worst["kmeans_sweep"] = max(worst["kmeans_sweep"], cmp["sums_max_abs_err"])
        worst["kmeans_reduce"] = max(worst["kmeans_reduce"], red_err)
        near_ties += cmp["near_ties"]
        emit({
            "phase": "kmeans-kernels", "case": case, "kp": kp, "ctas": num_ctas,
            "rows_per_cta": rows_per_cta, "groups": pk._sweep_groups(kp, d), **cmp,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "library_note": SWEEP_LIBRARY_NOTE,
            "reduce_max_abs_err": red_err, "reduce_ms": red_ms,
            "reduce_plain_ms": red_plain_ms, "reduce_bound_ms": red_bound,
        })
        if i == 0:
            rec["kmeans_sweep"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, library_note=SWEEP_LIBRARY_NOTE,
            )
            rec["kmeans_reduce"] = dict(
                ms=red_ms, plain_ms=red_plain_ms, bound_ms=red_bound, bound_by="bytes",
                library_ms=None, library_note=REDUCE_LIBRARY_NOTE,
            )
        del pts, ctr, parts, got
        torch.cuda.empty_cache()
    for name in rec:
        rec[name]["max_abs_err"] = worst[name]
    rec["kmeans_sweep"]["near_ties"] = near_ties
    return rec


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


def check_served_clusters(what, base, model, lines, pts, true_centers, gen):
    """/assign and /distanceToNearest for 1,000 sampled points against a
    float64 numpy nearest-center search over the served centers; every
    true center within 0.5 of a trained one."""
    clusters = model.clusters()
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
                f"generation {gen_no}", base, model, lines, pts, true_centers, gen
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
    from oryx_tpu_torch.common.metrics import registry as metrics
    from oryx_tpu_torch.ops import _build, topn
    from oryx_tpu_torch.ops import pallas_kmeans as pk
    from oryx_tpu_torch.ops import streaming_topn as stn

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    spills = {
        f"{name}: {line.strip()}"
        for name in _build.SOURCES
        for line in _build.log_path(name).read_text().splitlines()
        if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
    }
    emit({
        "phase": "card", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "build_s": build_s,
        "ptxas_spills": sorted(spills),
    })

    gen = np.random.default_rng(args.seed)
    scale = 1.0 / np.sqrt(args.features)
    y = (gen.standard_normal((args.items, args.features), dtype=np.float32) * scale)
    x = (gen.standard_normal((args.users, args.features), dtype=np.float32) * scale)

    kernels = phase_kernels(torch, stn, y, args.seed)

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
        emit({
            "phase": "serving-int8", "requests": len(lat), "concurrency": args.concurrency,
            "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "recall_at_10": recall, "indexed_entries": indexed,
            "topn_scan_launches": stn.launch_counts()["topn_scan"], **info,
        })
        if recall < 0.99:
            raise AssertionError(f"int8 recall@10 {recall} < 0.99")
        if indexed <= 0 or stn.launch_counts()["topn_scan"] <= 0:
            raise AssertionError("int8 serving never reached index submit / topn_scan")
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
        emit({
            "phase": "serving-float32", "requests": len(lat),
            "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "recommend_max_abs_err": err, "bulk_512_max_abs_err": bulk_err, **info,
        })
    finally:
        layer.close()
    launches = stn.launch_counts()  # the main path ends here
    del model, layer, y_exact
    torch.cuda.empty_cache()

    kernels.update(phase_kmeans_kernels(torch, pk, args.seed))
    launches.update(phase_kmeans_batch(pk, args.seed))

    table = []
    for name in SOURCES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "parity": "ok", **kernels[name],
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
