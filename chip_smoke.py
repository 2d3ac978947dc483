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
5. the kernel table: launches during phases 3-4 (counted from zero just
   before phase 3) and the numbers of phase 2;
6. the card's name and power limit, then ``{"ok": true, "device": ...}``.

Any failure raises and the exit code is not 0. Without CUDA, or run
from a directory that holds no ``oryx_tpu_torch``, it exits 2 before
printing any result. Weights are random, made from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
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
SOURCE = "oryx_tpu_torch/csrc/topn.cu"
REPLACES = {
    "topn_scan": "oryx_tpu/ops/pallas_topn.py:300",
    "topn_merge": "oryx_tpu/ops/pallas_topn.py:300",
    "topn_candidates": "oryx_tpu/ops/pallas_topn.py:364",
}
RTOL = 1e-5


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
    from oryx_tpu_torch.ops import streaming_topn as stn

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    spills = {
        line.strip() for line in _build.log_path("topn").read_text().splitlines()
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
    del model, layer

    table = []
    for name in ("topn_scan", "topn_merge", "topn_candidates"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
        table.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
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
