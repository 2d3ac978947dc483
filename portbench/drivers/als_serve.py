"""ALS ``/recommend`` over HTTP on the port's ``ServingLayer``, driven by the
closed-loop client (``traffic/closed_loop.py``) in a process of its own.

Set-up makes the factors and each user's known items from the seed on the
device, in three large calls, and loads them through the port's normal
path: a MODEL on an ``inproc:`` update topic naming the first
``topic_rows`` users and items, with their rows as UP messages, then the
batched setters for the rest and the known items, then one ``/recommend``
that stages Y and X on the card. The client then warms the request path
with the window's own traffic for ``warmup_s`` seconds.

The comparison takes a sample of the window's answers, drawn from the
seed, with the slowest in it, and holds each against the plain reference
on the same factors and known items.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import urllib.request
from collections import Counter
from pathlib import Path

import numpy as np

from portbench import devtrace
from portbench.harness import derived_seed, note, overlay
from portbench.reference import als_serve as reference

CHECKOUT = Path(__file__).resolve().parents[2]
BROKER = "inproc://portbench"


def _get(url: str) -> int:
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            resp.read()
            return resp.status
    except OSError:
        return -1


def make_inputs(conf: dict, seed: int, device: str):
    """(X, Y, known item rows) as numpy, drawn from the seed on ``device``."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 0))
    shape = dict(generator=gen, device=device, dtype=torch.float32)
    x = torch.randn((conf["users"], conf["features"]), **shape).cpu().numpy()
    y = torch.randn((conf["items"], conf["features"]), **shape).cpu().numpy()
    known = torch.randint(0, conf["items"], (conf["users"], conf["known_items_per_user"]),
                          generator=gen, device=device).cpu().numpy()
    return x, y, known


def load_model(layer, conf: dict, x, y, known, topic_rows: int) -> None:
    """The MODEL and the first rows on the update topic, the rest through
    the batched setters; returns once the layer answers /ready."""
    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app import pmml as app_pmml
    from oryx_tpu_torch.common import pmml as pmml_io
    from oryx_tpu_torch.common.text import join_json

    user_ids = [f"u{j}" for j in range(len(x))]
    item_ids = [f"i{j}" for j in range(len(y))]
    root = pmml_io.build_skeleton_pmml()
    app_pmml.add_extension(root, "features", conf["features"])
    app_pmml.add_extension(root, "implicit", "true")
    app_pmml.add_extension_content(root, "XIDs", user_ids[:topic_rows])
    app_pmml.add_extension_content(root, "YIDs", item_ids[:topic_rows])
    with bus.get_broker(BROKER).producer("OryxUpdate") as p:
        p.send("MODEL", pmml_io.to_string(root))
        for j in range(topic_rows):
            p.send("UP", join_json(["Y", item_ids[j], [float(v) for v in y[j]]]))
        for j in range(topic_rows):
            p.send("UP", join_json(["X", user_ids[j], [float(v) for v in x[j]],
                                    [item_ids[t] for t in known[j]]]))
    base = f"http://127.0.0.1:{layer.port}"
    deadline = time.monotonic() + 300
    while _get(base + "/ready") != 200:
        if time.monotonic() > deadline:
            raise RuntimeError("/ready never answered 200")
        time.sleep(0.05)
    model = layer.model_manager.get_model()
    model.set_item_vectors(item_ids[topic_rows:], y[topic_rows:])
    model.set_user_vectors(user_ids[topic_rows:], x[topic_rows:])
    model.add_known_items_many(
        (user_ids[j], [item_ids[t] for t in known[j]]) for j in range(len(x)))
    return model


def percentile(values: list, q: float) -> float:
    """The ``q`` quantile of ``values`` by rank, the nearest rank above."""
    if not values:
        return 0.0
    ordered = sorted(values)
    return ordered[max(0, int(np.ceil(q * len(ordered))) - 1)]


def parse_answer(body: str) -> list[tuple[int, float]]:
    return [(int(e["id"][1:]), float(e["value"])) for e in json.loads(body)]


def compare(records: list, sample: list, x, y_dev, known, how_many: int) -> dict:
    """The numbers compared over the sampled answers: served items that are
    known, repeated or missing; the widest relative gap between a served
    score and the reference's score of that item; the widest relative gap
    by which a served item's reference score lies below the reference's
    score at that rank. Both gaps are relative to the user's best score."""
    users = np.array([records[j]["user"] for j in sample], np.int64)
    answers = [parse_answer(records[j]["body"]) for j in sample]
    served = np.full((len(sample), how_many), -1, np.int64)
    values = np.full((len(sample), how_many), np.nan)
    wrong = 0
    for row, answer in enumerate(answers):
        ids = [a for a, _ in answer][:how_many]
        mine = set(known[users[row]].tolist())
        wrong += abs(len(answer) - how_many) + (len(ids) - len(set(ids)))
        wrong += sum(1 for a in ids if a in mine)
        served[row, : len(ids)] = ids
        values[row, : len(ids)] = [v for _, v in answer][:how_many]
    best, of_served = reference.top_n(x[users], y_dev, [known[u] for u in users], how_many,
                                      served)
    scale = np.abs(best[:, :1]).astype(np.float64)
    score_err = np.nanmax(np.abs(values - of_served) / scale) if len(sample) else 0.0
    rank_gap = np.nanmax(np.maximum(best - of_served, 0.0) / scale) if len(sample) else 0.0
    return {"wrong_items": float(wrong), "score_err": float(score_err),
            "rank_gap": float(rank_gap)}


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", overrides: dict | None = None) -> dict:
    import torch

    from oryx_tpu_torch.bus.inproc import InProcessBroker
    from oryx_tpu_torch.common import config as config_utils, tracing
    from oryx_tpu_torch.ops import streaming_topn as stn
    from oryx_tpu_torch.serving.layer import ServingLayer

    conf, mix = cell.config, cell.traffic
    settings = {
        "oryx.input-topic.broker": BROKER,
        "oryx.update-topic.broker": BROKER,
        "oryx.serving.api.port": 0,
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.app.als",
        **conf["oryx"],
        **(overrides or {}),
    }
    if trace:
        settings.update({"oryx.tracing.sample-rate": 1.0,
                         "oryx.tracing.ring-capacity": int(mix["trace_ring"])})
    cfg = config_utils.get_default().with_overlay(overlay(settings))
    score_dtype = cfg.get_string("oryx.als.serving.score-dtype")

    at = note("imports", time.perf_counter() - (time.time() - t_start))
    x, y, known = make_inputs(conf, seed, device)
    at = note("factors and known items", at)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    how_many = int(mix["how_many"])
    layer = ServingLayer(cfg)
    client = None
    try:
        layer.start()
        model = load_model(layer, conf, x, y, known, int(mix["topic_rows"]))
        at = note("model loaded", at)
        base = f"http://127.0.0.1:{layer.port}"
        if _get(base + mix["path"].format(user=0)) != 200:
            raise RuntimeError("the first /recommend failed")
        restage = model._x_restage_thread
        if restage is not None:
            restage.join(600)
        if model._x_matrix is None:
            raise RuntimeError("the user matrix was not staged on the card")
        del model
        at = note("first /recommend and the card copies", at)
        spec = {**mix, "host": "127.0.0.1", "port": layer.port, "users": conf["users"],
                "seed": seed, "seconds": float(seconds)}
        client = subprocess.Popen(
            [sys.executable, "-m", "portbench.traffic.closed_loop"], cwd=CHECKOUT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        client.stdin.write(json.dumps(spec) + "\n")
        client.stdin.flush()
        if client.stdout.readline().strip() != "warm":
            raise RuntimeError("the client did not warm up")
        at = note("client warm-up", at)
        launches0, batches0 = stn.launch_counts(), stn.scan_batch_histogram()
        setup_s = time.time() - t_start
        with devtrace.Capture(trace) as cap:
            go_wall = time.time()
            client.stdin.write("go\n")
            client.stdin.flush()
            if client.stdout.readline().strip() != "done":
                raise RuntimeError("the client did not finish its window")
        records = []
        for line in client.stdout:
            if line.strip() == "end":
                break
            records.append(json.loads(line))
        if client.wait(120) != 0:
            raise RuntimeError(f"the client exited {client.returncode}")
        client = None
        launches1, batches1 = stn.launch_counts(), stn.scan_batch_histogram()
        spans = [s for s in tracing.spans() if s["ts"] >= go_wall] if trace else []
        memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        at = note("window and its trace", at)
    finally:
        if client is not None:
            client.kill()
            client.wait()
        layer.close()
        InProcessBroker.reset_all()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    ok = [j for j, r in enumerate(records) if r["status"] == 200]
    # the ladder's reduced-probe rung narrows only an IVF scan: on the exact
    # scan its answers are full ones; the stale rung's are not
    full = [j for j in ok if records[j]["stage"] != "stale"]
    in_window = [j for j in full if records[j]["done"] <= seconds]
    lost = sum(1 for r in records if r["status"] not in (200, 429))
    lat = [r["ms"] for r in records]
    p50, p95 = percentile(lat, 0.5), percentile(lat, 0.95)
    scans = sum(launches1[key] - launches0.get(key, 0)
                for key in launches1 if key.startswith(("topn_scan.", "topn_candidates.")))
    scan_batches = {}
    for key, hist in batches1.items():
        for b, n in hist.items():
            grew = n - batches0.get(key, {}).get(b, 0)
            if grew:
                scan_batches[(key, b)] = grew
    artefacts = {
        "kind": "als_serve",
        "window_s": float(seconds),
        "answers": len(ok),
        "answers_full": len(in_window),
        "scan_launches": scans,
        "scan_batches": scan_batches,
        "n_items": conf["items"], "features": conf["features"], "how_many": how_many,
        "score_dtype": score_dtype,
        "spans": spans,
        "trace": cap.trace,
    }
    e2e = {
        "recommend_rps": {"value": len(in_window) / float(seconds), "unit": "requests/s"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    breakdown = None
    if cap.trace is not None:
        host = [(s["name"], s["ts"], s["dur"]) for s in spans]
        breakdown = {"device_ops": cap.trace.top_ops(), "idle_gaps": cap.trace.idle_gaps(host)}

    gen = np.random.default_rng(derived_seed(seed, 2))
    want = min(len(ok), int(mix["compare_sample"]))
    sample = sorted(set(gen.choice(ok, want, replace=False).tolist())) if want else []
    if ok:
        sample = sorted(set(sample) | {max(ok, key=lambda j: records[j]["ms"])})
    y_dev = torch.from_numpy(y).to(device)
    numbers = compare(records, sample, x, y_dev, known, how_many)
    numbers["lost"] = float(lost)
    note("reference and comparison", at)
    del y_dev
    stages = Counter((r["status"], r["stage"]) for r in records)
    print(f"answers by status and rung: {dict(stages)}; {len(in_window)} full in the window; "
          f"latency p50 {p50:.3f} ms, p95 {p95:.3f} ms", file=sys.stderr)
    return {
        "attempted": len(records), "failed": len(records) - len(full), "e2e": e2e,
        "artefacts": artefacts, "memory_peak_bytes": memory_peak, "breakdown": breakdown,
        "numbers": numbers,
    }
