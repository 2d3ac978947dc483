"""ALS model builds: generations of the port's ``ops.als.train_als`` back to
back on one seeded COO, each called as ``ALSUpdate.build_model`` calls it
(the configuration's settings and packing options, the mesh the config
gives). Each generation starts from item factors of its own seed.

Set-up draws the ratings (one set from the configuration's data seed,
relabelled and reordered by the run's seed) and runs one warm-up generation of
``warmup_iterations``. The window runs whole generations: none starts
that, at the pace measured so far, would not end inside ``seconds``, but
the first always runs; it closes when the last one ends. The comparison
takes one generation of the window, drawn from the seed, and holds its
factors against the plain reference trained from the same seed.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import devtrace, roofline
from portbench.harness import derived_seed, note, overlay
from portbench.reference import als_train as reference
from portbench.traffic.movielens import relabelled


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    """The worst row's distance from the reference, over the larger of that
    row's reference norm and the median row's; rows the reference leaves
    at zero (no rating) count against the median row."""
    norms = np.linalg.norm(want, axis=1)
    scale = np.maximum(norms, np.median(norms[norms > 0]))
    return float((np.linalg.norm(got - want, axis=1) / scale).max())


def compare(model_x, model_y, ref_x, ref_y, u, i, seed: int, pairs: int) -> dict:
    """The numbers compared: the worst user row's and item row's gap, and
    the relative RMS gap of the predictions at ``pairs`` pairs drawn from
    the seed, half of them rated."""
    gen = np.random.default_rng(derived_seed(seed, 3))
    rated = gen.integers(0, len(u), pairs // 2)
    pu = np.concatenate([u[rated], gen.integers(0, ref_x.shape[0], pairs - pairs // 2)])
    pi = np.concatenate([i[rated], gen.integers(0, ref_y.shape[0], pairs - pairs // 2)])
    want = np.einsum("nk,nk->n", ref_x[pu].astype(np.float64), ref_y[pi].astype(np.float64))
    got = np.einsum("nk,nk->n", model_x[pu].astype(np.float64), model_y[pi].astype(np.float64))
    finite = bool(np.isfinite(model_x).all() and np.isfinite(model_y).all())
    return {
        "x_row_gap": _gap(model_x, ref_x) if finite else float("inf"),
        "y_row_gap": _gap(model_y, ref_y) if finite else float("inf"),
        "pred_gap": float(np.linalg.norm(got - want) / np.linalg.norm(want))
        if finite else float("inf"),
    }


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", overrides: dict | None = None) -> dict:
    import torch

    from oryx_tpu_torch.app.als.update import ALSUpdate
    from oryx_tpu_torch.common import config as config_utils
    from oryx_tpu_torch.ops import als as als_ops
    from oryx_tpu_torch.parallel.mesh import mesh_from_config

    conf = cell.config
    cfg = config_utils.get_default().with_overlay(overlay({**conf["oryx"], **(overrides or {})}))
    update = ALSUpdate(cfg)
    features = cfg.get_int("oryx.als.hyperparams.features")
    lam = cfg.get_float("oryx.als.hyperparams.lambda")
    alpha = cfg.get_float("oryx.als.hyperparams.alpha")
    matmul_dtype = cfg.get("oryx.batch.compute.matmul-dtype", None)
    if not update.implicit:
        raise ValueError("the ALS training driver runs implicit configurations")
    users, items, nnz = conf["users"], conf["items"], conf["ratings"]
    at = note("imports", time.perf_counter() - (time.time() - t_start))
    u, i, r = relabelled(users, items, nnz, conf["data_seed"], derived_seed(seed, 0), device)
    if device == "cuda":  # the peak is the program's, not the generator's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    at = note("ratings", at)

    def generation(iterations: int, init_seed: int):
        mesh = mesh_from_config(cfg)
        model = als_ops.train_als(
            u, i, r, users, items, features=features, lam=lam, alpha=alpha,
            implicit=update.implicit, iterations=iterations, mesh=mesh,
            seed=init_seed,
            shard_factors=mesh is not None
            and bool(cfg.get("oryx.batch.compute.shard-factors", False)),
            matmul_dtype=matmul_dtype, packing=update.packing,
        )
        return model, dict(als_ops.last_phase_seconds)

    warm_iterations = int(cell.traffic["warmup_iterations"])
    _, warm = generation(warm_iterations, derived_seed(seed, 1, 0))
    at = note("warm-up generation", at)
    # a whole generation's pace from the warm-up's: every phase but the
    # sweeps once, the sweeps scaled to the full count
    pace = warm["pack"] + warm["init"] + warm["iterate"] * update.iterations / warm_iterations
    setup_s = time.time() - t_start

    gens, models, host_spans = [], [], []
    with devtrace.Capture(trace) as cap:
        w0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - w0
            if gens and elapsed + pace > seconds:
                break
            init_seed = derived_seed(seed, 1, len(gens) + 1)
            g0, wall0 = time.perf_counter(), time.time()
            model, phases = generation(update.iterations, init_seed)
            took = time.perf_counter() - g0
            gens.append({**phases, "seconds": took, "init_seed": init_seed})
            models.append(model)
            t_span = wall0
            for name in ("pack", "init", "iterate"):
                host_spans.append((f"train_als.{name}", t_span, phases[name]))
                t_span += phases[name]
            pace = sum(g["seconds"] for g in gens) / len(gens)
        window_s = time.perf_counter() - w0
    at = note(f"window of {len(gens)} generations and its trace", w0)
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    rows_u = int(np.count_nonzero(np.bincount(u, minlength=users)))
    rows_i = int(np.count_nonzero(np.bincount(i, minlength=items)))
    artefacts = {
        "kind": "als_train",
        "window_s": window_s,
        "generations": gens,
        "iterations": update.iterations,
        "model_flops_per_iteration": roofline.als_model_flops(
            nnz, rows_u, rows_i, users, items, features),
        "gram_cost": roofline.als_gram_cost(nnz, rows_u + rows_i, users, items, features),
        "solve_cost": roofline.als_solve_cost(rows_u + rows_i, features),
        "trace": cap.trace,
    }
    e2e = {
        "train_ratings_per_s": {
            "value": nnz * update.iterations * len(gens) / window_s, "unit": "ratings/s"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    breakdown = None
    if cap.trace is not None:
        breakdown = {"device_ops": cap.trace.top_ops(),
                     "idle_gaps": cap.trace.idle_gaps(host_spans)}

    # the comparison, with the program's state freed
    pick = int(np.random.default_rng(derived_seed(seed, 2)).integers(0, len(models)))
    model = models[pick]
    del models
    if device == "cuda":
        torch.cuda.empty_cache()
    ref_x, ref_y = reference.train(u, i, r, users, items, features, lam, alpha,
                                   update.iterations, gens[pick]["init_seed"], device)
    numbers = compare(model.x, model.y, ref_x, ref_y, u, i, seed,
                      int(cell.traffic["compare_pairs"]))
    note("reference and comparison", at)
    return {
        "attempted": len(gens), "failed": 0, "e2e": e2e, "artefacts": artefacts,
        "memory_peak_bytes": memory_peak, "breakdown": breakdown, "numbers": numbers,
    }
