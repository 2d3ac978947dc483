"""K-means batch trainer.

Rebuild of KMeansUpdate (app/oryx-app-mllib/.../kmeans/KMeansUpdate.java:
68-234): numeric-only schema check, `runs` independent restarts per
candidate with the best cost winning (MLlib's `runs` parameter,
KMeansUpdate.java:70-81), ClusteringModel PMML with cluster sizes, and
an evaluation strategy chosen by config (SSE / DAVIES_BOULDIN / DUNN /
SILHOUETTE, KMeansUpdate.evaluate:139-178 — metrics where lower is
better are negated so MLUpdate can always maximize).

Port note: a copy of ``oryx_tpu/app/kmeans/update.py`` with its imports
pointed at ``oryx_tpu_torch``. Training runs on the one default card
(``ops/kmeans.train_kmeans``, through the B3 sweep kernels), even where
the host has several; a config that sets ``oryx.batch.compute.mesh``
raises NotYetPortedError.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterable, Sequence
from xml.etree.ElementTree import Element

import numpy as np

from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch.app.kmeans import common as km
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.text import parse_line
from oryx_tpu_torch.ml import param as hp
from oryx_tpu_torch.ml.update import MLUpdate
from oryx_tpu_torch.ops import kmeans as km_ops
from oryx_tpu_torch.ops import pallas_kmeans

log = logging.getLogger(__name__)

EVAL_STRATEGIES = ("SSE", "DAVIES_BOULDIN", "DUNN", "SILHOUETTE")


class KMeansUpdate(MLUpdate):
    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.iterations = config.get_int("oryx.kmeans.iterations")
        self.init_strategy = config.get_string("oryx.kmeans.initialization-strategy")
        self.runs = config.get_int("oryx.kmeans.runs")
        self.eval_strategy = config.get_string("oryx.kmeans.evaluation-strategy").upper()
        self.minibatch_size = config.get_optional_int("oryx.ml.kmeans.minibatch-size")
        if self.eval_strategy not in EVAL_STRATEGIES:
            raise ValueError(f"unknown evaluation-strategy {self.eval_strategy}")
        if self.init_strategy not in ("k-means||", "random"):
            raise ValueError(f"unknown initialization-strategy {self.init_strategy}")
        if self.minibatch_size is not None and self.minibatch_size <= 0:
            raise ValueError("oryx.ml.kmeans.minibatch-size must be positive")
        if config.get("oryx.batch.compute.mesh", None) is not None:
            raise NotYetPortedError(
                "oryx.batch.compute.mesh is set, but k-means over a device mesh is "
                "not yet ported to oryx_tpu_torch"
            )
        self.schema = InputSchema(config)
        km.check_numeric_only(self.schema)
        self._config = config

    def get_hyper_parameter_values(self) -> list[hp.HyperParamValues]:
        return [hp.from_config(self._config, "oryx.kmeans.hyperparams.k")]

    def _points(self, data: Iterable[KeyMessage]) -> np.ndarray:
        rows = [
            km.features_from_tokens(parse_line(rec.message), self.schema) for rec in data
        ]
        if not rows:
            return np.zeros((0, self.schema.num_predictors))
        return np.stack(rows)

    def build_model(
        self,
        train_data: list[KeyMessage],
        hyper_parameters: Sequence,
        candidate_path: Path,
    ) -> Element:
        k = int(hyper_parameters[0])
        if k <= 1:
            raise ValueError("k must be > 1")
        points = self._points(train_data)
        if len(points) == 0:
            raise ValueError("no points to cluster")
        # warm-start: run 0 seeds Lloyd from the champion's centers (the
        # remaining runs stay independent restarts, so a drifted previous
        # model can't trap every run in its basin); train_kmeans falls
        # back to cold init when k or the feature dim changed
        warm_centers = self._warm_start_centers()
        best = None
        for run in range(max(1, self.runs)):
            centers, counts, cost = km_ops.train_kmeans(
                points,
                k,
                iterations=self.iterations,
                init=self.init_strategy,
                initial_centers=warm_centers if run == 0 else None,
                minibatch_size=self.minibatch_size,
            )
            log.info("k-means run %d: cost=%.4f", run, cost)
            if best is None or cost < best[2]:
                best = (centers, counts, cost)
        centers, counts, _ = best
        # the process's sweep launches so far, where the batch UI's
        # /metrics shows them (oryx.batch.ui.port)
        for name, n in pallas_kmeans.launch_counts().items():
            metrics.registry.gauge(f"kernels.{name}.launches").set(n)
        clusters = [
            km.ClusterInfo(i, centers[i].astype(np.float64), int(counts[i]))
            for i in range(len(centers))
        ]
        return km.clusters_to_pmml(clusters, self.schema)

    def _warm_start_centers(self) -> np.ndarray | None:
        """Champion centers from MLUpdate.load_previous_model's PMML, or
        None for a cold start."""
        if self.previous_model is None:
            return None
        try:
            clusters = km.pmml_to_clusters(self.previous_model)
            centers = np.stack([c.center for c in clusters]).astype(np.float32)
        except Exception:
            log.warning("unreadable previous centers; cold-starting", exc_info=True)
            return None
        log.info(
            "warm-start from generation %s: seeding %d centers",
            self.previous_generation_id, len(centers),
        )
        return centers

    def evaluate(
        self,
        model: Element,
        model_parent_path: Path,
        test_data: list[KeyMessage],
        train_data: list[KeyMessage],
    ) -> float:
        clusters = km.pmml_to_clusters(model)
        points = self._points(test_data if test_data else train_data)
        if len(points) == 0:
            return float("nan")
        centers = np.stack([c.center for c in clusters])
        if self.eval_strategy == "SSE":
            return -km_ops.sum_squared_error(points, centers)  # lower better
        if self.eval_strategy == "DAVIES_BOULDIN":
            return -km_ops.davies_bouldin_index(points, centers)  # lower better
        if self.eval_strategy == "DUNN":
            return km_ops.dunn_index(points, centers)
        return km_ops.silhouette_coefficient(points, centers)
