"""K-means serving: model, manager, and endpoints.

Rebuild of KMeansServingModel (app/oryx-app-serving/.../kmeans/model/
KMeansServingModel.java:34-83) + manager, and the clustering endpoints:
GET /assign (clustering/Assign.java:52), POST /add (clustering/Add.java:
43), GET /distanceToNearest (kmeans/DistanceToNearest.java:40).

Port note: a copy of ``oryx_tpu/app/kmeans/serving.py`` with its imports
pointed at ``oryx_tpu_torch``, less the HTML console routes, which wait
for the port's serving console (with the ALS console).
"""

from __future__ import annotations

import logging
import threading
from typing import Iterator

import numpy as np

from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.app import pmml as app_pmml
from oryx_tpu_torch.app.kmeans import common as km
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.app.serving_common import check_not_read_only, get_ready_model, send_input
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.text import parse_line, read_json
from oryx_tpu_torch.serving.web import OryxServingException, Request, Response, ServingContext, resource

log = logging.getLogger(__name__)


class KMeansServingModel(ServingModel):
    def __init__(self, clusters: list[km.ClusterInfo], schema: InputSchema) -> None:
        self._lock = threading.Lock()
        self._clusters = {c.id: c for c in clusters}
        self.schema = schema

    def get_fraction_loaded(self) -> float:
        return 1.0  # loads all at once (KMeansServingModel is whole-model)

    def clusters(self) -> list[km.ClusterInfo]:
        with self._lock:
            return list(self._clusters.values())

    def closest_cluster(self, point: np.ndarray) -> tuple[km.ClusterInfo, float]:
        return km.closest_cluster(self.clusters(), point)

    def update(self, cluster_id: int, center: np.ndarray, count: int) -> None:
        with self._lock:
            self._clusters[cluster_id] = km.ClusterInfo(cluster_id, center, count)


class KMeansServingModelManager(AbstractServingModelManager):
    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.schema = InputSchema(config)
        km.check_numeric_only(self.schema)
        self.model: KMeansServingModel | None = None

    def consume(self, update_iterator: Iterator[KeyMessage]) -> None:
        for kmsg in update_iterator:
            key, message = kmsg.key, kmsg.message
            if key == "UP":
                if self.model is None:
                    continue
                cluster_id, center, count = read_json(message)
                self.model.update(int(cluster_id), np.asarray(center, np.float64), int(count))
            elif key in ("MODEL", "MODEL-REF"):
                pmml = app_pmml.read_pmml_from_update_message(key, message)
                if pmml is None:
                    log.warning("dropped unreadable model update")
                    continue
                self.model = KMeansServingModel(km.pmml_to_clusters(pmml), self.schema)
            else:
                raise ValueError(f"bad key {key}")

    def get_model(self) -> KMeansServingModel | None:
        return self.model


def _point_from_path(model: KMeansServingModel, datum: str) -> np.ndarray:
    try:
        point = km.features_from_tokens(parse_line(datum), model.schema)
    except (ValueError, IndexError):
        raise OryxServingException(400, f"bad input {datum!r}")
    if len(point) != model.schema.num_predictors:
        raise OryxServingException(
            400, f"expected {model.schema.num_predictors} features, got {len(point)}"
        )
    return point


@resource("GET", "/assign/{datum}")
def assign(ctx: ServingContext, req: Request):
    """Nearest cluster id for one datum (clustering/Assign.java)."""
    model = get_ready_model(ctx)
    cluster, _ = model.closest_cluster(_point_from_path(model, req.params["datum"]))
    return str(cluster.id)


@resource("POST", "/assign")
def assign_many(ctx: ServingContext, req: Request):
    """One cluster id per body line."""
    model = get_ready_model(ctx)
    out = []
    for line in req.text().splitlines():
        if line.strip():
            cluster, _ = model.closest_cluster(_point_from_path(model, line.strip()))
            out.append(str(cluster.id))
    return out


@resource("GET", "/distanceToNearest/{datum}")
def distance_to_nearest(ctx: ServingContext, req: Request):
    """kmeans/DistanceToNearest.java."""
    model = get_ready_model(ctx)
    _, dist = model.closest_cluster(_point_from_path(model, req.params["datum"]))
    return dist


@resource("POST", "/add")
def add(ctx: ServingContext, req: Request) -> Response:
    """Queue new data points to the input topic (clustering/Add.java)."""
    check_not_read_only(ctx)
    for line in req.text().splitlines():
        if line.strip():
            send_input(ctx, line.strip())
    return Response(204)
