"""Shared k-means app logic.

Rebuild of app/oryx-app-common kmeans/: ClusterInfo (id/center/count with
running-mean update, ClusterInfo.java:26-71), nearest-cluster assignment
(KMeansUtils.java), feature parsing against the InputSchema, and
ClusteringModel PMML read/write (KMeansPMMLUtils.java).

Port note: a copy of ``oryx_tpu/app/kmeans/common.py`` (JAX-free),
with its imports pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence
from xml.etree.ElementTree import Element

import numpy as np

from oryx_tpu_torch.app import pmml as app_pmml
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.common import pmml as pmml_io


@dataclass
class ClusterInfo:
    """One cluster: stable id, center, and member count; update() folds a
    batch of points into the center as a weighted running mean
    (ClusterInfo.update:52)."""

    id: int
    center: np.ndarray
    count: int

    def update(self, point_sum: np.ndarray, point_count: int) -> None:
        total = self.count + point_count
        if total <= 0:
            return
        self.center = (self.center * self.count + np.asarray(point_sum, dtype=np.float64)) / total
        self.count = total


def distance(a: np.ndarray, b: np.ndarray) -> float:
    """Euclidean (EuclideanDistanceFn.java)."""
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


def closest_cluster(clusters: Sequence[ClusterInfo], point: np.ndarray) -> tuple[ClusterInfo, float]:
    """(nearest cluster, distance) (KMeansUtils.closestCluster)."""
    if not clusters:
        raise ValueError("no clusters")
    centers = np.stack([c.center for c in clusters]).astype(np.float64)
    p = np.asarray(point, np.float64)
    d = np.linalg.norm(centers - p[None, :], axis=1)
    i = int(np.argmin(d))
    return clusters[i], float(d[i])


def features_from_tokens(tokens: Sequence[str], schema: InputSchema) -> np.ndarray:
    """Active numeric features from an input line (KMeansUtils
    .featuresFromTokens); schema must be all-numeric for k-means
    (KMeansUpdate.java:82-86 check)."""
    out = []
    for i, tok in enumerate(tokens[: schema.num_features]):
        if schema.is_active(i):
            out.append(float(tok))
    return np.asarray(out, dtype=np.float64)


def check_numeric_only(schema: InputSchema) -> None:
    for i in range(schema.num_features):
        if schema.is_active(i) and not schema.is_numeric(i):
            raise ValueError("k-means requires an all-numeric input schema")


# -- PMML ClusteringModel ----------------------------------------------------


def clusters_to_pmml(clusters: Sequence[ClusterInfo], schema: InputSchema) -> Element:
    """ClusteringModel with per-cluster size and center Array
    (KMeansPMMLUtils.clusteringModelToPMML / KMeansUpdate.kMeansModelToPMML:
    184-221)."""
    root = pmml_io.build_skeleton_pmml()
    app_pmml.build_data_dictionary(root, schema)
    # no modelName: the reference constructs ClusteringModel(<function>,
    # <modelClass>, <n>, ...) without one (KMeansUpdate.java:214-221)
    model = pmml_io.sub(
        root,
        "ClusteringModel",
        {
            "functionName": "clustering",
            "modelClass": "centerBased",
            "numberOfClusters": str(len(clusters)),
        },
    )
    app_pmml.build_mining_schema(model, schema)
    cm = pmml_io.sub(model, "ComparisonMeasure", {"kind": "distance"})
    pmml_io.sub(cm, "squaredEuclidean")
    for i, name in enumerate(schema.feature_names):
        if schema.is_active(i):
            pmml_io.sub(
                model, "ClusteringField", {"field": name, "centerField": "true"}
            )
    for c in clusters:
        cl = pmml_io.sub(model, "Cluster", {"id": str(c.id), "size": str(int(c.count))})
        arr = pmml_io.sub(
            cl, "Array", {"n": str(len(c.center)), "type": "real"}
        )
        arr.text = " ".join(repr(float(v)) for v in c.center)
    return root


def pmml_to_clusters(root: Element) -> list[ClusterInfo]:
    """Inverse of clusters_to_pmml (KMeansPMMLUtils.read)."""
    model = pmml_io.find(root, "ClusteringModel")
    if model is None:
        raise ValueError("no ClusteringModel in PMML")
    out: list[ClusterInfo] = []
    for cl in pmml_io.findall(model, "Cluster"):
        arr = pmml_io.find(cl, "Array")
        center = np.asarray([float(t) for t in (arr.text or "").split()], dtype=np.float64)
        out.append(ClusterInfo(int(cl.get("id")), center, int(cl.get("size", "0"))))
    return out
