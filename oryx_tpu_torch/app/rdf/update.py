"""RDF batch trainer.

Rebuild of RDFUpdate (app/oryx-app-mllib/.../rdf/RDFUpdate.java:89-559)
on the histogram trainer (oryx_tpu_torch.ops.forest): distinct categorical
values -> encodings, quantile/ordered binning, level-wise forest growth
on device, conversion of the flat heap arrays into portable
DecisionTrees with real thresholds/category sets, per-node recordCounts
and feature importances (the reference re-runs training data down the
trees for these, RDFUpdate.treeNodeExampleCounts:269-; here the node
stats fall out of the histogram pass), PMML MiningModel/Segmentation
output, and accuracy / negated-RMSE evaluation against the app-tier
forest (batch/mllib/rdf/Evaluation.java:54).

Port note: a copy of ``oryx_tpu/app/rdf/update.py`` with its imports
pointed at ``oryx_tpu_torch``. Training runs ``ops/forest.train_forest``'s
device path, over the mesh ``parallel.mesh.mesh_from_config`` gives
(``oryx.batch.compute.mesh``), else on the one default card. ``evaluate`` keeps
the reference's per-row host prediction through the app-tier forest.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Sequence
from xml.etree.ElementTree import Element

import numpy as np

from oryx_tpu_torch.app.rdf import encode, forest_pmml, tree as T
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.ml import param as hp
from oryx_tpu_torch.ml.update import MLUpdate
from oryx_tpu_torch.ops import forest as forest_ops
from oryx_tpu_torch.parallel.mesh import mesh_from_config

log = logging.getLogger(__name__)


class RDFUpdate(MLUpdate):
    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.num_trees = config.get_int("oryx.rdf.num-trees")
        self.min_node_size = config.get_int("oryx.rdf.hyperparams.min-node-size")
        self.min_info_gain = config.get_float("oryx.rdf.hyperparams.min-info-gain-nats")
        self.hist_mode = config.get_string("oryx.ml.rdf.hist-mode")
        if self.hist_mode not in ("auto", "matmul", "scalar", "reference"):
            raise ValueError(f"unknown oryx.ml.rdf.hist-mode {self.hist_mode!r}")
        self.schema = InputSchema(config)
        if not self.schema.has_target():
            raise ValueError("rdf requires a target feature")
        self.classification = self.schema.is_categorical(self.schema.target_feature)
        self._config = config

    def get_hyper_parameter_values(self) -> list[hp.HyperParamValues]:
        c = self._config
        return [
            hp.from_config(c, "oryx.rdf.hyperparams.max-split-candidates"),
            hp.from_config(c, "oryx.rdf.hyperparams.max-depth"),
            hp.from_config(c, "oryx.rdf.hyperparams.impurity"),
        ]

    def build_model(
        self,
        train_data: list[KeyMessage],
        hyper_parameters: Sequence,
        candidate_path: Path,
    ) -> Element:
        # Warm-start (MLUpdate.load_previous_model) is a deliberate no-op
        # for RDF: level-wise histogram growth rebuilds every tree from
        # the root, and seeding structure from a previous forest would
        # bias split selection without saving any device work (unlike ALS
        # factors / k-means centers, tree structure is not an iterate that
        # later sweeps refine). self.previous_model stays available should
        # an incremental variant (e.g. warm residual boosting) land.
        max_split_candidates = int(hyper_parameters[0])
        max_depth = int(hyper_parameters[1])
        impurity = str(hyper_parameters[2])
        if max_split_candidates < 2 or max_depth < 1:
            raise ValueError(f"bad hyperparams {hyper_parameters}")

        encodings = encode.build_encodings(train_data, self.schema)
        features, targets = encode.parse_examples(train_data, self.schema, encodings)
        binning = encode.build_binning(
            features, targets, self.schema, max_split_candidates, self.classification
        )
        binned = encode.bin_features(features, binning)
        tfi = self.schema.target_feature_index
        num_classes = encodings.category_count(tfi) if self.classification else None

        target_pred = self.schema.feature_to_predictor_index(tfi)
        arrays = forest_ops.train_forest(
            binned,
            targets.astype(np.int32) if self.classification else targets,
            num_bins=binning.num_bins,
            num_classes=num_classes,
            num_trees=self.num_trees,
            max_depth=max_depth,
            min_node_size=float(self.min_node_size),
            min_info_gain=self.min_info_gain,
            impurity=impurity,
            exclude_features={target_pred},
            mesh=mesh_from_config(self._config),
            hist_mode=self.hist_mode,
        )
        log.info(
            "forest of %d trees on %d rows: init %.3f s, iterate %.3f s",
            self.num_trees, len(binned), forest_ops.last_phase_seconds.get("init", 0.0),
            forest_ops.last_phase_seconds.get("iterate", 0.0),
        )
        importances = forest_ops.feature_importances(arrays, features.shape[1])
        forest = arrays_to_forest(arrays, binning, importances)
        return forest_pmml.forest_to_pmml(forest, self.schema, encodings)

    def evaluate(
        self,
        model: Element,
        model_parent_path: Path,
        test_data: list[KeyMessage],
        train_data: list[KeyMessage],
    ) -> float:
        forest, encodings = forest_pmml.pmml_to_forest(model, self.schema)
        data = test_data if test_data else train_data
        if not data:
            return float("nan")
        features, targets = encode.parse_examples(
            data, self.schema, encodings, skip_unknown=True
        )
        if len(targets) == 0:
            return float("nan")
        if self.classification:
            correct = 0
            for row, target in zip(features, targets):
                pred = forest.predict(row)
                if pred.most_probable_index == int(target):
                    correct += 1
            return correct / len(targets)
        se = 0.0
        for row, target in zip(features, targets):
            pred = forest.predict(row)
            se += (pred.prediction - target) ** 2
        return -math.sqrt(se / len(targets))


def arrays_to_forest(
    arrays: forest_ops.ForestArrays,
    binning: encode.FeatureBinning,
    importances: np.ndarray | None = None,
) -> T.DecisionForest:
    """Convert flat heap arrays to portable DecisionTrees, mapping bins
    back to thresholds / category sets."""
    trees = []
    for t in range(arrays.num_trees):
        trees.append(T.DecisionTree(_node_from_heap(arrays, t, 0, "r", binning)))
    return T.DecisionForest(trees, [1.0] * len(trees), importances)


def _node_from_heap(arrays, t: int, heap: int, node_id: str, binning):
    feat = int(arrays.split_feature[t, heap])
    stats = arrays.node_stats[t, heap]
    count = arrays.node_counts[t, heap]
    if feat < 0:
        if arrays.num_classes is not None:
            return T.TerminalNode(node_id, T.CategoricalPrediction(stats), int(count))
        w, wy = stats[0], stats[1]
        mean = wy / w if w > 0 else 0.0
        return T.TerminalNode(node_id, T.NumericPrediction(mean, int(w)), int(count))
    b = int(arrays.split_bin[t, heap])
    if feat in binning.numeric_cuts:
        cuts = binning.numeric_cuts[feat]
        cut = cuts[min(b, len(cuts) - 1)]
        decision = T.NumericDecision(feat, float(np.nextafter(cut, np.inf)))
    else:
        order = binning.rank_to_category[feat]
        positive = frozenset(int(c) for c in order[b + 1 :])
        decision = T.CategoricalDecision(feat, positive)
    negative = _node_from_heap(arrays, t, 2 * heap + 1, node_id + "-", binning)
    positive_child = _node_from_heap(arrays, t, 2 * heap + 2, node_id + "+", binning)
    return T.DecisionNode(node_id, decision, negative, positive_child, int(count))
