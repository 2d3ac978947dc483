"""RDF speed layer: leaf-statistic refresh from new examples.

Rebuild of RDFSpeedModel (app/oryx-app/.../speed/rdf/RDFSpeedModel.java:
28-58) and RDFSpeedModelManager (.../RDFSpeedModelManager.java:59-153):
run each new example down every tree to its terminal node, group by
(treeID, nodeID), and emit per-leaf updates — classification:
``[treeID, nodeID, {category: count...}]``; regression:
``[treeID, nodeID, mean, count]``.

Port note: a copy of ``oryx_tpu/app/rdf/speed.py`` with its imports
pointed at ``oryx_tpu_torch``, and a log line when a model arrives. The
micro-batch's descent stays on the host (``find_terminals_batch``), as in
the JAX package, so both emit the same UP messages.
"""

from __future__ import annotations

import logging
from typing import Iterable, Iterator

from oryx_tpu_torch.api.speed import SpeedModel, SpeedModelManager
from oryx_tpu_torch.app import pmml as app_pmml
from oryx_tpu_torch.app.rdf import encode, forest_pmml, tree as T
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.text import join_json

log = logging.getLogger(__name__)


class RDFSpeedModel(SpeedModel):
    def __init__(self, forest: T.DecisionForest, encodings) -> None:
        self.forest = forest
        self.encodings = encodings

    def get_fraction_loaded(self) -> float:
        return 1.0


class RDFSpeedModelManager(SpeedModelManager):
    def __init__(self, config: Config) -> None:
        self.schema = InputSchema(config)
        if not self.schema.has_target():
            raise ValueError("rdf requires a target feature")
        self.classification = self.schema.is_categorical(self.schema.target_feature)
        self.model: RDFSpeedModel | None = None

    def consume(self, update_iterator: Iterator[KeyMessage]) -> None:
        for km in update_iterator:
            key, message = km.key, km.message
            if key == "UP":
                pass  # leaf updates are applied by serving; speed ignores its own
            elif key in ("MODEL", "MODEL-REF"):
                pmml = app_pmml.read_pmml_from_update_message(key, message)
                if pmml is None:
                    log.warning("dropped unreadable model update")
                    continue
                forest, encodings = forest_pmml.pmml_to_forest(pmml, self.schema)
                self.model = RDFSpeedModel(forest, encodings)
                log.info("RDF speed model: %d trees", len(forest.trees))
            else:
                raise ValueError(f"bad key {key}")

    def build_updates(self, new_data: Iterable[KeyMessage]) -> Iterable[str]:
        model = self.model
        if model is None:
            return []
        features, targets = encode.parse_examples(
            new_data, self.schema, model.encodings, skip_unknown=True
        )
        tfi = self.schema.target_feature_index
        # (treeID, nodeID) -> stats; one vectorized descent per tree
        # (find_terminals_batch), not a Python walk per (example, tree)
        by_leaf: dict[tuple[int, str], list] = {}
        for tree_id, tree in enumerate(model.forest.trees):
            leaves = tree.find_terminals_batch(features)
            for leaf, target in zip(leaves, targets):
                key = (tree_id, leaf.id)
                if self.classification:
                    counts = by_leaf.setdefault(key, [{}])[0]
                    cat = model.encodings.value_for(tfi, int(target))
                    counts[cat] = counts.get(cat, 0) + 1
                else:
                    cur = by_leaf.setdefault(key, [0.0, 0])
                    cur[0] += float(target)
                    cur[1] += 1
        out = []
        for (tree_id, node_id), stats in by_leaf.items():
            if self.classification:
                out.append(join_json([tree_id, node_id, stats[0]]))
            else:
                total, count = stats
                out.append(join_json([tree_id, node_id, total / count, count]))
        return out

    def close(self) -> None:
        pass
