"""RDF serving: model, manager, and classification/regression endpoints.

Rebuild of RDFServingModel (app/oryx-app-serving/.../rdf/model/
RDFServingModel.java:34-90) + RDFServingModelManager (consume applies
speed-layer leaf updates via DecisionTree.findByID + TerminalNode.update)
and the endpoints: GET/POST /predict (classreg/Predict.java:51), POST
/train (classreg/Train.java), GET /classificationDistribution
(rdf/ClassificationDistribution.java:53), GET /feature/importance[/{i}]
(rdf/FeatureImportance.java:46-63).

Port note: a copy of ``oryx_tpu/app/rdf/serving.py`` with its imports
pointed at ``oryx_tpu_torch``, the HTML console at ``/`` and
``/index.html`` included. ``/train`` sends a body's lines in one ``send_many``
(``app/serving_common.send_inputs``), the records the JAX package sends
one by one.
"""

from __future__ import annotations

import logging
from typing import Iterator

import numpy as np

from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.app import pmml as app_pmml
from oryx_tpu_torch.app.rdf import forest_pmml, tree as T
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.app.serving_common import check_not_read_only, get_ready_model, send_inputs
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.lang import ReadWriteLock
from oryx_tpu_torch.common.text import parse_line, read_json
from oryx_tpu_torch.serving.web import OryxServingException, Request, Response, ServingContext, resource

log = logging.getLogger(__name__)


class RDFServingModel(ServingModel):
    def __init__(self, forest: T.DecisionForest, encodings, schema: InputSchema) -> None:
        self.forest = forest
        self.encodings = encodings
        self.schema = schema
        self.classification = schema.is_categorical(schema.target_feature)
        # traversal is read-mostly: concurrent /predict share the read side,
        # only leaf updates take the write side (reference RDFServingModel
        # guards the forest with an AutoReadWriteLock the same way)
        self._lock = ReadWriteLock()

    def get_fraction_loaded(self) -> float:
        return 1.0

    def _features_from(self, datum: str) -> np.ndarray:
        tokens = parse_line(datum)
        row = np.empty(self.schema.num_predictors)
        for i in range(self.schema.num_features):
            if not self.schema.is_active(i):
                continue
            p = self.schema.feature_to_predictor_index(i)
            if self.schema.is_target(i):
                row[p] = np.nan
                continue
            tok = tokens[i] if i < len(tokens) else ""
            if tok == "":
                # missing value: routed by the decision's default branch
                # (Predict supports missing fields via default_decision)
                row[p] = np.nan
                continue
            try:
                row[p] = (
                    float(self.encodings.index_for(i, tok))
                    if self.schema.is_categorical(i)
                    else float(tok)
                )
            except (KeyError, ValueError):
                raise OryxServingException(400, f"bad datum field {tok!r}")
        return row

    def predict(self, datum: str):
        with self._lock.read():
            return self.forest.predict(self._features_from(datum))

    def update_leaf(self, tree_id: int, node_id: str, payload) -> None:
        with self._lock.write():
            if tree_id >= len(self.forest.trees):
                return
            node = self.forest.trees[tree_id].find_by_id(node_id)
            if node is None or not node.is_terminal():
                return
            tfi = self.schema.target_feature_index
            if self.classification:
                for cat, count in payload.items():
                    try:
                        node.update(self.encodings.index_for(tfi, cat), int(count))
                    except KeyError:
                        pass  # unseen category: not representable in this model
            else:
                mean, count = payload
                node.update(float(mean), int(count))


class RDFServingModelManager(AbstractServingModelManager):
    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.schema = InputSchema(config)
        if not self.schema.has_target():
            raise ValueError("rdf requires a target feature")
        self.model: RDFServingModel | None = None

    def consume(self, update_iterator: Iterator[KeyMessage]) -> None:
        for km in update_iterator:
            key, message = km.key, km.message
            if key == "UP":
                if self.model is None:
                    continue
                update = read_json(message)
                tree_id, node_id = int(update[0]), str(update[1])
                payload = update[2] if self.model.classification else (update[2], update[3])
                self.model.update_leaf(tree_id, node_id, payload)
            elif key in ("MODEL", "MODEL-REF"):
                pmml = app_pmml.read_pmml_from_update_message(key, message)
                if pmml is None:
                    log.warning("dropped unreadable model update")
                    continue
                forest, encodings = forest_pmml.pmml_to_forest(pmml, self.schema)
                self.model = RDFServingModel(forest, encodings, self.schema)
            else:
                raise ValueError(f"bad key {key}")

    def get_model(self) -> RDFServingModel | None:
        return self.model


def _predict_value(model: RDFServingModel, datum: str):
    pred = model.predict(datum)
    if model.classification:
        tfi = model.schema.target_feature_index
        return model.encodings.value_for(tfi, pred.most_probable_index)
    return pred.prediction


@resource("GET", "/predict/{datum}")
def predict(ctx: ServingContext, req: Request):
    """classreg/Predict.java."""
    model = get_ready_model(ctx)
    return _predict_value(model, req.params["datum"])


@resource("POST", "/predict")
def predict_many(ctx: ServingContext, req: Request):
    model = get_ready_model(ctx)
    return [
        _predict_value(model, line.strip())
        for line in req.text().splitlines()
        if line.strip()
    ]


@resource("GET", "/classificationDistribution/{datum}")
def classification_distribution(ctx: ServingContext, req: Request):
    """rdf/ClassificationDistribution.java: category -> probability."""
    model = get_ready_model(ctx)
    if not model.classification:
        raise OryxServingException(400, "not a classification model")
    pred = model.predict(req.params["datum"])
    tfi = model.schema.target_feature_index
    probs = pred.probabilities
    return {
        model.encodings.value_for(tfi, i): float(p) for i, p in enumerate(probs)
    }


@resource("GET", "/feature/importance")
def feature_importance(ctx: ServingContext, req: Request):
    """rdf/FeatureImportance.java: all importances by feature name."""
    model = get_ready_model(ctx)
    fi = model.forest.feature_importances
    if fi is None:
        raise OryxServingException(404, "no importances in model")
    out = {}
    for i, name in enumerate(model.schema.feature_names):
        if model.schema.is_active(i) and not model.schema.is_target(i):
            out[name] = float(fi[model.schema.feature_to_predictor_index(i)])
    return out


@resource("GET", "/feature/importance/{index}")
def feature_importance_one(ctx: ServingContext, req: Request):
    model = get_ready_model(ctx)
    fi = model.forest.feature_importances
    if fi is None:
        raise OryxServingException(404, "no importances in model")
    try:
        return float(fi[int(req.params["index"])])
    except (ValueError, IndexError):
        raise OryxServingException(400, "bad predictor index")


@resource("POST", "/train")
def train(ctx: ServingContext, req: Request) -> Response:
    """Queue new labeled examples to the input topic (classreg/Train.java)."""
    check_not_read_only(ctx)
    lines = [line.strip() for line in req.text().splitlines() if line.strip()]
    if lines:
        send_inputs(ctx, lines)
    return Response(204)


# ---------------------------------------------------------------------------
# Console (rdf/Console.java:28)
# ---------------------------------------------------------------------------

from oryx_tpu_torch.serving.console import ConsoleForm, console_response, render_console  # noqa: E402

_CONSOLE_HTML = render_console(
    "Oryx random decision forest serving console",
    [
        ConsoleForm("Predict", "GET", "/predict/{datum}",
                    note="CSV example; blank target field"),
        ConsoleForm("Classification distribution", "GET",
                    "/classificationDistribution/{datum}"),
        ConsoleForm("Feature importance", "GET", "/feature/importance"),
        ConsoleForm("Train", "POST", "/train", body=True,
                    note="one labeled CSV example per line"),
        ConsoleForm("Ready?", "GET", "/ready"),
    ],
)


@resource("GET", "/")
@resource("GET", "/index.html")
def console(ctx: ServingContext, req: Request):
    return console_response(_CONSOLE_HTML)
