"""Forest <-> PMML MiningModel conversion.

Rebuild of RDFPMMLUtils (app/oryx-app-common/.../rdf/RDFPMMLUtils.java)
and the PMML-emitting half of RDFUpdate.rdfModelToPMML: a MiningModel
with a Segmentation of one TreeModel per tree; Nodes carry id (the
"r"/"-"/"+" path scheme of oryx_tpu_torch.app.rdf.tree), recordCount, score,
and ScoreDistribution for classification; predicates are SimplePredicate
(numeric) or SimpleSetPredicate (categorical).

Port note: a copy of ``oryx_tpu/app/rdf/forest_pmml.py`` with its
imports pointed at ``oryx_tpu_torch``. Below the Header (application
name, version, timestamp) its documents are the JAX package's byte for
byte, and each package reads the other's.
"""

from __future__ import annotations

import numpy as np
from xml.etree.ElementTree import Element

from oryx_tpu_torch.app import pmml as app_pmml
from oryx_tpu_torch.app.rdf import tree as T
from oryx_tpu_torch.app.schema import CategoricalValueEncodings, InputSchema
from oryx_tpu_torch.common import pmml as pmml_io


def forest_to_pmml(
    forest: T.DecisionForest,
    schema: InputSchema,
    encodings: CategoricalValueEncodings,
) -> Element:
    """Document layout matches RDFUpdate.rdfModelToPMML:369-423 +
    toTreeModel:424-516 element-for-element: DataDictionary then a
    MiningModel (multi-tree) or bare TreeModel (single tree), Segments
    carrying an un-schema'd TreeModel with splitCharacteristic=
    binarySplit and missingValueStrategy=defaultChild, root Extensions
    last. Feature importances ride MiningField importance attributes (the
    reference's channel) plus the round-trip `importances` extension."""
    root = pmml_io.build_skeleton_pmml()
    app_pmml.build_data_dictionary(root, schema, encodings)
    classification = schema.target_feature is not None and schema.is_categorical(
        schema.target_feature
    )
    function = "classification" if classification else "regression"
    importances = (
        list(forest.feature_importances) if forest.feature_importances is not None else None
    )
    tree_attrs = {
        "splitCharacteristic": "binarySplit",
        "missingValueStrategy": "defaultChild",
    }
    if len(forest.trees) == 1:
        tm = pmml_io.sub(root, "TreeModel", {"functionName": function, **tree_attrs})
        app_pmml.build_mining_schema(tm, schema, importances)
        _write_node(tm, forest.trees[0].root, None, schema, encodings, classification)
    else:
        mm = pmml_io.sub(root, "MiningModel", {"functionName": function})
        app_pmml.build_mining_schema(mm, schema, importances)
        seg = pmml_io.sub(
            mm,
            "Segmentation",
            {
                "multipleModelMethod": "weightedMajorityVote"
                if classification
                else "weightedAverage"
            },
        )
        for i, (tree, weight) in enumerate(zip(forest.trees, forest.weights)):
            s = pmml_io.sub(seg, "Segment", {"id": str(i), "weight": repr(float(weight))})
            pmml_io.sub(s, "True")
            # segment TreeModels carry no MiningSchema or functionName of
            # their own, exactly like the reference's inner toTreeModel
            tm = pmml_io.sub(s, "TreeModel", dict(tree_attrs))
            _write_node(tm, tree.root, None, schema, encodings, classification)
    if forest.feature_importances is not None:
        app_pmml.add_extension_content(
            root, "importances", [repr(float(v)) for v in forest.feature_importances]
        )
    return root


def _node_count(node) -> float:
    return float(node.prediction.count if node.is_terminal() else node.record_count)


def _write_node(parent, node, predicate_writer, schema, encodings, classification) -> None:
    attrs = {"id": node.id, "recordCount": repr(_node_count(node))}
    if node.is_terminal() and not classification:
        # classification leaves carry only ScoreDistributions, exactly
        # like toTreeModel:458-487 (no score attribute)
        attrs["score"] = repr(float(node.prediction.prediction))
    if not node.is_terminal():
        # defaultChild = the heavier branch, the reference's missing-value
        # routing (toTreeModel:494-499)
        heavier_positive = _node_count(node.positive) > _node_count(node.negative)
        attrs["defaultChild"] = node.positive.id if heavier_positive else node.negative.id
    el = pmml_io.sub(parent, "Node", attrs)
    if predicate_writer is None:
        pmml_io.sub(el, "True")
    else:
        predicate_writer(el)
    if node.is_terminal():
        if classification:
            tfi = schema.target_feature_index
            total = max(1.0, float(node.prediction.counts.sum()))
            for ci, cnt in enumerate(node.prediction.counts):
                if cnt <= 0:
                    continue  # zero-probability rows omitted (toTreeModel:478)
                sd = pmml_io.sub(
                    el,
                    "ScoreDistribution",
                    {"value": encodings.value_for(tfi, ci), "recordCount": repr(float(cnt))},
                )
                sd.set("confidence", repr(float(cnt) / total))
        return
    d = node.decision
    feature_index = schema.predictor_to_feature_index(d.feature)
    name = schema.feature_names[feature_index]
    if isinstance(d, T.NumericDecision):
        def neg(el2, name=name, d=d):
            pmml_io.sub(el2, "SimplePredicate", {"field": name, "operator": "lessThan", "value": repr(d.threshold)})

        def pos(el2, name=name, d=d):
            pmml_io.sub(el2, "SimplePredicate", {"field": name, "operator": "greaterOrEqual", "value": repr(d.threshold)})
    else:
        pos_values = [encodings.value_for(feature_index, c) for c in sorted(d.category_ids)]

        def neg(el2, name=name, vals=pos_values):
            sp = pmml_io.sub(el2, "SimpleSetPredicate", {"field": name, "booleanOperator": "isNotIn"})
            arr = pmml_io.sub(sp, "Array", {"n": str(len(vals)), "type": "string"})
            arr.text = " ".join(_quote(v) for v in vals)

        def pos(el2, name=name, vals=pos_values):
            sp = pmml_io.sub(el2, "SimpleSetPredicate", {"field": name, "booleanOperator": "isIn"})
            arr = pmml_io.sub(sp, "Array", {"n": str(len(vals)), "type": "string"})
            arr.text = " ".join(_quote(v) for v in vals)

    # the positive (predicate-carrying) child comes FIRST: PMML evaluates
    # predicates in document order, and the negative child's True would
    # otherwise always match (RDFUpdate.toTreeModel:500-505 — "Right node
    # is 'positive', so carries the predicate. It must evaluate first")
    _write_node(el, node.positive, pos, schema, encodings, classification)
    _write_node(el, node.negative, neg, schema, encodings, classification)


def _quote(v: str) -> str:
    return f'"{v}"' if (" " in v or not v) else v


def _unquote_array(text: str) -> list[str]:
    import re

    # group(1) may legitimately be '' (a quoted empty-string category), so
    # test against None rather than truthiness
    return [
        m.group(1) if m.group(1) is not None else m.group(2)
        for m in re.finditer(r'"([^"]*)"|(\S+)', text or "")
    ]


def pmml_to_forest(
    root: Element, schema: InputSchema
) -> tuple[T.DecisionForest, CategoricalValueEncodings]:
    """Inverse of forest_to_pmml (RDFPMMLUtils.read)."""
    encodings = app_pmml.build_categorical_encodings(root, schema)
    mm = pmml_io.find(root, "MiningModel")
    classification = schema.target_feature is not None and schema.is_categorical(
        schema.target_feature
    )
    tfi = schema.target_feature_index
    num_classes = encodings.category_count(tfi) if classification else 0
    trees, weights = [], []
    importances = app_pmml.get_extension_content(root, "importances")
    if mm is None:
        # single-tree documents carry a bare TreeModel (RDFUpdate:383-384)
        tm = pmml_io.find(root, "TreeModel")
        if tm is None:
            raise ValueError("no MiningModel or TreeModel in PMML")
        node_el = pmml_io.find(tm, "Node")
        trees.append(
            T.DecisionTree(_read_node(node_el, schema, encodings, classification, num_classes))
        )
        weights.append(1.0)
    else:
        seg = pmml_io.find(mm, "Segmentation")
        for s in pmml_io.findall(seg, "Segment"):
            weights.append(float(s.get("weight", "1")))
            tm = pmml_io.find(s, "TreeModel")
            node_el = pmml_io.find(tm, "Node")
            trees.append(T.DecisionTree(_read_node(node_el, schema, encodings, classification, num_classes)))
    fi = np.asarray([float(v) for v in importances]) if importances else None
    return T.DecisionForest(trees, weights, fi), encodings


def _read_node(el, schema, encodings, classification, num_classes):
    children = pmml_io.findall(el, "Node")
    node_id = el.get("id")
    if not children:
        rc = float(el.get("recordCount", "0"))
        if classification:
            counts = np.zeros(num_classes)
            for sd in pmml_io.findall(el, "ScoreDistribution"):
                tfi = schema.target_feature_index
                counts[encodings.index_for(tfi, sd.get("value"))] = float(sd.get("recordCount"))
            return T.TerminalNode(node_id, T.CategoricalPrediction(counts), int(rc))
        return T.TerminalNode(
            node_id, T.NumericPrediction(float(el.get("score", "0")), int(rc)), int(rc)
        )
    assert len(children) == 2, "binary trees expected"
    # identify the positive child by its predicate OPERATOR (greaterThan/
    # greaterOrEqual/isIn positive; lessThan/lessOrEqual/isNotIn/True
    # negative), like RDFPMMLUtils.translateFromPMML:206-224 — element
    # order alone inverts branches on persisted documents whose writer
    # put the negative predicate first (only a True-vs-predicate check
    # can't tell, since both children may carry real predicates).
    p0, p1 = _child_polarity(children[0]), _child_polarity(children[1])
    if p1 > p0:
        pos_el, neg_el = children[1], children[0]
    else:
        # includes the indeterminate tie: the reference writes the
        # positive (predicate-evaluated-first) child in document order
        pos_el, neg_el = children[0], children[1]
    decision = _read_predicate(pos_el, schema, encodings)
    negative = _read_node(neg_el, schema, encodings, classification, num_classes)
    positive = _read_node(pos_el, schema, encodings, classification, num_classes)
    return T.DecisionNode(
        node_id, decision, negative, positive, int(float(el.get("recordCount", "0")))
    )


def _child_polarity(el) -> int:
    """+1 if this child's predicate marks it the positive branch, -1 the
    negative, 0 indeterminate. greaterThan/greaterOrEqual and isIn are
    positive by the writer's convention; lessThan/lessOrEqual, isNotIn
    and a bare True (producers that predicate only one child) negative."""
    sp = pmml_io.find(el, "SimplePredicate")
    if sp is not None:
        op = sp.get("operator")
        if op in ("greaterThan", "greaterOrEqual"):
            return 1
        if op in ("lessThan", "lessOrEqual"):
            return -1
        return 0
    ssp = pmml_io.find(el, "SimpleSetPredicate")
    if ssp is not None:
        op = ssp.get("booleanOperator")
        if op == "isIn":
            return 1
        if op == "isNotIn":
            return -1
        return 0
    if pmml_io.find(el, "True") is not None:
        return -1
    return 0


def _read_predicate(el, schema, encodings):
    sp = pmml_io.find(el, "SimplePredicate")
    if sp is not None:
        feature_index = schema.feature_names.index(sp.get("field"))
        return T.NumericDecision(
            schema.feature_to_predictor_index(feature_index), float(sp.get("value"))
        )
    ssp = pmml_io.find(el, "SimpleSetPredicate")
    if ssp is None:
        raise ValueError("node missing predicate")
    feature_index = schema.feature_names.index(ssp.get("field"))
    arr = pmml_io.find(ssp, "Array")
    values = _unquote_array(arr.text)
    ids = frozenset(encodings.index_for(feature_index, v) for v in values)
    return T.CategoricalDecision(schema.feature_to_predictor_index(feature_index), ids)
