"""Portable decision-forest representation, evaluated without the trainer.

Rebuild of the app/oryx-app-common rdf family (SURVEY.md §2.7):
Decision (rdf/decision/{NumericDecision,CategoricalDecision}.java),
TreeNode/DecisionNode/TerminalNode, DecisionTree (findTerminal:53,
findByID:66 — node IDs are PMML-compatible strings), DecisionForest
(weighted vote + feature importances, rdf/tree/DecisionForest.java:30-85)
and the prediction types (classreg/predict/{NumericPrediction,
CategoricalPrediction,WeightedPrediction}.java). The speed layer updates
leaf statistics in place via find_by_id + TerminalNode.update.

Node ID scheme: root "r", then "-" appended for the negative (left)
branch and "+" for the positive branch, matching the reference's
PMML-compatible string IDs.

Port note: a copy of ``oryx_tpu/app/rdf/tree.py`` (numpy only).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Predictions
# ---------------------------------------------------------------------------


class NumericPrediction:
    """Mean target with observation count (NumericPrediction.java)."""

    def __init__(self, prediction: float, count: int) -> None:
        self.prediction = float(prediction)
        self.count = int(count)

    def update(self, value: float, count: int = 1) -> None:
        total = self.count + count
        self.prediction = (self.prediction * self.count + value * count) / total
        self.count = total

    def __repr__(self) -> str:  # pragma: no cover
        return f"NumericPrediction({self.prediction:.4f}, n={self.count})"


class CategoricalPrediction:
    """Per-category counts; predicted category = argmax
    (CategoricalPrediction.java)."""

    def __init__(self, counts: Sequence[float]) -> None:
        self.counts = np.asarray(counts, dtype=np.float64)

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    @property
    def most_probable_index(self) -> int:
        return int(np.argmax(self.counts))

    @property
    def probabilities(self) -> np.ndarray:
        total = self.counts.sum()
        if total <= 0:
            return np.full(len(self.counts), 1.0 / len(self.counts))
        return self.counts / total

    def update(self, category: int, count: int = 1) -> None:
        self.counts[category] += count

    def __repr__(self) -> str:  # pragma: no cover
        return f"CategoricalPrediction({self.counts.tolist()})"


def weighted_vote(predictions: list, weights: list[float]):
    """Merge per-tree predictions into a forest prediction
    (WeightedPrediction.java)."""
    if not predictions:
        raise ValueError("no predictions")
    if isinstance(predictions[0], CategoricalPrediction):
        probs = sum(w * p.probabilities for p, w in zip(predictions, weights))
        return CategoricalPrediction(probs / sum(weights) * 1000.0)
    total_w = sum(weights)
    mean = sum(w * p.prediction for p, w in zip(predictions, weights)) / total_w
    return NumericPrediction(mean, sum(p.count for p in predictions))


# ---------------------------------------------------------------------------
# Decisions and nodes
# ---------------------------------------------------------------------------


@dataclass
class NumericDecision:
    """feature <= threshold is positive? No: mirror reference semantics —
    positive when value >= threshold (NumericDecision.java uses >=
    threshold as positive); missing defaults to `default_decision`."""

    feature: int
    threshold: float
    default_decision: bool = False

    def is_positive(self, features: Sequence) -> bool:
        v = features[self.feature]
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return self.default_decision
        return float(v) >= self.threshold


@dataclass
class CategoricalDecision:
    """Positive when the category id is in `category_ids`
    (CategoricalDecision.java)."""

    feature: int
    category_ids: frozenset[int]
    default_decision: bool = False

    def is_positive(self, features: Sequence) -> bool:
        v = features[self.feature]
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return self.default_decision
        return int(v) in self.category_ids


@dataclass
class TerminalNode:
    id: str
    prediction: NumericPrediction | CategoricalPrediction
    record_count: int = 0

    def is_terminal(self) -> bool:
        return True

    def update(self, value_or_category, count: int = 1) -> None:
        """Fold new observations into leaf stats (TerminalNode.update —
        the speed layer's leaf refresh)."""
        if isinstance(self.prediction, CategoricalPrediction):
            self.prediction.update(int(value_or_category), count)
        else:
            self.prediction.update(float(value_or_category), count)
        self.record_count += count


@dataclass
class DecisionNode:
    id: str
    decision: NumericDecision | CategoricalDecision
    negative: "DecisionNode | TerminalNode"
    positive: "DecisionNode | TerminalNode"
    record_count: int = 0

    def is_terminal(self) -> bool:
        return False


class DecisionTree:
    """One tree (DecisionTree.java:38-95)."""

    def __init__(self, root: DecisionNode | TerminalNode) -> None:
        self.root = root

    def find_terminal(self, features: Sequence) -> TerminalNode:
        node = self.root
        while not node.is_terminal():
            node = node.positive if node.decision.is_positive(features) else node.negative
        return node

    def find_terminals_batch(self, features) -> list[TerminalNode]:
        """Terminal node for every row of a [n, P] float array (NaN =
        missing) — each tree node is visited once per batch with its
        predicate evaluated vectorized over the rows that reached it,
        instead of a Python walk per example (the speed layer's leaf
        refresh runs whole micro-batches through this)."""
        features = np.asarray(features, dtype=np.float64)
        n = len(features)
        out: list[TerminalNode | None] = [None] * n
        stack: list = [(self.root, np.arange(n))]
        while stack:
            node, rows = stack.pop()
            if not len(rows):
                continue
            if node.is_terminal():
                for r in rows.tolist():
                    out[r] = node
                continue
            d = node.decision
            col = features[rows, d.feature]
            missing = np.isnan(col)
            if isinstance(d, NumericDecision):
                with np.errstate(invalid="ignore"):
                    pos = col >= d.threshold
            else:
                ids = np.where(missing, -1, col).astype(np.int64)
                pos = np.isin(ids, np.fromiter(d.category_ids, dtype=np.int64))
            pos = np.where(missing, d.default_decision, pos)
            stack.append((node.positive, rows[pos]))
            stack.append((node.negative, rows[~pos]))
        return out

    def find_by_id(self, node_id: str) -> DecisionNode | TerminalNode | None:
        """Walk by ID structure: '-'/'+' suffixes encode the path."""
        node = self.root
        if node_id == node.id:
            return node
        path = node_id[len(node.id) :]
        for step in path:
            if node.is_terminal():
                return None
            node = node.negative if step == "-" else node.positive
        return node if node.id == node_id else None

    def predict(self, features: Sequence):
        return self.find_terminal(features).prediction

    def nodes(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            yield n
            if not n.is_terminal():
                stack.append(n.negative)
                stack.append(n.positive)


class DecisionForest:
    """Weighted forest (DecisionForest.java:30-85)."""

    def __init__(
        self,
        trees: list[DecisionTree],
        weights: list[float] | None = None,
        feature_importances: np.ndarray | None = None,
    ) -> None:
        self.trees = trees
        self.weights = weights if weights is not None else [1.0] * len(trees)
        self.feature_importances = feature_importances

    def predict(self, features: Sequence):
        return weighted_vote([t.predict(features) for t in self.trees], self.weights)
