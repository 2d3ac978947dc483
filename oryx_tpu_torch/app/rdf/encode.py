"""Feature binning/encoding for forest training.

The app-side bridge between raw schema'd input and the binned matrices
oryx_tpu_torch.ops.forest trains on (the reference's analogous stage is
RDFUpdate.getDistinctValues + parseToLabeledPointRDD, RDFUpdate.java:
207-260):

- numeric features: quantile cut points (at most max-split-candidates,
  mirroring maxBins) with bin = index of first cut >= value; the split
  "bin <= b" becomes a NumericDecision threshold just above cut[b].
- categorical features: distinct values ordered by a target statistic
  (mean target for regression, P(first class) for classification — the
  classic ordered-split trick that makes subset splits threshold splits);
  the split "bin <= b" becomes a CategoricalDecision whose positive set
  is the categories ranked above b.

Port note: a copy of ``oryx_tpu/app/rdf/encode.py`` with its imports
pointed at ``oryx_tpu_torch``: bin edges bit for bit the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from oryx_tpu_torch.app.schema import CategoricalValueEncodings, InputSchema
from oryx_tpu_torch.common.text import parse_line


@dataclass
class FeatureBinning:
    """Per-predictor binning tables."""

    numeric_cuts: dict[int, np.ndarray]  # predictor idx -> sorted cut points
    category_rank: dict[int, np.ndarray]  # predictor idx -> rank per category id
    rank_to_category: dict[int, np.ndarray]  # predictor idx -> category id per rank
    num_bins: int


def parse_examples(
    data,
    schema: InputSchema,
    encodings: CategoricalValueEncodings,
    skip_unknown: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """(features [n, P] float64, targets [n]) with categorical features and
    categorical targets as encoded ids. With skip_unknown, malformed records
    — a categorical value absent from `encodings` (e.g. a test-split value
    never seen in training), a non-numeric token, or a short line — are
    dropped instead of raising (the speed layer feeds this raw client input
    from POST /train, so bad lines must not abort a micro-batch)."""
    rows, targets = [], []
    tfi = schema.target_feature_index
    for rec in data:
        row = np.empty(schema.num_predictors)
        target = None
        try:
            tokens = parse_line(rec.message if hasattr(rec, "message") else rec)
            for i in range(schema.num_features):
                if not schema.is_active(i):
                    continue
                tok = tokens[i]
                v = (
                    float(encodings.index_for(i, tok))
                    if schema.is_categorical(i)
                    else float(tok)
                )
                if i == tfi:
                    target = v
                row[schema.feature_to_predictor_index(i)] = v
        except (KeyError, ValueError, IndexError):
            if skip_unknown:
                continue
            raise
        rows.append(row)
        targets.append(target)
    if not rows:
        return np.zeros((0, schema.num_predictors)), np.zeros(0)
    return np.stack(rows), np.asarray(targets)


def build_encodings(data, schema: InputSchema) -> CategoricalValueEncodings:
    """Distinct categorical values, in stable sorted order
    (RDFUpdate.getDistinctValues:207-225)."""
    cat_idx = {
        i
        for i in range(schema.num_features)
        if schema.is_active(i) and schema.is_categorical(i)
    }
    values: dict[int, set] = {i: set() for i in cat_idx}
    for rec in data:
        tokens = parse_line(rec.message if hasattr(rec, "message") else rec)
        for i in values:
            values[i].add(tokens[i])
    return CategoricalValueEncodings({i: sorted(v) for i, v in values.items()})


def build_binning(
    features: np.ndarray,
    targets: np.ndarray,
    schema: InputSchema,
    max_split_candidates: int,
    classification: bool,
) -> FeatureBinning:
    p = features.shape[1]
    numeric_cuts: dict[int, np.ndarray] = {}
    category_rank: dict[int, np.ndarray] = {}
    rank_to_category: dict[int, np.ndarray] = {}
    max_b = 2
    cat_predictors = {
        schema.feature_to_predictor_index(i)
        for i in range(schema.num_features)
        if schema.is_active(i) and schema.is_categorical(i) and not schema.is_target(i)
    }
    tfi = schema.target_feature_index
    target_pred = schema.feature_to_predictor_index(tfi) if tfi is not None else None
    for j in range(p):
        if j == target_pred:
            continue
        col = features[:, j]
        if j in cat_predictors:
            cats = np.unique(col).astype(int)
            # order categories by target statistic
            stat = np.asarray(
                [
                    (targets[col == c] == 0).mean() if classification else targets[col == c].mean()
                    for c in cats
                ]
            )
            order = cats[np.argsort(stat, kind="stable")]
            rank = np.zeros(int(cats.max()) + 1, dtype=np.int32)
            rank[order] = np.arange(len(order))
            category_rank[j] = rank
            rank_to_category[j] = order.astype(np.int32)
            max_b = max(max_b, len(order))
        else:
            uniq = np.unique(col)
            if len(uniq) <= 1:
                cuts = uniq[:1] if len(uniq) else np.asarray([0.0])
            elif len(uniq) <= max_split_candidates:
                cuts = (uniq[:-1] + uniq[1:]) / 2.0
            else:
                qs = np.quantile(col, np.linspace(0, 1, max_split_candidates + 1)[1:-1])
                cuts = np.unique(qs)
            numeric_cuts[j] = cuts
            max_b = max(max_b, len(cuts) + 1)
    return FeatureBinning(numeric_cuts, category_rank, rank_to_category, max_b)


def bin_features(features: np.ndarray, binning: FeatureBinning) -> np.ndarray:
    n, p = features.shape
    out = np.zeros((n, p), dtype=np.int32)
    for j in range(p):
        if j in binning.numeric_cuts:
            out[:, j] = np.searchsorted(binning.numeric_cuts[j], features[:, j], side="left")
        elif j in binning.category_rank:
            rank = binning.category_rank[j]
            ids = np.clip(features[:, j].astype(np.int64), 0, len(rank) - 1)
            out[:, j] = rank[ids]
    return out
