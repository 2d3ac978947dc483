"""ALS batch trainer: the MLUpdate implementation.

Rebuild of ALSUpdate (app/oryx-app-mllib/.../als/ALSUpdate.java:65-506)
with the MLlib hot loop replaced by the batched solves of ops/als.py:

- build_model: parse -> decay -> aggregate -> indexed COO -> train_als on
  the card; factors exported as gzip JSON-lines shards under X/
  and Y/ in the candidate dir (mfModelToPMML/saveFeaturesRDD:359-426
  artifact shape), PMML skeleton carries features/lambda/alpha/implicit
  and the expected-ID lists (XIDs/YIDs extensions) consumers use for
  load-fraction accounting and rotation.
- evaluate: implicit -> mean per-user AUC; explicit -> negated RMSE
  (ALSUpdate.evaluate:156-177).
- publish_additional_model_data: streams every Y row then every X row
  (with known items) to the update topic as "UP" messages
  (ALSUpdate.java:194-230; Y first, matching the comment at
  ALSSpeedModelManager.java:78-85).
- time-ordered train/test split (splitNewDataToTrainTest:237-254).

Port note: a copy of ``oryx_tpu/app/als/update.py`` with its imports
pointed at ``oryx_tpu_torch``. Training runs on the one default card
(``ops/als.train_als``); a config that sets ``oryx.batch.compute.mesh``
raises NotYetPortedError (``shard-factors`` only ever applied with a
mesh). The JAX package's log line of its XLA compiled-run cache has no
counterpart. Factor files and UP messages carry ``json.dumps`` vectors
(``native/store.py``), which read back to the same float32 values as the
JAX package's native text.
"""

from __future__ import annotations

import gzip
import json
import logging
from pathlib import Path
from typing import Iterable, Sequence
from xml.etree.ElementTree import Element

import numpy as np

from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch.app import pmml as app_pmml
from oryx_tpu_torch.app.als import data as als_data
from oryx_tpu_torch.bus.core import KeyMessage, TopicProducer
from oryx_tpu_torch.common import pmml as pmml_io, rng
from oryx_tpu_torch.common import storage
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.records import ChainRecords, Records, as_records
from oryx_tpu_torch.common.text import json_str, parse_line
from oryx_tpu_torch.ml import param as hp
from oryx_tpu_torch.ml.update import MLUpdate
from oryx_tpu_torch.native.store import format_vectors_json
from oryx_tpu_torch.ops import als as als_ops

log = logging.getLogger(__name__)

class ALSUpdate(MLUpdate):
    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.iterations = config.get_int("oryx.als.iterations")
        self.implicit = config.get_bool("oryx.als.implicit")
        self.no_known_items = config.get_bool("oryx.als.no-known-items")
        self.decay_factor = config.get_float("oryx.als.decay.factor")
        self.decay_zero_threshold = config.get_float("oryx.als.decay.zero-threshold")
        if not 0.0 < self.decay_factor <= 1.0:
            raise ValueError("decay factor must be in (0,1]")
        # Host-side neighbor packing knobs (oryx.ml.als.packing.*): worker
        # count "auto"|N, streamed-chunk size, and the shared-memory arena
        # budget for the multi-process path (ops/packing.py). Validated at
        # startup so a typo'd worker count fails the layer, not generation 40.
        workers = config.get("oryx.ml.als.packing.workers", "auto")
        if workers != "auto":
            workers = int(workers)
        self.packing = als_ops.PackingOptions(
            workers=workers,
            chunk_rows=config.get_int("oryx.ml.als.packing.chunk-rows"),
            shm_budget_mb=config.get_int("oryx.ml.als.packing.shared-mem-budget-mb"),
        )
        if config.get("oryx.batch.compute.mesh", None) is not None:
            raise NotYetPortedError(
                "oryx.batch.compute.mesh is set, but ALS over a device mesh is "
                "not yet ported to oryx_tpu_torch"
            )
        self._config = config

    def get_hyper_parameter_values(self) -> list[hp.HyperParamValues]:
        c = self._config
        return [
            hp.from_config(c, "oryx.als.hyperparams.features"),
            hp.from_config(c, "oryx.als.hyperparams.lambda"),
            hp.from_config(c, "oryx.als.hyperparams.alpha"),
        ]

    # -- training ------------------------------------------------------------

    def _prepare(self, data: Iterable[KeyMessage]) -> als_data.RatingMatrix:
        """Columnar parse -> decay -> aggregate -> indexed COO, one
        micro-batch block at a time (common.records streams stored
        blocks, so nothing materializes a giant per-line Python list)."""
        parts: list[als_data.InteractionColumns] = []
        if isinstance(data, Records):
            for block in data.blocks():
                parts.append(als_data.parse_interaction_block(block.messages))
        else:
            msgs = [
                (rec if isinstance(rec, str) else rec.message).encode("utf-8")
                for rec in data
            ]
            if msgs:
                parts.append(als_data.parse_interaction_block(msgs))
        cols = als_data.concat_columns(parts)
        cols = als_data.decay_columns(cols, self.decay_factor, self.decay_zero_threshold)
        return als_data.rating_matrix_from_columns(cols, self.implicit)

    def build_model(
        self,
        train_data: list[KeyMessage],
        hyper_parameters: Sequence,
        candidate_path: Path,
    ) -> Element:
        features, lam, alpha = (
            int(hyper_parameters[0]),
            float(hyper_parameters[1]),
            float(hyper_parameters[2]),
        )
        if features <= 0 or lam < 0 or alpha <= 0:
            raise ValueError(f"bad hyperparams {hyper_parameters}")
        rm = self._prepare(train_data)
        if not rm.user_ids or not rm.item_ids:
            raise ValueError("no (user, item) interactions to train on")
        model = als_ops.train_als(
            rm.user_idx,
            rm.item_idx,
            rm.values,
            len(rm.user_ids),
            len(rm.item_ids),
            features=features,
            lam=lam,
            alpha=alpha,
            implicit=self.implicit,
            iterations=self.iterations,
            matmul_dtype=self._config.get("oryx.batch.compute.matmul-dtype", None),
            init_y=self._warm_start_init_y(rm, features),
            packing=self.packing,
        )
        _save_features(candidate_path / "X", rm.user_ids, model.x)
        _save_features(candidate_path / "Y", rm.item_ids, model.y)
        return self._model_to_pmml(features, lam, alpha, rm)

    def _warm_start_init_y(
        self, rm: als_data.RatingMatrix, features: int
    ) -> np.ndarray | None:
        """Item-factor init from the champion generation's Y/ artifacts
        (MLUpdate.load_previous_model). Rows whose item survives into this
        generation start at the previous factor; new items get the usual
        small random init. Returns None (cold start) when there is no
        previous model, the feature count changed, or no item overlaps —
        warm-start is an optimization, never a correctness dependency."""
        if self.previous_model_dir is None:
            return None
        try:
            ids_y, y_prev = _load_features(storage.join(self.previous_model_dir, "Y"))
        except Exception:
            log.warning("unreadable previous Y factors; cold-starting", exc_info=True)
            return None
        if y_prev.size == 0 or y_prev.shape[1] != features:
            return None
        num_items = len(rm.item_ids)
        rows, found = _map_to_rows(
            rm.item_ids, np.arange(num_items, dtype=np.int32), ids_y
        )
        if not found.any():
            return None
        init = 0.1 * rng.get_random().standard_normal(
            (num_items, features)
        ).astype(np.float32)
        init[found] = y_prev[rows[found]]
        log.info(
            "warm-start from generation %s: %d/%d item factors carried over",
            self.previous_generation_id, int(found.sum()), num_items,
        )
        return init

    def _model_to_pmml(
        self, features: int, lam: float, alpha: float, rm: als_data.RatingMatrix
    ) -> Element:
        root = pmml_io.build_skeleton_pmml()
        app_pmml.add_extension(root, "X", "X/")
        app_pmml.add_extension(root, "Y", "Y/")
        app_pmml.add_extension(root, "features", features)
        app_pmml.add_extension(root, "lambda", lam)
        app_pmml.add_extension(root, "implicit", "true" if self.implicit else "false")
        if self.implicit:
            app_pmml.add_extension(root, "alpha", alpha)
        app_pmml.add_extension_content(root, "XIDs", rm.user_ids)
        app_pmml.add_extension_content(root, "YIDs", rm.item_ids)
        return root

    # -- evaluation ----------------------------------------------------------

    def evaluate(
        self,
        model: Element,
        model_parent_path: Path,
        test_data: list[KeyMessage],
        train_data: list[KeyMessage],
    ) -> float:
        ids_x, x = _load_features(storage.join(model_parent_path, "X"))
        ids_y, y = _load_features(storage.join(model_parent_path, "Y"))
        rm_test = self._prepare(test_data)
        # vectorized id -> model-row mapping (a per-pair Python dict walk
        # took minutes at 10M test pairs)
        uu, u_ok = _map_to_rows(rm_test.user_ids, rm_test.user_idx, ids_x)
        ii, i_ok = _map_to_rows(rm_test.item_ids, rm_test.item_idx, ids_y)
        keep = u_ok & i_ok
        if not keep.any():
            return float("nan")
        uu, ii = uu[keep], ii[keep]
        vv = rm_test.values[keep]
        if self.implicit:
            return als_ops.mean_auc(x, y, uu, ii, rng.get_random())
        return -als_ops.rmse(x, y, uu, ii, vv)

    # -- publish -------------------------------------------------------------

    def publish_additional_model_data(
        self,
        pmml: Element,
        new_data: list[KeyMessage],
        past_data: list[KeyMessage],
        model_parent_path: Path,
        model_update_topic: TopicProducer | None,
    ) -> None:
        if model_update_topic is None:
            return
        ids_y, y = _load_features(storage.join(model_parent_path, "Y"))
        # Y first: item vectors must exist before user fold-ins make sense
        _publish_factor_rows(model_update_topic, "Y", ids_y, y, None)
        ids_x, x = _load_features(storage.join(model_parent_path, "X"))
        known: dict[str, set[str]] | None = None
        if not self.no_known_items:
            rm = self._prepare(
                ChainRecords([as_records(new_data), as_records(past_data)])
            )
            known = rm.known_items
        _publish_factor_rows(model_update_topic, "X", ids_x, x, known)

    # -- split ---------------------------------------------------------------

    def split_new_data_to_train_test(
        self, new_data: list[KeyMessage]
    ) -> tuple[list[KeyMessage], list[KeyMessage]]:
        """Time-ordered split: the newest test-fraction is the test set
        (ALSUpdate.splitNewDataToTrainTest:237-254)."""
        if self.test_fraction <= 0.0:
            return list(new_data), []
        if self.test_fraction >= 1.0:
            return [], list(new_data)
        def ts_of(rec: KeyMessage) -> int:
            tokens = parse_line(rec.message)
            return int(float(tokens[3])) if len(tokens) > 3 and tokens[3] != "" else 0

        ordered = sorted(new_data, key=ts_of)
        split = int(round(len(ordered) * (1.0 - self.test_fraction)))
        return ordered[:split], ordered[split:]


def _map_to_rows(
    ids: list[str], idx: np.ndarray, model_ids: list[str]
) -> tuple[np.ndarray, np.ndarray]:
    """Map per-interaction vocabulary indices to model-matrix rows:
    (rows int32, valid bool) with rows undefined where invalid (id not in
    the model). One sort + one searchsorted instead of a dict per pair."""
    if not ids or not len(model_ids):
        return np.zeros(len(idx), np.int32), np.zeros(len(idx), bool)
    vocab = np.array(ids, dtype="U")
    model = np.array(model_ids, dtype="U")
    order = np.argsort(model)
    pos = np.searchsorted(model[order], vocab)
    pos_clipped = np.minimum(pos, len(model) - 1)
    found = model[order][pos_clipped] == vocab  # [len(ids)]
    row_of_vocab = order[pos_clipped].astype(np.int32)  # valid only where found
    return row_of_vocab[idx], found[idx]


# -- publish helpers ---------------------------------------------------------

_PUBLISH_CHUNK = 8192


def _publish_factor_rows(
    producer: TopicProducer,
    tag: str,
    ids: list[str],
    matrix: np.ndarray,
    known: dict[str, set[str]] | None,
) -> None:
    """Chunked batch publish of ["X"|"Y", id, vector(, knownItems)] "UP"
    messages: vectors are JSON-formatted in bulk and each chunk ships via
    one `send_many` — one broker lock and
    one buffered write per chunk instead of one per row
    (cf. TopicProducerImpl.java:194-202 batching)."""
    for start in range(0, len(ids), _PUBLISH_CHUNK):
        chunk_ids = ids[start : start + _PUBLISH_CHUNK]
        vecs = format_vectors_json(matrix[start : start + _PUBLISH_CHUNK])
        if known is None:
            records = [
                ("UP", f'["{tag}",{json_str(i)},{v}]')
                for i, v in zip(chunk_ids, vecs)
            ]
        else:
            records = [
                (
                    "UP",
                    f'["{tag}",{json_str(i)},{v},'
                    f"{json.dumps(sorted(known.get(i, ())))}]",
                )
                for i, v in zip(chunk_ids, vecs)
            ]
        producer.send_many(records)


# -- factor-matrix artifacts -------------------------------------------------

_SHARD_ROWS = 500_000


def _save_features(dir_path: Path, ids: list[str], matrix: np.ndarray) -> None:
    """Gzip JSON-lines shards of [id, [floats]] (saveFeaturesRDD:415-426).

    Sharded by row count (part-0000N) like the reference's partitioned
    saveAsTextFile output, so a 40M-row factor matrix is many bounded
    files rather than one serial multi-GB gzip stream."""
    dir_path.mkdir(parents=True, exist_ok=True)
    n = len(ids)
    shard = 0
    for start in range(0, max(n, 1), _SHARD_ROWS):
        chunk_ids = ids[start : start + _SHARD_ROWS]
        with gzip.open(dir_path / f"part-{shard:05d}.json.gz", "wt", encoding="utf-8") as f:
            for id_, vec in zip(chunk_ids, format_vectors_json(matrix[start : start + _SHARD_ROWS])):
                f.write(f"[{json.dumps(id_)},{vec}]\n")
        shard += 1


def _load_features(dir_uri) -> tuple[list[str], np.ndarray]:
    """URI-aware: candidate dirs are local, promoted models may live on
    an object store (gs://...) — both read through common.storage."""
    ids: list[str] = []
    rows: list[list[float]] = []
    names = [
        n for n in storage.list_names(dir_uri)
        if n.startswith("part-") and n.endswith(".json.gz")
    ]
    for name in sorted(names):
        with storage.open_gzip_read(storage.join(dir_uri, name)) as f:
            for line in f:
                line = line.strip()
                if line:
                    id_, vec = json.loads(line)
                    ids.append(id_)
                    rows.append(vec)
    if not ids:
        return [], np.zeros((0, 0), dtype=np.float32)
    return ids, np.asarray(rows, dtype=np.float32)
