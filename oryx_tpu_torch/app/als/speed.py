"""ALS speed layer: incremental fold-in updates.

Rebuild of ALSSpeedModel (app/oryx-app/.../speed/als/ALSSpeedModel.java:
35-151) and ALSSpeedModelManager (.../ALSSpeedModelManager.java:51-217):
the model holds X/Y FeatureVectors plus the expected-ID sets from the
last batch MODEL (for load-fraction accounting), with cached XtX / YtY
solvers; per micro-batch, each aggregated (user,item,value) event updates
BOTH the user vector (against YtY) and the item vector (against XtX) via
the ALSUtils fold-in, publishing ["X",user,vec[,knownItems]] /
["Y",item,vec[,knownUsers]] deltas.

Port note: a copy of ``oryx_tpu/app/als/speed.py`` with its imports
pointed at ``oryx_tpu_torch``; the batched fold-in runs through
``ops/als.py`` (torch on the card for ``oryx.speed.fold-in-backend =
"device"``). The port has no native parser or store yet:
``oryx.speed.parse.native`` (default true) takes the Python parser, the
JAX package's own path whenever its library declines, and bit for bit
the same by that package's contract; this is logged once at start.
Update messages carry ``json.dumps`` vectors (``native/store.py``).
"""

from __future__ import annotations

import itertools
import logging
import threading
from collections import deque
from typing import Iterable, Iterator

import numpy as np

from oryx_tpu_torch.api.speed import SpeedModel, SpeedModelManager
from oryx_tpu_torch.app import pmml as app_pmml
from oryx_tpu_torch.app.als import data as als_data
from oryx_tpu_torch.app.als.common import apply_up_lines, consume_blocks_columnar
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.records import InteractionBlock, Records
from oryx_tpu_torch.common.text import read_json
from oryx_tpu_torch.common.vectormath import Solver, SingularMatrixSolverException, get_solver
from oryx_tpu_torch.native.store import (
    format_update_messages,
    format_update_messages_multi,
    make_feature_vectors,
)
from oryx_tpu_torch.ops import als as als_ops

log = logging.getLogger(__name__)


class ALSSpeedModel(SpeedModel):
    def __init__(
        self,
        features: int,
        implicit: bool,
        expected_user_ids: set[str],
        expected_item_ids: set[str],
    ) -> None:
        self.features = features
        self.implicit = implicit
        self.x = make_feature_vectors()
        self.y = make_feature_vectors()
        self._expected_users = set(expected_user_ids)
        self._expected_items = set(expected_item_ids)
        self._solver_lock = threading.Lock()
        self._xtx_solver: Solver | None = None
        self._yty_solver: Solver | None = None

    def set_user_vector(self, user: str, vector: np.ndarray) -> None:
        self.x.set_vector(user, vector)
        self._expected_users.discard(user)
        with self._solver_lock:
            self._xtx_solver = None

    def set_item_vector(self, item: str, vector: np.ndarray) -> None:
        self.y.set_vector(item, vector)
        self._expected_items.discard(item)
        with self._solver_lock:
            self._yty_solver = None

    def set_user_vectors(self, users: list[str], vectors: np.ndarray) -> None:
        """Batched set: one store call, one expected-set update and
        one solver invalidation for the whole batch (the per-record form
        pays all three per delta — ruinous at 100K+ self-consumed
        deltas/s)."""
        self.x.set_batch(users, vectors)
        self._expected_users.difference_update(users)
        with self._solver_lock:
            self._xtx_solver = None

    def set_item_vectors(self, items: list[str], vectors: np.ndarray) -> None:
        self.y.set_batch(items, vectors)
        self._expected_items.difference_update(items)
        with self._solver_lock:
            self._yty_solver = None

    def get_xtx_solver(self) -> Solver | None:
        with self._solver_lock:
            if self._xtx_solver is None:
                self._xtx_solver = get_solver(self.x.get_vtv())
            return self._xtx_solver

    def get_yty_solver(self) -> Solver | None:
        with self._solver_lock:
            if self._yty_solver is None:
                self._yty_solver = get_solver(self.y.get_vtv())
            return self._yty_solver

    def retain_recent_and_ids(self, user_ids: set[str], item_ids: set[str]) -> None:
        self.x.retain_recent_and_ids(user_ids)
        self.y.retain_recent_and_ids(item_ids)
        # rotation changes both stores: cached Gramian solvers are stale
        with self._solver_lock:
            self._xtx_solver = None
            self._yty_solver = None

    def get_fraction_loaded(self) -> float:
        """Loaded fraction vs expected IDs (ALSSpeedModel.java:128-142)."""
        expected = len(self._expected_users) + len(self._expected_items)
        loaded = self.x.size() + self.y.size()
        if expected + loaded == 0:
            return 1.0
        return loaded / (loaded + expected)

    def __repr__(self) -> str:  # pragma: no cover
        return f"ALSSpeedModel[features={self.features}, X={self.x.size()}, Y={self.y.size()}]"


class ALSSpeedModelManager(SpeedModelManager):
    def __init__(self, config: Config) -> None:
        self.implicit = config.get_bool("oryx.als.implicit")
        self.no_known_items = config.get_bool("oryx.als.no-known-items")
        self.fold_backend = config.get_string("oryx.speed.fold-in-backend")
        self.self_apply = config.get_bool("oryx.speed.self-apply")
        # byte-encoded copies of this instance's own published deltas,
        # publish order; the consume thread skips exact matches instead
        # of re-parsing them (the vectors were applied at build time).
        # Bounded: overflow just means those messages get re-applied.
        self._self_pending: deque[bytes] = deque()
        self._self_pending_cap = 600_000
        self.min_model_load_fraction = config.get_float(
            "oryx.speed.min-model-load-fraction"
        )
        if not 0.0 <= self.min_model_load_fraction <= 1.0:
            raise ValueError("oryx.speed.min-model-load-fraction must be in [0,1]")
        if config.get_bool("oryx.speed.parse.native"):
            log.info(
                "oryx.speed.parse.native is set, but oryx_tpu_torch has no native "
                "parser yet: interaction lines parse with the Python parser"
            )
        # sharded pipeline state: shard count (configure_sharding), and the
        # shared PartitionedFoldInSession bound to the current Solver pair.
        # _fold_lock guards the (solvers, session) swap; each shard then
        # works its private slice without further synchronization.
        self._shards = 1
        self._fold_lock = threading.Lock()
        self._part_session = None
        self._part_session_solvers: tuple | None = None
        self.model: ALSSpeedModel | None = None

    def configure_sharding(self, shards: int) -> None:
        """Declare that ``shards`` pipeline chains will call
        :meth:`fold_parsed` concurrently (shard-private fold slices over
        one shared Gramian pair). With more than one shard the
        self-pending skip queue is retired: its exact-byte matching
        assumes this instance's publishes hit the UP partition in fold
        order, which concurrent per-shard publishers no longer guarantee
        — unmatched self-deltas simply re-apply (absolute vectors,
        idempotent)."""
        with self._fold_lock:
            self._shards = max(1, int(shards))
            shards = self._shards
        if shards > 1:
            self._self_pending_cap = 0
            self._self_pending.clear()

    # -- update-topic consumption (ALSSpeedModelManager.consume:74-126) ------

    def consume_blocks(self, block_iterator) -> None:
        """Columnar consume: contiguous runs of "UP" records parse as one
        vectorized batch (the shared ``apply_up_lines`` fast path) and
        apply via the batched setters. Everything else — MODEL/MODEL-REF,
        escaped ids, malformed lines — falls back to the per-record
        consume in order."""
        consume_blocks_columnar(
            block_iterator,
            lambda: self.model is not None,
            self._apply_up_batch,
            self.consume,
        )

    def _apply_up_batch(self, lines: list[bytes]) -> None:
        pending = self._self_pending
        if pending:
            # skip this instance's own deltas coming back around the
            # topic: exact byte match against the publish-ordered queue
            # (single UP partition preserves order). Anything unmatched —
            # another producer's message, a rotation in between — applies
            # normally; a missed match merely re-applies an absolute
            # vector, which is idempotent.
            # fast path: the block is exactly the next run of our own
            # deltas (single UP partition, publish order) — one C-level
            # list compare instead of a deque pop + compare per record
            m = min(len(lines), len(pending))
            if lines[:m] == list(itertools.islice(pending, m)):
                for _ in range(m):
                    pending.popleft()
                lines = lines[m:]
            else:
                rest: list[bytes] = []
                for ln in lines:
                    if pending and ln == pending[0]:
                        pending.popleft()
                    else:
                        rest.append(ln)
                lines = rest
            if not lines:
                return
        model = self.model
        apply_up_lines(
            lines,
            model.features,
            model.set_user_vectors,
            model.set_item_vectors,
            lambda km: self.consume(iter([km])),
        )

    def consume(self, update_iterator: Iterator[KeyMessage]) -> None:
        for km in update_iterator:
            key, message = km.key, km.message
            if key == "UP":
                if self.model is None:
                    continue  # no model to interpret against yet
                update = read_json(message)
                which, id_ = update[0], str(update[1])
                vector = np.asarray(update[2], dtype=np.float32)
                if which == "X":
                    self.model.set_user_vector(id_, vector)
                elif which == "Y":
                    self.model.set_item_vector(id_, vector)
            elif key in ("MODEL", "MODEL-REF"):
                pmml = app_pmml.read_pmml_from_update_message(key, message)
                if pmml is None:
                    log.warning("dropped unreadable model update")
                    continue
                features = int(app_pmml.get_required_extension_value(pmml, "features"))
                implicit = app_pmml.get_required_extension_value(pmml, "implicit") == "true"
                x_ids = set(app_pmml.get_extension_content(pmml, "XIDs") or [])
                y_ids = set(app_pmml.get_extension_content(pmml, "YIDs") or [])
                if (
                    self.model is None
                    or self.model.features != features
                    or self.model.implicit != implicit
                ):
                    self.model = ALSSpeedModel(features, implicit, x_ids, y_ids)
                    log.info(
                        "ALS speed model: %d features, %d users and %d items expected",
                        features, len(x_ids), len(y_ids),
                    )
                else:
                    # same config: rotate, keeping recent writes + new model IDs
                    self.model.retain_recent_and_ids(x_ids, y_ids)
                # queued self-delta bytes predate this MODEL: their vectors
                # were applied to (or rotated out of) the pre-model state,
                # so skipping their round-trips now would drop legitimate
                # re-applications onto the fresh/rotated stores — and any
                # stale head blocks exact-match skips of post-model deltas
                self._self_pending.clear()
            else:
                raise ValueError(f"bad key {key}")

    # -- micro-batch deltas (ALSSpeedModelManager.buildUpdates:135-205) ------

    def build_updates(self, new_data: Iterable[KeyMessage]) -> Iterable[str]:
        model = self.model
        # fold-ins against a half-replayed model would publish junk deltas
        # (ALSSpeedModelManager.buildUpdates:136-138 gates identically)
        if model is None or model.get_fraction_loaded() < self.min_model_load_fraction:
            return []
        return self.fold_parsed(self.parse_batch(new_data))

    def parse_batch(self, new_data: Iterable[KeyMessage]):
        """Stage 1 of the staged micro-batch: parse + aggregate the raw
        events into a RatingMatrix. Model-independent, so the pipelined
        layer can run it on the parse worker while the fold worker is
        still busy with the previous batch. Returns None when the batch
        holds no events.

        Typed :class:`InteractionBlock` batches (binary columnar bus
        frames) skip text entirely — int codes flow straight into the
        shared aggregate core; a batch mixing typed and text blocks (or
        typed blocks with differing prefixes/timestamp presence) falls
        back through the blocks' rendered ``messages``, which is the
        exact same wire text the producer would have sent line-framed.
        """
        if isinstance(new_data, Records):
            blocks = list(new_data.blocks())
            if blocks and all(isinstance(b, InteractionBlock) for b in blocks):
                first = blocks[0]
                has_ts = first.timestamps is not None
                if all(
                    b.user_prefix == first.user_prefix
                    and b.item_prefix == first.item_prefix
                    and (b.timestamps is not None) == has_ts
                    for b in blocks
                ):
                    if len(blocks) == 1:
                        users, items, values = first.users, first.items, first.values
                        ts = first.timestamps
                    else:
                        users = np.concatenate([b.users for b in blocks])
                        items = np.concatenate([b.items for b in blocks])
                        values = np.concatenate([b.values for b in blocks])
                        ts = (
                            np.concatenate([b.timestamps for b in blocks])
                            if has_ts
                            else None
                        )
                    return als_data.rating_matrix_from_int_columns(
                        users, items, values, ts, self.implicit,
                        first.user_prefix, first.item_prefix,
                    )
            # columnar text parse + aggregate: one numpy pass over the
            # micro-batch (same semantics as parse_interactions +
            # aggregate; the indexed form gives aggregated (user, item,
            # value) triples directly)
            cols = als_data.concat_columns(
                [als_data.parse_interaction_block(b.messages) for b in blocks]
            )
        else:
            msgs = [
                (km if isinstance(km, str) else km.message).encode("utf-8")
                for km in new_data
            ]
            if not msgs:
                return None
            cols = als_data.parse_interaction_block(msgs)
        rm = als_data.rating_matrix_from_columns(cols, self.implicit)
        return rm if len(rm.values) else None

    def _device_gramian(self, solver: Solver):
        """The solver's Gramian as a cached device array: solver caches
        invalidate exactly when the Gramian changes (writes, rotation),
        so a fresh Solver is the only event that re-pays the upload."""
        g = getattr(solver, "_device_gramian_cache", None)
        if g is None:
            g = als_ops.device_gramian(solver.matrix)
            solver._device_gramian_cache = g
        return g

    def _fold_session(self, yty: Solver, xtx: Solver, n: int, k: int, shard: int):
        """Shard ``shard``'s private fold-in slice over the shared
        :class:`~oryx_tpu_torch.ops.als.PartitionedFoldInSession`. The session
        is bound to the current Solver PAIR (held by identity — solver
        caches invalidate exactly when the Gramians change, so a new pair
        means rebuild + one fresh device upload shared by all shards);
        only the pair swap is locked, the returned slice is touched by
        its shard alone."""
        with self._fold_lock:
            ps = self._part_session
            solvers = self._part_session_solvers
            if (
                ps is None
                or ps.shards != self._shards
                or solvers is None
                or solvers[0] is not yty
                or solvers[1] is not xtx
            ):
                ps = als_ops.PartitionedFoldInSession(
                    yty.matrix, xtx.matrix, self.implicit, self._shards,
                    backend=self.fold_backend,
                )
                if ps.resolved_backend(n, k) == "device":
                    # device-resident Gramians: uploaded once per Solver
                    # pair (i.e. only when vector writes or a rotation
                    # invalidated the cache) and shared by every shard's
                    # slice. Host/auto folds keep the float64 originals —
                    # their Cholesky runs in f64, and the device path
                    # casts to f32 regardless, so results are
                    # bit-identical to the unbatched fold either way.
                    ps.set_gramians(
                        self._device_gramian(yty), self._device_gramian(xtx)
                    )
                self._part_session = ps
                self._part_session_solvers = (yty, xtx)
        return ps.session(shard)

    def fold_parsed(self, rm, shard: int = 0) -> list[str]:
        """Stage 2: fold an aggregated RatingMatrix into the live model
        and render the update messages. Re-checks the load-fraction gate
        (the pipeline parses ahead of the model becoming ready). In the
        sharded pipeline each chain passes its ``shard`` index and folds
        its slice concurrently with the others."""
        model = self.model
        if rm is None or len(rm.values) == 0:
            return []
        if model is None or model.get_fraction_loaded() < self.min_model_load_fraction:
            return []
        try:
            yty = model.get_yty_solver()
            xtx = model.get_xtx_solver()
        except SingularMatrixSolverException as e:
            log.warning("model too degenerate to fold in updates: %s", e)
            return []
        if yty is None or xtx is None:
            return []
        # One data-parallel call for the whole micro-batch: every event
        # reads pre-batch state (updates travel via the update topic), so
        # there is no sequential dependency to honor — same contract as the
        # reference's parallelStream, but as a single batched solve.
        n = len(rm.values)
        # vocab-level gather: one fetch per UNIQUE id, expanded to
        # per-event rows by a fancy-index copy
        user_ids_arr = np.asarray(rm.user_ids, dtype=object)
        item_ids_arr = np.asarray(rm.item_ids, dtype=object)
        xu_vocab, xu_ok = model.x.get_batch(user_ids_arr.tolist(), dim=model.features)
        yi_vocab, yi_ok = model.y.get_batch(item_ids_arr.tolist(), dim=model.features)
        xu, xu_valid = xu_vocab[rm.user_idx], xu_ok[rm.user_idx]
        yi, yi_valid = yi_vocab[rm.item_idx], yi_ok[rm.item_idx]
        values = rm.values
        session = self._fold_session(yty, xtx, n, model.features, shard)
        session.add_block(xu, xu_valid, yi, yi_valid, values)
        new_xu, x_upd, new_yi, y_upd = session.solve()
        x_rows = np.nonzero(x_upd)[0]
        y_rows = np.nonzero(y_upd)[0]
        known = not self.no_known_items
        # Coalesce per id before publishing: every event's update is an
        # ABSOLUTE vector computed from pre-batch state, so within one
        # micro-batch the last successful update per id fully determines
        # the applied end state — every consumer (speed self-consume,
        # serving, batch replay) applies set_*_vector last-wins. One
        # message per updated id (the last event's vector, X known-items
        # = union over the id's updated events) reaches the same state
        # with ~half the publish/apply/bus-byte cost at duplicate-heavy
        # event rates. (The reference publishes one message per event —
        # toUpdateJSON per parallelStream element — because its updates
        # evolve sequentially; batched pre-state fold-in has no such
        # intermediate states to preserve.)
        ux = rm.user_idx[x_rows]
        last_x = np.full(len(rm.user_ids), -1, np.int64)
        last_x[ux] = x_rows
        keep_users = np.nonzero(last_x >= 0)[0]
        rows_x = last_x[keep_users]
        iy = rm.item_idx[y_rows]
        last_y = np.full(len(rm.item_ids), -1, np.int64)
        last_y[iy] = y_rows
        keep_items = np.nonzero(last_y >= 0)[0]
        rows_y = last_y[keep_items]
        x_ids = user_ids_arr[keep_users].tolist()
        y_ids = item_ids_arr[keep_items].tolist()
        def group_other_ids(own_idx, other_names):
            """Per kept own-id, the (insertion-ordered, deduped) other ids
            of its updated events: one sort, then per-group dedupe."""
            order = np.argsort(own_idx, kind="stable")
            so = own_idx[order]
            names = other_names[order]
            if not len(so):
                return []
            bounds = np.nonzero(np.r_[True, so[1:] != so[:-1]])[0]
            ends_ = np.r_[bounds[1:], len(so)]
            return [
                list(dict.fromkeys(names[s:e].tolist())) for s, e in zip(bounds, ends_)
            ]

        known_lists: list[list[str]] = []
        y_known: list[list[str]] = []
        if known:
            # both sides union their events' counterpart ids (the X list
            # feeds serving known-items; the Y list keeps the per-event
            # wire contract's information for external subscribers)
            known_lists = group_other_ids(ux, item_ids_arr[rm.item_idx[x_rows]])
            y_known = group_other_ids(iy, user_ids_arr[rm.user_idx[y_rows]])
            x_msgs = format_update_messages_multi(new_xu[rows_x], x_ids, known_lists, "X")
            y_msgs = format_update_messages_multi(new_yi[rows_y], y_ids, y_known, "Y")
        else:
            x_msgs = format_update_messages(new_xu[rows_x], x_ids, [], "X", False)
            y_msgs = format_update_messages(new_yi[rows_y], y_ids, [], "Y", False)
        out = x_msgs + y_msgs
        if self.self_apply and model is self.model:
            # apply the deltas to this model NOW (they are absolute
            # vectors computed this batch) and queue their encoded forms
            # so the consume thread can skip the round-trip re-parse
            model.set_user_vectors(x_ids, new_xu[rows_x])
            model.set_item_vectors(y_ids, new_yi[rows_y])
            room = self._self_pending_cap - len(self._self_pending)
            if room > 0:
                self._self_pending.extend(m.encode("utf-8") for m in out[:room])
        return out

    def close(self) -> None:
        # drop the device-resident fold-in session: its per-shard Gramian
        # blocks pin HBM until the last reference dies, and a manager that
        # outlives its layer (fleet rotation) would otherwise hold them
        # for the life of the process
        with self._fold_lock:
            self._part_session = None
            self._part_session_solvers = None
