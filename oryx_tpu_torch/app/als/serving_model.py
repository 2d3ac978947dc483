"""ALS serving model: in-memory factors + batched top-N on the card
(counterpart of ``oryx_tpu/app/als/serving_model.py``).

The model keeps X and Y as id -> vector stores, per-user known-item
sets, the expected-id sets behind ``get_fraction_loaded``, a cached YtY
solver, and a packed card copy of Y that refreshes lazily when vectors
change: a few dirty rows scatter into the handle, a membership change
rebuilds it. Top-N is an exact scan of every item through the port's
streaming kernels, coalesced across concurrent requests by the batcher.
With the user matrix X staged on the card next to Y, ``/recommend`` for
a known user ships an int32 row index instead of a query vector (index
submit).

With ``oryx.serving.scan.ann.enabled`` an int8 catalog of at least
``min-items`` items is served by the IVF tier (``ops/ivf.py``) instead:
the index is built at refresh, fold-ins go through its pending overlay
(waking the background maintainer of ``serving/maintain.py`` when the
overlay fills), the maintainer's compactions install with one pointer
swap, and an ``INDEX-REF`` on the update topic makes the model adopt a
published index generation.

With ``oryx.serving.store.tier.enabled`` the IVF index's host stage-1
plane moves into the tiered cell store (``native/store.py``) as it is
built. X and Y live in the native sharded store where the library builds
(``make_feature_vectors``), in the Python ``FeatureVectors`` otherwise;
the manager logs which at start.

With ``oryx.als.sample-rate < 1`` the model keeps a host copy of Y and
each row's LSH partition (``lsh.py``), and ``top_n`` scores on the host
only the rows whose partition lies in the query's Hamming ball, as the
JAX package does; LSH turns off index submit, the incremental refresh,
the IVF tier and index-generation adoption.

With ``oryx.als.serving.shard-items`` Y is row-sharded over the mesh of
every scoped device (``parallel.mesh.get_mesh()``; on a one-card host the
one card) and each scan runs ``ops/topn.top_k_sharded``: the scan
kernels per shard, the shards' lists merged. As in the JAX package, the
sharded layout rebuilds whole at each refresh, and X staging (index
submit), the IVF tier and index-generation adoption are off.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.app import pmml as app_pmml
from oryx_tpu_torch.app.als.common import apply_up_lines, consume_blocks_columnar
from oryx_tpu_torch.app.als.lsh import LocalitySensitiveHash
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common import tracing
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.lang import ReadWriteLock
from oryx_tpu_torch.common.text import read_json
from oryx_tpu_torch.common.vectormath import Solver, get_solver
from oryx_tpu_torch.native import get_library
from oryx_tpu_torch.native.store import make_feature_vectors
from oryx_tpu_torch.ops import ivf as ivf_ops
from oryx_tpu_torch.ops import topn as topn_ops
from oryx_tpu_torch.serving.batcher import score_default, score_indexed_default

log = logging.getLogger(__name__)

_SCORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _in_id_order(ids: list[str], mat: np.ndarray) -> tuple[list[str], np.ndarray]:
    """An IVF build's rows in id order, so its k-means sample and layout
    follow the catalog, not the store's row order (the native store's is
    by shard, the Python one's by insertion). Ids order by length, then
    text: numeric ids, and ids of one prefix and a number, in their
    number's order."""
    lens = np.fromiter(map(len, ids), np.int64, len(ids))
    order = np.lexsort((np.asarray(ids), lens))
    return [ids[i] for i in order.tolist()], mat[order]


class ALSServingModel(ServingModel):
    def __init__(
        self,
        features: int,
        implicit: bool,
        refresh_sec: float = 0.2,
        sample_rate: float = 1.0,
        score_dtype: str = "float32",
        shard_items: bool = False,
        device_user_matrix: bool = True,
    ) -> None:
        if score_dtype not in _SCORE_DTYPES:
            raise ValueError(
                f"score dtype must be float32, bfloat16, or int8, got {score_dtype!r}"
            )
        self.features = features
        self.implicit = implicit
        # stage X on the card next to Y so /recommend for a known user
        # ships an int32 row index instead of a query vector (index
        # submit); only for the exact scan on the card
        self.device_user_matrix = device_user_matrix
        self._x_staging = bool(device_user_matrix) and sample_rate >= 1.0 and not shard_items
        # row-shard Y over the scoped devices (per-shard scans, their
        # lists gathered and merged): the serving mode past one card's memory
        self.shard_items = shard_items
        # item-matrix dtype on the card: bfloat16 halves the scanned bytes
        # at ~1e-2 relative score precision; int8 halves them again and
        # rescoring oversampled candidates against the residual plane
        # keeps top-10 recall >= 0.99 of float32
        self.score_dtype = score_dtype
        # LSH candidate pruning is opt-in (sample-rate < 1): the pruned
        # rows are scored on the host, the exact scan on the card otherwise
        self.lsh = None
        if sample_rate < 1.0:
            self.lsh = LocalitySensitiveHash(sample_rate, features, os.cpu_count() or 1)
        self.x = make_feature_vectors()
        self.y = make_feature_vectors()
        self._known_lock = ReadWriteLock()
        self._known_items: dict[str, set[str]] = {}
        self._expected_lock = threading.Lock()
        self._expected_users: set[str] = set()
        self._expected_items: set[str] = set()
        self._solver_lock = threading.Lock()
        self._yty_solver: Solver | None = None
        # packed card copy of Y
        self._cache_lock = threading.Lock()
        self._y_dirty = True
        # -inf: the first card build is always due; refresh_sec throttles
        # only rebuilds (a monotonic clock may read below refresh_sec)
        self._y_built_at = -math.inf
        self._refresh_sec = refresh_sec
        self._y_ids: list[str] = []
        self._y_index: dict[str, int] = {}
        self._y_matrix = None  # StreamingItemMatrix, ShardedItemMatrix or IVFIndex
        self._y_host: np.ndarray | None = None  # host copy, LSH path only
        self._y_partitions: np.ndarray | None = None  # LSH partition per row
        # incremental refresh state: ids written since the last build, and
        # whether membership may have shrunk (rotation) forcing a rebuild
        self._dirty_ids: set[str] = set()
        self._y_full_rebuild = True
        # IVF maintenance handshake (serving/maintain.py): the build epoch
        # bumps on every full rebuild or index swap, so a compaction whose
        # snapshot predates the current id space is discarded at install;
        # the pressure callback wakes the maintainer when a fold-in batch
        # crosses the overlay watermark or spills
        self._y_build_epoch = 0
        self._y_snapshot_epoch = -1
        # bumps on every rotation: an index adoption built from a
        # pre-rotation store snapshot is discarded
        self._y_rotation_epoch = 0
        self._index_pressure_cb = None
        self._index_generation: str | None = None
        # card copy of X (query matrix for index-submitted /recommend)
        self._x_ids: list[str] = []
        self._x_index: dict[str, int] = {}
        self._x_matrix = None  # [n, k] float32 tensor
        self._x_dirty_ids: set[str] = set()
        self._x_dirty = True
        self._x_full_rebuild = True
        self._x_built_at = -math.inf
        self._x_capacity = 0
        self._x_building = False
        self._x_restage_thread: threading.Thread | None = None
        self._x_epoch = 0  # bumped by rotation: invalidates in-flight restages

    # -- vectors -------------------------------------------------------------

    def get_user_vector(self, user: str) -> np.ndarray | None:
        return self.x.get_vector(user)

    def get_item_vector(self, item: str) -> np.ndarray | None:
        return self.y.get_vector(item)

    def set_user_vector(self, user: str, vector: np.ndarray) -> None:
        self.x.set_vector(user, vector)
        with self._expected_lock:
            self._expected_users.discard(user)
        if self._x_staging:
            with self._cache_lock:
                self._x_dirty = True
                self._x_dirty_ids.add(user)

    def set_item_vector(self, item: str, vector: np.ndarray) -> None:
        self.y.set_vector(item, vector)
        with self._expected_lock:
            self._expected_items.discard(item)
        with self._solver_lock:
            self._yty_solver = None
        with self._cache_lock:
            self._y_dirty = True
            self._dirty_ids.add(item)

    def set_user_vectors(self, users: list[str], vectors: np.ndarray) -> None:
        """Batched set: one store call + one lock round for the whole
        batch (update-topic replay is one UP per factor row)."""
        self.x.set_batch(users, vectors)
        with self._expected_lock:
            self._expected_users.difference_update(users)
        if self._x_staging:
            with self._cache_lock:
                self._x_dirty = True
                self._x_dirty_ids.update(users)

    def set_item_vectors(self, items: list[str], vectors: np.ndarray) -> None:
        self.y.set_batch(items, vectors)
        with self._expected_lock:
            self._expected_items.difference_update(items)
        with self._solver_lock:
            self._yty_solver = None
        with self._cache_lock:
            self._y_dirty = True
            self._dirty_ids.update(items)

    # -- known items ---------------------------------------------------------

    def add_known_items(self, user: str, items: Iterable[str]) -> None:
        items = list(items)
        if not items:
            return
        with self._known_lock.write():
            self._known_items.setdefault(user, set()).update(items)

    def add_known_items_many(self, pairs: Iterable[tuple[str, list[str]]]) -> None:
        """Batched known-items merge under one write lock."""
        with self._known_lock.write():
            known = self._known_items
            for user, items in pairs:
                if items:
                    known.setdefault(user, set()).update(items)

    def get_known_items(self, user: str) -> set[str]:
        with self._known_lock.read():
            return set(self._known_items.get(user, ()))

    def remove_known_item(self, user: str, item: str) -> None:
        with self._known_lock.write():
            s = self._known_items.get(user)
            if s is not None:
                s.discard(item)

    def get_known_item_counts(self) -> dict[str, int]:
        with self._known_lock.read():
            return {u: len(s) for u, s in self._known_items.items()}

    def get_item_counts(self) -> dict[str, int]:
        """item -> number of users that know it, in one locked pass."""
        counts: dict[str, int] = {}
        with self._known_lock.read():
            for items in self._known_items.values():
                for item in items:
                    counts[item] = counts.get(item, 0) + 1
        return counts

    # -- expected-ID accounting ----------------------------------------------

    def set_expected(self, user_ids: Iterable[str], item_ids: Iterable[str]) -> None:
        users = set(user_ids) - set(self.x.ids())
        items = set(item_ids) - set(self.y.ids())
        with self._expected_lock:
            self._expected_users = users - set(self.x.ids())
            self._expected_items = items - set(self.y.ids())

    def get_fraction_loaded(self) -> float:
        with self._expected_lock:
            expected = len(self._expected_users) + len(self._expected_items)
        loaded = self.x.size() + self.y.size()
        if expected + loaded == 0:
            return 1.0
        return loaded / (loaded + expected)

    # -- rotation ------------------------------------------------------------

    def retain_recent_and_user_ids(self, ids: set[str]) -> None:
        self.x.retain_recent_and_ids(ids)
        if self._x_staging:
            with self._cache_lock:
                self._x_dirty = True
                # membership may have SHRUNK: staged rows of removed users
                # must stop serving now, and an in-flight restage built from
                # the pre-rotation store is discarded at swap time
                self._x_full_rebuild = True
                self._x_epoch += 1

    def retain_recent_and_item_ids(self, ids: set[str]) -> None:
        self.y.retain_recent_and_ids(ids)
        with self._solver_lock:
            self._yty_solver = None
        with self._cache_lock:
            self._y_dirty = True
            self._y_full_rebuild = True  # membership may have shrunk
            self._y_rotation_epoch += 1

    def retain_recent_and_known_items(self, user_ids: set[str]) -> None:
        with self._known_lock.write():
            for u in [u for u in self._known_items if u not in user_ids]:
                del self._known_items[u]

    # -- solver --------------------------------------------------------------

    def get_yty_solver(self) -> Solver | None:
        with self._solver_lock:
            if self._yty_solver is None:
                self._yty_solver = get_solver(self.y.get_vtv())
            return self._yty_solver

    # -- scoring on the card ---------------------------------------------------

    def _try_incremental_refresh(self, dirty: list[str]) -> bool:
        """Scatter only the dirty rows into the card copy of Y (caller
        holds the cache lock). False when a full rebuild is required: a
        dirty vector vanished or new ids exceed the padded capacity."""
        vals, valid = self.y.get_batch(dirty, dim=self.features)
        if not np.all(valid):
            return False
        new_ids = [d for d in dirty if d not in self._y_index]
        ivf = isinstance(self._y_matrix, ivf_ops.IVFIndex)
        if len(self._y_ids) + len(new_ids) > topn_ops.capacity(self._y_matrix):
            # an IVF index with a maintainer attached absorbs the growth:
            # the overlay spills its oldest entries to the compaction queue
            # instead of forcing a re-cluster on the request path
            if not (ivf and self._index_pressure_cb is not None):
                return False
        for d in new_ids:  # append into the padded region
            self._y_index[d] = len(self._y_ids)
            self._y_ids.append(d)
        rows = np.fromiter(
            (self._y_index[d] for d in dirty), dtype=np.int64, count=len(dirty)
        )
        self._y_matrix = topn_ops.update_rows(
            self._y_matrix, rows, vals, n_items=len(self._y_ids)
        )
        cb = self._index_pressure_cb
        if cb is not None and ivf and ivf_ops.needs_maintenance(self._y_matrix):
            cb()
        return True

    def _ensure_y_matrix(self, force: bool = False):
        with self._cache_lock:
            now = time.monotonic()
            if self._y_dirty and (force or now - self._y_built_at >= self._refresh_sec):
                dirty = list(self._dirty_ids)
                refreshed = (
                    self._y_matrix is not None
                    and not self._y_full_rebuild
                    and self.lsh is None
                    and not self.shard_items  # the sharded layout rebuilds whole
                    and bool(dirty)
                    and self._try_incremental_refresh(dirty)
                )
                if not refreshed:
                    ids, mat = self.y.to_matrix()
                    ann = (
                        self.score_dtype == "int8"
                        and self.lsh is None
                        and not self.shard_items
                        and ivf_ops.ann_active(len(ids))
                    )
                    if ann:
                        ids, mat = _in_id_order(ids, mat)
                    self._y_ids = ids
                    self._y_index = {id_: i for i, id_ in enumerate(ids)}
                    if not len(ids):
                        self._y_matrix = None
                    elif self.shard_items:
                        from oryx_tpu_torch.parallel.mesh import get_mesh

                        self._y_matrix = topn_ops.upload_sharded(
                            mat, get_mesh(), dtype=_SCORE_DTYPES[self.score_dtype]
                        )
                    elif ann:
                        # the IVF tier: cluster the rebuilt item matrix;
                        # fold-ins until the next rebuild go through the
                        # index's pending overlay
                        self._y_matrix = ivf_ops.attach_tiered_plane(ivf_ops.build_ivf(mat))
                    else:
                        self._y_matrix = topn_ops.upload(
                            mat, dtype=_SCORE_DTYPES[self.score_dtype]
                        )
                    if self.lsh is not None:
                        self._y_host = mat
                        self._y_partitions = (
                            self.lsh.partitions_for(mat) if len(ids) else None
                        )
                    self._y_full_rebuild = False
                    # the id space changed: compaction snapshots in
                    # flight are stale and are discarded at install
                    self._y_build_epoch += 1
                self._dirty_ids.clear()
                self._y_dirty = False
                self._y_built_at = now
            # one request sees one consistent (ids, index, matrix, host
            # copy, partitions) snapshot even if a rebuild swaps them
            # mid-flight
            return (
                self._y_ids,
                self._y_index,
                self._y_matrix,
                self._y_host,
                self._y_partitions,
            )

    def _try_incremental_x_refresh(self, dirty: list[str]) -> bool:
        """Scatter the dirty rows of the card copy of X (caller holds the
        cache lock); first-time users append into the padded capacity.
        False = rebuild required."""
        new = [u for u in dirty if u not in self._x_index]
        if len(self._x_ids) + len(new) > self._x_capacity:
            return False
        vals, valid = self.x.get_batch(dirty, dim=self.features)
        if not np.all(valid):
            return False  # a dirty user vanished: membership changed
        for u in new:
            self._x_index[u] = len(self._x_ids)
            self._x_ids.append(u)
        rows = np.fromiter(
            (self._x_index[u] for u in dirty), dtype=np.int64, count=len(dirty)
        )
        self._x_matrix = topn_ops.update_query_rows(self._x_matrix, rows, vals)
        return True

    # staged X bigger than this is not worth the card memory next to Y:
    # index submit turns off rather than risk running out of memory
    _X_STAGE_MAX_BYTES = 2 << 30

    def _rebuild_x_staging(self, pre_dirty: set[str], epoch: int) -> None:
        """Full X restage, run OUTSIDE the cache lock on a daemon thread;
        the swap happens under the lock and is DISCARDED if a rotation
        bumped the epoch mid-build. Ids written during the build stay
        dirty and catch up on the next refresh tick."""
        try:
            ids, mat = self.x.to_matrix()
            if len(ids) * self.features * 4 * 1.25 > self._X_STAGE_MAX_BYTES:
                log.info(
                    "card X (%d users x %d) exceeds the staging budget; "
                    "index submit disabled for this model",
                    len(ids), self.features,
                )
                with self._cache_lock:
                    self._x_matrix = None
                    self._x_capacity = 0
                    self._x_staging = False
                    self._x_dirty_ids.clear()
                    self._x_dirty = False
                return
            if len(ids):
                # pad capacity so a trickle of new users appends via
                # scatter instead of re-uploading everything
                cap = max(64, int(len(ids) * 1.25))
                pad = np.zeros((cap - len(ids), self.features), np.float32)
                staged = topn_ops.upload_queries(
                    np.concatenate([mat, pad]) if cap > len(ids) else mat
                )
            else:
                staged, cap = None, 0
            with self._cache_lock:
                if self._x_epoch != epoch:
                    return  # rotation landed mid-build: discard the snapshot
                self._x_ids = list(ids)
                self._x_index = {id_: i for i, id_ in enumerate(ids)}
                self._x_matrix = staged
                self._x_capacity = cap
                self._x_full_rebuild = False
                self._x_dirty_ids -= pre_dirty
                self._x_dirty = bool(self._x_dirty_ids)
                self._x_built_at = time.monotonic()
        finally:
            with self._cache_lock:
                self._x_building = False

    def _user_scan_row(self, user: str):
        """(x_matrix, row) for index submit, or (None, None) when the user
        isn't freshly staged. A pending full restage serves the vector
        path instead of blocking."""
        rebuild_dirty: set[str] | None = None
        with self._cache_lock:
            now = time.monotonic()
            if self._x_dirty and (now - self._x_built_at >= self._refresh_sec):
                dirty = list(self._x_dirty_ids)
                refreshed = (
                    not self._x_building  # a restage's swap would clobber a scatter
                    and self._x_matrix is not None
                    and not self._x_full_rebuild
                    and bool(dirty)
                    and self._try_incremental_x_refresh(dirty)
                )
                if refreshed:
                    self._x_dirty_ids.clear()
                    self._x_dirty = False
                    self._x_built_at = now
                elif not self._x_building:
                    self._x_building = True
                    rebuild_dirty = set(self._x_dirty_ids)
                    rebuild_epoch = self._x_epoch
            stale = (
                self._x_matrix is None
                or self._x_full_rebuild  # rotation pending: rows may be gone
                or user in self._x_dirty_ids
            )
            row = None if stale else self._x_index.get(user)
            x_mat = self._x_matrix
        if rebuild_dirty is not None:
            # the request that trips the refresh tick falls through to the
            # vector path instead of paying the restage's latency
            prev = self._x_restage_thread
            if prev is not None:
                prev.join(timeout=5.0)
            t = threading.Thread(
                target=self._rebuild_x_staging,
                args=(rebuild_dirty, rebuild_epoch),
                name="als-x-restage",
                daemon=True,
            )
            self._x_restage_thread = t
            t.start()
            from oryx_tpu_torch.common import ledger

            ledger.register("thread", t, live=threading.Thread.is_alive)
        if row is None:
            return None, None
        return x_mat, row

    def top_n_for_user(
        self,
        user: str,
        how_many: int,
        exclude: set[str] | None = None,
        rescorer=None,
        cosine: bool = False,
    ) -> list[tuple[str, float]] | None:
        """top_n for a known user id, or None when the user is unknown.
        A staged user ships its row index (index submit); a user changed
        since the last X refresh, or not staged yet, takes the fresh host
        vector, so results are never staler than the vector path's."""
        if self._x_staging:
            x_mat, row = self._user_scan_row(user)
            if row is not None:
                ids, _index, y_mat, _h, _p = self._ensure_y_matrix()
                if y_mat is not None:
                    return self._select_loop(
                        ids,
                        len(ids),
                        lambda k: score_indexed_default(y_mat, x_mat, row, k, cosine=cosine),
                        how_many,
                        exclude,
                        rescorer,
                    )
        vec = self.get_user_vector(user)
        if vec is None:
            return None
        return self.top_n(vec, how_many, exclude=exclude, rescorer=rescorer, cosine=cosine)

    def top_n(
        self,
        query: np.ndarray,
        how_many: int,
        exclude: set[str] | None = None,
        rescorer=None,
        cosine: bool = False,
    ) -> list[tuple[str, float]]:
        """Top-N items by dot (or cosine) score against `query`: an exact
        scan of every item on the card, batched with concurrent requests,
        or with LSH the query's candidate rows scored on the host."""
        ids, _index, y_mat, y_host, y_partitions = self._ensure_y_matrix()
        if y_mat is None:
            return []
        # LSH pruning (sample-rate < 1): only rows whose partition lies in
        # the query's Hamming ball are scored
        lsh_rows: np.ndarray | None = None
        if self.lsh is not None and y_partitions is not None:
            cand = self.lsh.candidate_indices(query)
            lsh_rows = np.flatnonzero(np.isin(y_partitions, cand))
            if len(lsh_rows) == 0:
                lsh_rows = None  # degenerate: fall back to the exact scan
        num_candidates = len(lsh_rows) if lsh_rows is not None else len(ids)

        def score_fn(k: int):
            if lsh_rows is not None:
                return _host_top_k(y_host, lsh_rows, query, k, cosine=cosine)
            if isinstance(y_mat, topn_ops.ShardedItemMatrix):
                # mesh-sharded scan: per-shard scans, lists gathered and merged
                bi, bv = topn_ops.top_k_sharded(y_mat, query, k, cosine=cosine)
                return bi[0], bv[0]
            return score_default(y_mat, query, k, cosine=cosine)

        return self._select_loop(ids, num_candidates, score_fn, how_many, exclude, rescorer)

    @staticmethod
    def _select_loop(
        ids, num_candidates, score_fn, how_many, exclude, rescorer
    ) -> list[tuple[str, float]]:
        """Widen the candidate window until how_many survive filtering or
        every item has been considered, so filters never starve results."""
        exclude = exclude or set()
        margin = how_many + len(exclude)
        if rescorer is not None:
            margin = max(margin * 4, margin + 32)  # rescorer may filter many

        def filter_candidates(idx, scores) -> list[tuple[str, float]]:
            out: list[tuple[str, float]] = []
            for i, s in zip(idx, scores):
                id_ = ids[int(i)]
                if id_ in exclude:
                    continue
                score = float(s)
                if rescorer is not None:
                    if rescorer.is_filtered(id_):
                        continue
                    score = rescorer.rescore(id_, score)
                    if np.isnan(score):
                        continue
                out.append((id_, score))
                if len(out) == how_many and rescorer is None:
                    break
            return out

        while True:
            k = min(margin, num_candidates)
            idx, scores = score_fn(k)
            if rescorer is not None:
                with tracing.span("serving.rescore", attrs={"k": int(k)}) as sp:
                    out = filter_candidates(idx, scores)
                    sp.set("kept", len(out))
            else:
                out = filter_candidates(idx, scores)
            if len(out) >= how_many or k >= num_candidates:
                break
            margin = margin * 4
        if rescorer is not None:
            out.sort(key=lambda t: -t[1])
        return out[:how_many]

    # -- IVF maintenance protocol (serving/maintain.py) ------------------------

    def set_index_pressure_callback(self, cb) -> None:
        """Wire the maintainer's wake-up: called (under the cache lock)
        when a fold-in batch crosses the overlay watermark or spills."""
        with self._cache_lock:
            self._index_pressure_cb = cb

    @property
    def index_generation(self) -> str | None:
        """The published index generation this model's layout came from,
        or None when the clustering is locally built."""
        return self._index_generation

    def note_published_index(self, generation_id: str) -> None:
        """This replica just published this generation (its installed
        layout is the generation): its own INDEX-REF off the update topic
        is then a duplicate."""
        with self._cache_lock:
            self._index_generation = str(generation_id)

    def maintenance_snapshot(self, watermark: float = 0.5, force: bool = False):
        """(index, pending snapshot) for one compaction pass, or None when
        there is nothing to compact (no IVF index, a full rebuild pending,
        or overlay pressure below the watermark). The snapshot copies the
        overlay's raw rows under the cache lock: O(overlay), never
        O(catalog)."""
        with self._cache_lock:
            idx = self._y_matrix
            if not isinstance(idx, ivf_ops.IVFIndex) or self._y_full_rebuild:
                return None
            if not force and not ivf_ops.needs_maintenance(idx, watermark=watermark):
                return None
            snap = ivf_ops.snapshot_pending(idx)
            self._y_snapshot_epoch = self._y_build_epoch
            return idx, snap

    def install_compacted(self, new_index, stats: dict) -> bool:
        """Swap a compacted index in (one pointer write under the cache
        lock). Fold-ins that landed after the snapshot (by their fold-in
        time against the snapshot's) are replayed onto the new layout
        first. False (result discarded) when a full rebuild or rotation
        changed the id space during the compaction."""
        with self._cache_lock:
            cur = self._y_matrix
            if (
                not isinstance(cur, ivf_ops.IVFIndex)
                or self._y_full_rebuild
                or self._y_build_epoch != self._y_snapshot_epoch
            ):
                return False
            snap_born = stats.get("born") or {}
            feat = cur.features
            replay_ids: list[int] = []
            replay_rows: list[np.ndarray] = []
            cur_born = cur.ov_born or {}
            for item, slot in cur.ov_map.items():
                b = cur_born.get(item, 0.0)
                if item not in snap_born or b > snap_born[item]:
                    replay_ids.append(int(item))
                    replay_rows.append(cur.ov_raw_host[slot, :feat].copy())
            for item, (raw, b) in (cur.pending_spill or {}).items():
                if item not in snap_born or b > snap_born[item]:
                    replay_ids.append(int(item))
                    replay_rows.append(np.asarray(raw)[:feat].copy())
            if replay_ids:
                new_index = ivf_ops.update_rows(
                    new_index, np.asarray(replay_ids, np.int64), np.stack(replay_rows),
                    n_items=len(self._y_ids),
                )
                stats["replayed"] = len(replay_ids)
            self._y_matrix = new_index
            self._y_snapshot_epoch = -1  # consumed
            return True

    def apply_index_generation(self, ref: str) -> bool:
        """Adopt a published index generation (INDEX-REF): rebuild the IVF
        layout over this replica's item store seeded with the generation's
        centroids, off-lock, and swap it in under the cache lock. True on
        swap."""
        from oryx_tpu_torch.serving import maintain as maintain_mod

        loaded = maintain_mod.read_index_generation(ref)
        if loaded is None:
            return False
        gid, manifest, cents = loaded
        if self._index_generation == gid:
            return False  # duplicate delivery
        if int(manifest.get("features") or cents.shape[1]) != self.features:
            log.warning(
                "index generation %s features mismatch (%s != %d); skipped",
                gid, manifest.get("features"), self.features,
            )
            return False
        if self.lsh is not None or self.shard_items or self.score_dtype != "int8":
            return False  # index generations only drive the IVF scan
        with self._cache_lock:
            rot0 = self._y_rotation_epoch
            # ids dirty now are covered by the store snapshot below
            dirty0 = set(self._dirty_ids)
        ids, mat = self.y.to_matrix()
        if not ivf_ops.ann_active(len(ids)):
            return False
        ids, mat = _in_id_order(ids, mat)
        new = ivf_ops.attach_tiered_plane(ivf_ops.build_ivf(mat, centroids=cents))
        with self._cache_lock:
            if self._y_rotation_epoch != rot0:
                return False  # a rotation raced the build: its rebuild wins
            self._y_ids = list(ids)
            self._y_index = {id_: i for i, id_ in enumerate(ids)}
            self._y_matrix = new
            self._y_full_rebuild = False
            self._y_build_epoch += 1
            self._y_snapshot_epoch = -1
            self._y_built_at = time.monotonic()
            # ids written after the store snapshot stay dirty: the next
            # refresh folds them into the fresh overlay
            self._dirty_ids.difference_update(dirty0)
            self._y_dirty = bool(self._dirty_ids)
            self._index_generation = gid
        return True

    def all_item_ids(self) -> list[str]:
        return self.y.ids()

    def all_user_ids(self) -> list[str]:
        return self.x.ids()

    def close(self) -> None:
        """Orderly teardown: reap the in-flight X restage thread and drop
        the card-resident matrices so a replaced model releases its card
        memory. Idempotent."""
        t = self._x_restage_thread
        if t is not None:
            self._x_restage_thread = None
            t.join(timeout=10.0)
        with self._cache_lock:
            self._y_matrix = None
            self._y_host = None
            self._y_partitions = None
            self._x_matrix = None
            self._x_index = {}
            self._x_ids = []
            # a straggler request still holding this model rebuilds from
            # the vector stores instead of scoring against a dropped cache
            self._y_dirty = True
            self._y_full_rebuild = True
            self._x_dirty = True
            self._x_full_rebuild = True

    def __repr__(self) -> str:  # pragma: no cover
        return f"ALSServingModel[features={self.features}, X={self.x.size()}, Y={self.y.size()}]"


def _host_top_k(
    y_host: np.ndarray,
    rows: np.ndarray,
    query: np.ndarray,
    k: int,
    cosine: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Partial top-k over an LSH-pruned row subset, on the host: the
    candidate set is already about sample-rate of the items."""
    sub = y_host[rows]
    scores = sub @ np.asarray(query, dtype=np.float32)
    if cosine:
        qn = float(np.linalg.norm(query))
        norms = np.linalg.norm(sub, axis=1)
        scores = scores / np.maximum(norms * qn, 1e-12)
    k = max(1, min(int(k), len(rows)))
    part = np.argpartition(-scores, k - 1)[:k]
    order = part[np.argsort(-scores[part])]
    return rows[order], scores[order]


class ALSServingModelManager(AbstractServingModelManager):
    """Consume protocol identical to the speed manager plus known-items
    from UP payloads and rescorer loading."""

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.implicit = config.get_bool("oryx.als.implicit")
        self.no_known_items = config.get_bool("oryx.als.no-known-items")
        self.sample_rate = config.get_float("oryx.als.sample-rate")
        self.score_dtype = config.get_string("oryx.als.serving.score-dtype")
        self.shard_items = config.get_bool("oryx.als.serving.shard-items")
        self.device_user_matrix = config.get_bool("oryx.als.serving.device-user-matrix")
        if self.score_dtype not in _SCORE_DTYPES:
            raise ValueError(
                f"oryx.als.serving.score-dtype must be float32, bfloat16, or "
                f"int8, got {self.score_dtype!r}"
            )
        log.info(
            "ALS serving: %s vector store",
            "NativeFeatureVectors" if get_library() is not None else "FeatureVectors",
        )
        self.rescorer_provider = _load_rescorer_providers(config)
        self.model: ALSServingModel | None = None
        self._consumed = 0

    def consume_blocks(self, block_iterator) -> None:
        """Columnar consume: contiguous "UP" runs parse vectorized and
        apply via the batched setters; anything else falls back to
        per-record consume in order."""
        consume_blocks_columnar(
            block_iterator,
            lambda: self.model is not None,
            self._apply_up_batch,
            self.consume,
        )

    def _apply_up_batch(self, lines: list[bytes]) -> None:
        model = self.model
        applied = apply_up_lines(
            lines,
            model.features,
            model.set_user_vectors,
            model.set_item_vectors,
            lambda km: self.consume(iter([km])),
            on_known=(
                None
                if self.no_known_items
                else lambda pairs: model.add_known_items_many(pairs)
            ),
            strict_tail=True,  # the known list is part of the wire contract
        )
        self._consumed += applied  # slow path self-counts

    def consume(self, update_iterator: Iterator[KeyMessage]) -> None:
        for km in update_iterator:
            key, message = km.key, km.message
            if key == "UP":
                if self.model is None:
                    continue
                update = read_json(message)
                which, id_ = update[0], str(update[1])
                vector = np.asarray(update[2], dtype=np.float32)
                if which == "X":
                    self.model.set_user_vector(id_, vector)
                    if len(update) > 3 and not self.no_known_items:
                        self.model.add_known_items(id_, [str(i) for i in update[3]])
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
                    old = self.model
                    self.model = ALSServingModel(
                        features,
                        implicit,
                        sample_rate=self.sample_rate,
                        score_dtype=self.score_dtype,
                        shard_items=self.shard_items,
                        device_user_matrix=self.device_user_matrix,
                    )
                    self.model.set_expected(x_ids, y_ids)
                    if old is not None:
                        old.close()
                else:
                    self.model.retain_recent_and_user_ids(x_ids)
                    self.model.retain_recent_and_item_ids(y_ids)
                    self.model.retain_recent_and_known_items(
                        x_ids | set(self.model.all_user_ids())
                    )
                    self.model.set_expected(x_ids, y_ids)
            elif key == "INDEX-REF":
                # an IVF index generation: rebuild this replica's layout
                # seeded with the published centroids and swap it in; an
                # unusable ref is dropped (the local layout keeps serving)
                if self.model is not None:
                    try:
                        self.model.apply_index_generation(message)
                    except Exception:
                        log.warning(
                            "dropped unusable index generation %r", message, exc_info=True
                        )
            else:
                raise ValueError(f"bad key {key}")
            self._consumed += 1
            if self._consumed % 10_000 == 0:
                log.info("%s updates consumed; model: %r", self._consumed, self.model)

    def get_model(self) -> ALSServingModel | None:
        return self.model

    def close(self) -> None:
        model, self.model = self.model, None
        if model is not None:
            model.close()


def _load_rescorer_providers(config: Config):
    """Load the RescorerProvider chain from oryx.als.rescorer-provider-class."""
    names = config.get_optional_strings("oryx.als.rescorer-provider-class")
    if not names:
        return None
    from oryx_tpu_torch.app.als.rescorer import MultiRescorerProvider
    from oryx_tpu_torch.common.lang import load_instance_of

    providers = [load_instance_of(n) for n in names]
    if len(providers) == 1:
        return providers[0]
    return MultiRescorerProvider(providers)
