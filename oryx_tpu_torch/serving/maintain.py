"""Background IVF index maintenance (counterpart of
``oryx_tpu/serving/maintain.py``).

Fold-ins land in the IVF index's pending overlay; overflow spills the
oldest entries to ``pending_spill``, where they stay invisible until
compacted. ``IndexMaintainer`` snapshots the overlay + spill under the
model's cache lock, runs ``ivf.compact_ivf`` (cell split/merge, no
k-means retraining) off the request path, and installs the result with
one pointer swap, replaying any fold-ins that raced the compaction.

With a publish function attached, each compaction also writes an
**index generation**, ``<model-dir>/index/<gid>/`` holding
``index.json`` and ``centroids.npy`` (the JAX package's format, so either
package reads the other's), and sends its path as an ``INDEX-REF``
record on the update topic. Replicas rebuild their layout seeded with
the published centroids and swap it in; the model's own generation id
suppresses duplicates.

Config: ``oryx.serving.scan.ann.maintain.*``, applied by the serving
layer.
"""

from __future__ import annotations

import io
import json
import logging
import threading
import time

import numpy as np

from oryx_tpu_torch.common import ledger, metrics, storage

log = logging.getLogger(__name__)

# fold-in -> clustered-layout visibility lag, observed at each
# compaction for the oldest entry folded (worst case over the batch)
FRESHNESS_GAUGE = "serving.ann.freshness.seconds"

INDEX_REF_KEY = "INDEX-REF"
INDEX_DIR_NAME = "index"  # non-numeric: invisible to model-generation GC
INDEX_MANIFEST_NAME = "index.json"
INDEX_CENTROIDS_NAME = "centroids.npy"

# module knobs (oryx.serving.scan.ann.maintain.*), mirroring
# ops.ivf.configure_ann's style: set before the layer starts
MAINTAIN_ENABLED = False
MAINTAIN_INTERVAL_SEC = 5.0
MAINTAIN_WATERMARK = 0.5
MAINTAIN_SPLIT_MAX_ITEMS = 0  # 0 = auto (mean * 4)
MAINTAIN_MERGE_MIN_ITEMS = 0  # 0 = auto (mean / 8)
MAINTAIN_PUBLISH = False


def configure_maintain(
    enabled=None,
    interval_sec=None,
    watermark=None,
    split_max_items=None,
    merge_min_items=None,
    publish=None,
):
    """Set the maintenance-loop defaults (config:
    oryx.serving.scan.ann.maintain.*); None leaves a knob unchanged."""
    global MAINTAIN_ENABLED, MAINTAIN_INTERVAL_SEC, MAINTAIN_WATERMARK
    global MAINTAIN_SPLIT_MAX_ITEMS, MAINTAIN_MERGE_MIN_ITEMS, MAINTAIN_PUBLISH
    if enabled is not None:
        MAINTAIN_ENABLED = bool(enabled)
    if interval_sec is not None:
        MAINTAIN_INTERVAL_SEC = float(interval_sec)
    if watermark is not None:
        MAINTAIN_WATERMARK = float(watermark)
    if split_max_items is not None:
        MAINTAIN_SPLIT_MAX_ITEMS = int(split_max_items)
    if merge_min_items is not None:
        MAINTAIN_MERGE_MIN_ITEMS = int(merge_min_items)
    if publish is not None:
        MAINTAIN_PUBLISH = bool(publish)


def maintain_enabled() -> bool:
    return MAINTAIN_ENABLED


# -- index generations --------------------------------------------------------


def index_generation_dir(model_dir: str, generation_id: str) -> str:
    return storage.join(model_dir, INDEX_DIR_NAME, str(generation_id))


def write_index_generation(
    model_dir: str,
    index,
    *,
    generation_id: str | None = None,
    stats: dict | None = None,
) -> str:
    """Archive one compacted clustering under
    ``<model-dir>/index/<gid>/``: a JSON manifest + the centroid matrix
    ([n_cells, features] f32). The centroids ARE the clustering — a
    replica seeds ``build_ivf(mat, centroids=...)`` with them and gets
    the identical cell geometry over its own (replayed-to-parity) item
    store, so the artifact stays KBs even for 100M-item catalogs.
    Returns the generation dir path (the INDEX-REF payload)."""
    gid = str(generation_id) if generation_id else str(int(time.time() * 1000))
    d = index_generation_dir(model_dir, gid)
    storage.mkdirs(d)
    feat = int(index.features)
    cents = np.ascontiguousarray(index.centroids_t.cpu().numpy().T[:, :feat], np.float32)
    buf = io.BytesIO()
    np.save(buf, cents)
    storage.commit_bytes(storage.join(d, INDEX_CENTROIDS_NAME), buf.getvalue())
    manifest = {
        "generation_id": gid,
        "created_at": time.time(),
        "n_cells": int(cents.shape[0]),
        "features": feat,
        "n_items": int(index.n_items),
    }
    if stats:
        manifest["compaction"] = {
            k: int(stats[k])
            for k in ("folded", "live", "splits", "merges")
            if k in stats
        }
    storage.commit_text(storage.join(d, INDEX_MANIFEST_NAME), json.dumps(manifest))
    return d


def read_index_generation(ref: str) -> tuple[str, dict, np.ndarray] | None:
    """(generation_id, manifest, centroids) from an INDEX-REF dir, or
    None when the ref is unreadable / malformed."""
    try:
        manifest = json.loads(storage.read_text(storage.join(ref, INDEX_MANIFEST_NAME)))
        with storage.open_read(storage.join(ref, INDEX_CENTROIDS_NAME)) as f:
            cents = np.load(f)
        gid = str(manifest.get("generation_id") or ref.rstrip("/").split("/")[-1])
        return gid, manifest, np.ascontiguousarray(cents, np.float32)
    except Exception:
        log.warning("unreadable index generation at %r", ref, exc_info=True)
        return None


class IndexMaintainer:
    """Background incremental ANN compaction for one serving model.

    The owning side (the serving layer, or a test driving ``run_once``)
    wires it to any model exposing the maintenance protocol:

    - ``maintenance_snapshot(watermark, force)`` -> ``(index, snapshot)``
      or None when there is nothing to do
    - ``install_compacted(new_index, stats)`` -> bool (False = a full
      rebuild superseded the snapshot; the result is discarded)
    - ``set_index_pressure_callback(cb)`` (optional): called when a
      fold-in batch crosses the overlay watermark or spills, waking the
      loop ahead of its interval — the degrade path's freshness bound

    Compaction runs entirely off the request path: the snapshot and the
    install are brief critical sections; the split/merge clustering work
    happens between them on this thread.
    """

    def __init__(
        self,
        model_source,
        *,
        interval_sec: float | None = None,
        watermark: float | None = None,
        split_max_items: int | None = None,
        merge_min_items: int | None = None,
        publish_fn=None,
        seed: int = 0,
    ) -> None:
        # model_source: zero-arg callable returning the current model (or
        # None) — rotation swaps models, the maintainer follows along
        self._model_source = model_source
        self.interval_sec = (
            MAINTAIN_INTERVAL_SEC if interval_sec is None else float(interval_sec)
        )
        self.watermark = MAINTAIN_WATERMARK if watermark is None else float(watermark)
        self.split_max_items = (
            MAINTAIN_SPLIT_MAX_ITEMS if split_max_items is None else int(split_max_items)
        )
        self.merge_min_items = (
            MAINTAIN_MERGE_MIN_ITEMS if merge_min_items is None else int(merge_min_items)
        )
        # publish_fn(index, stats) -> generation dir: archives + sends the
        # INDEX-REF (serving layer wires this to its registry + producer)
        self._publish_fn = publish_fn
        self._seed = int(seed)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._attached: set[int] = set()  # models already given the callback
        self.compactions = 0
        self.published = 0
        self.last_stats: dict | None = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="ann-index-maintainer", daemon=True
        )
        self._thread.start()
        ledger.register("thread", self._thread, live=threading.Thread.is_alive)

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=10.0)

    def note_pressure(self) -> None:
        """Fold-in pressure signal: wake the loop ahead of the interval
        (called by the model under its cache lock — just an Event set)."""
        self._wake.set()

    # -- the loop -------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            # hook the CURRENT model before sleeping so fold-in pressure
            # can wake us ahead of the interval from the very first batch
            # (and again after every rotation swap)
            try:
                model = self._model_source()
                if model is not None:
                    self._hook_model(model)
            except Exception:  # pragma: no cover - defensive
                pass
            self._wake.wait(timeout=self.interval_sec)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.run_once()
            except Exception:
                # maintenance must never take serving down; the next tick
                # retries against fresh state
                log.warning("index maintenance pass failed", exc_info=True)
                metrics.registry.counter("serving.ann.maintain.errors").inc()

    def _hook_model(self, model) -> None:
        cb = getattr(model, "set_index_pressure_callback", None)
        if cb is None:
            return
        key = id(model)
        if key in self._attached:
            return
        cb(self.note_pressure)
        self._attached.add(key)
        if len(self._attached) > 64:  # rotation churn: ids are not stable
            self._attached = {key}

    def run_once(self, force: bool = False) -> dict | None:
        """One maintenance pass: snapshot -> compact -> install ->
        publish. Returns the compaction stats dict when a pass ran and
        installed, None otherwise (nothing pending, or a full rebuild
        raced the snapshot and won). Tests drive this directly."""
        model = self._model_source()
        if model is None:
            return None
        self._hook_model(model)
        snap_fn = getattr(model, "maintenance_snapshot", None)
        if snap_fn is None:
            return None
        work = snap_fn(watermark=self.watermark, force=force)
        if work is None:
            return None
        index, snapshot = work
        from oryx_tpu_torch.ops import ivf as ivf_ops

        t0 = time.monotonic()
        new_index, stats = ivf_ops.compact_ivf(
            index,
            snapshot,
            seed=self._seed + self.compactions,
            split_max_items=self.split_max_items,
            merge_min_items=self.merge_min_items,
        )
        # with tiering on, the compacted index's host plane moves into a
        # fresh cell store, in a directory of its own; the replaced plane
        # closes itself (store, spill file, directory) when its last
        # index handle goes, the point where the JAX package's store
        # drops its file: a scan in flight may still hold the old handle
        new_index = ivf_ops.attach_tiered_plane(new_index)
        stats["compact_seconds"] = time.monotonic() - t0
        if not model.install_compacted(new_index, stats):
            log.info("compaction discarded: a full rebuild superseded the snapshot")
            return None
        self.compactions += 1
        self.last_stats = stats
        born = stats.get("born") or {}
        if born:
            # worst-case fold-in -> clustered-visibility lag this pass
            lag = max(0.0, time.time() - min(born.values()))
            metrics.registry.gauge(FRESHNESS_GAUGE).set(lag)
        metrics.registry.counter("serving.ann.maintain.compactions").inc()
        if self._publish_fn is not None and stats.get("folded", 0):
            try:
                ref = self._publish_fn(new_index, stats)
                self.published += 1
                # the publisher consumes its own INDEX-REF off the topic;
                # marking the generation here dedups that self-delivery
                note = getattr(model, "note_published_index", None)
                if note is not None and ref:
                    note(str(ref).rstrip("/").split("/")[-1])
            except Exception:
                log.warning("index generation publish failed", exc_info=True)
                metrics.registry.counter("serving.ann.maintain.publish-errors").inc()
        return stats
