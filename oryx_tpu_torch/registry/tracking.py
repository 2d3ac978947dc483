"""Serving-side generation tracking and duplicate-MODEL suppression.

The serving layer replays the update topic from offset 0 and then follows
it live. Every MODEL / MODEL-REF record that flows past carries its
generation identity — a ``generation`` Extension inside inline PMML, the
generation dir name inside a ref — and this tracker watches the stream to
answer "which generation is live right now?" for /healthz, /metrics, and
the ``models``/``health`` CLI probes.

It also makes the stream idempotent per generation: an at-least-once bus
(and the fault+ chaos wrapper deliberately) can deliver the same MODEL
twice, and without suppression the second delivery would re-trigger a
full model swap and skew the staleness clock. A record whose generation
equals the *current* live generation is filtered out of the block before
the model manager sees it. Only the current generation is deduped — a
rollback republish of an *older* generation changes the id and passes
through, which is exactly what rollback needs.

Records without a parseable generation (legacy inline PMML, foreign
paths) pass through untouched and reset tracking to "unknown" — never
dropped, so a registry-less producer keeps working.

With online experiments attached (``oryx.serving.ab``, docs/
experiments.md) the tracker holds TWO generations at once: the live
(champion) one and a challenger. A new-generation MODEL record is
classified against the registry's CHAMPION pointer — it becomes the
challenger when the pointer names a different generation (the online
gate published it without moving the pointer), and a live swap
otherwise (bootstrap, rollback republish, or an offline-promoted
generation). Duplicate suppression covers both ids, and a champion
swap mid-experiment keeps the challenger in place.

Port note: a copy of ``oryx_tpu/registry/tracking.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``. The serving layer attaches its
``ExperimentCoordinator`` when ``oryx.serving.ab.fraction`` is above 0,
which brings the challenger half into play as in the JAX package.
"""

from __future__ import annotations

import logging

import numpy as np

from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.common.records import RecordBlock
from oryx_tpu_torch.registry.manifest import GENERATION_EXTENSION
from oryx_tpu_torch.registry.store import generation_id_from_ref

log = logging.getLogger(__name__)

_MODEL_KEYS = (b"MODEL", b"MODEL-REF")
_INDEX_KEY = b"INDEX-REF"

LIVE_GENERATION_GAUGE = "serving.model.live-generation"
CHALLENGER_GENERATION_GAUGE = "serving.model.challenger-generation"
DUPLICATES_COUNTER = "serving.model.duplicates-suppressed"
FLEET_SKEW_GAUGE = "serving.model.generation-skew"
INDEX_GENERATION_GAUGE = "serving.index.generation"


def record_fleet_skew(live_generations) -> int:
    """Generation skew across a fleet of serving replicas: the number of
    *extra* distinct generations live at once (0 = every replica that has
    a model agrees). Replicas that have not yet resolved a generation
    (None) don't count as skew — they are catching up, not disagreeing.
    Published as the ``serving.model.generation-skew`` gauge; the fleet
    driver (tools/fleet.py) polls replica /healthz bodies and records the
    skew each sample, and the rotation-under-load test asserts it returns
    to 0 after a rotation settles."""
    gens = {g for g in live_generations if g is not None}
    skew = max(0, len(gens) - 1)
    metrics.registry.gauge(FLEET_SKEW_GAUGE).set(skew)
    return skew


def generation_of_model_message(key: str, message: str) -> str | None:
    """The generation id a MODEL / MODEL-REF record carries, if any."""
    if key == "MODEL":
        try:
            from oryx_tpu_torch.app import pmml as app_pmml
            from oryx_tpu_torch.common import pmml as pmml_io

            return app_pmml.get_extension_value(
                pmml_io.from_string(message), GENERATION_EXTENSION
            )
        except Exception:
            return None
    if key == "MODEL-REF":
        return generation_id_from_ref(message)
    return None


class GenerationTracker:
    """Tracks the live generation over a stream of update RecordBlocks and
    filters duplicate deliveries of the live generation's MODEL record."""

    def __init__(self, health=None, experiments=None) -> None:
        self.live_generation: str | None = None
        self.challenger_generation: str | None = None
        # ANN index generations (serving/maintain.py) ride the same topic
        # as INDEX-REF records and get the same duplicate suppression —
        # an at-least-once redelivery must not re-trigger an index rebuild
        self.live_index_generation: str | None = None
        self._health = health
        # ExperimentCoordinator (or any object with wants_challenger /
        # on_challenger); None keeps the single-generation behavior
        self._experiments = experiments

    def _set_live(self, generation_id: str | None) -> None:
        self.live_generation = generation_id
        if self._health is not None:
            self._health.live_generation = generation_id
        if generation_id is not None and generation_id.isdigit():
            metrics.registry.gauge(LIVE_GENERATION_GAUGE).set(int(generation_id))

    def _set_challenger(self, generation_id: str | None) -> None:
        self.challenger_generation = generation_id
        if self._health is not None:
            self._health.challenger_generation = generation_id
        if generation_id is not None and generation_id.isdigit():
            metrics.registry.gauge(CHALLENGER_GENERATION_GAUGE).set(int(generation_id))
        if self._experiments is not None:
            self._experiments.on_challenger(generation_id)

    def _set_index(self, generation_id: str | None) -> None:
        self.live_index_generation = generation_id
        if self._health is not None:
            self._health.live_index_generation = generation_id
        if generation_id is not None and generation_id.isdigit():
            metrics.registry.gauge(INDEX_GENERATION_GAUGE).set(int(generation_id))

    def promote_challenger(self) -> None:
        """The online gate promoted the challenger: it becomes the live
        generation for all traffic on this replica."""
        generation = self.challenger_generation
        if generation is None:
            return
        self._set_challenger(None)
        self._set_live(generation)

    def drop_challenger(self) -> None:
        """The online gate refused the challenger: stop routing to it
        (the loaded model stays in the manager, unreferenced)."""
        self._set_challenger(None)

    def filter_block(self, block: RecordBlock | None) -> RecordBlock | None:
        """Apply tracking to one polled block; returns the block with
        duplicate live-generation MODEL records removed (None when nothing
        survives). Blocks without model records return unchanged — the
        no-model fast path is one vectorized key compare."""
        if block is None or len(block) == 0 or block.keys is None:
            return block
        keys = block.keys
        is_model = (keys == _MODEL_KEYS[0]) | (keys == _MODEL_KEYS[1])
        is_index = keys == _INDEX_KEY
        if not bool(is_model.any()) and not bool(is_index.any()):
            return block
        keep = np.ones(len(block), dtype=bool)
        msgs = block.messages
        for i in np.flatnonzero(is_index):
            message = msgs[i].decode("utf-8", "replace")
            generation = generation_id_from_ref(message)
            if generation is not None and generation == self.live_index_generation:
                keep[i] = False
                metrics.registry.counter(DUPLICATES_COUNTER).inc()
                log.info(
                    "suppressed duplicate INDEX-REF for index generation %s", generation
                )
            else:
                self._set_index(generation)
        for i in np.flatnonzero(is_model):
            key = keys[i].decode("utf-8", "replace")
            message = msgs[i].decode("utf-8", "replace")
            generation = generation_of_model_message(key, message)
            if generation is not None and generation == self.live_generation:
                keep[i] = False
                metrics.registry.counter(DUPLICATES_COUNTER).inc()
                log.info("suppressed duplicate %s for live generation %s", key, generation)
            elif generation is not None and generation == self.challenger_generation:
                keep[i] = False
                metrics.registry.counter(DUPLICATES_COUNTER).inc()
                log.info(
                    "suppressed duplicate %s for challenger generation %s", key, generation
                )
            elif (
                self._experiments is not None
                and generation is not None
                and self.live_generation is not None
                and self._experiments.wants_challenger(generation)
            ):
                # record still reaches the manager so the challenger
                # model is loaded and servable behind the arm router
                self._set_challenger(generation)
                log.info("tracking challenger generation %s (%s)", generation, key)
            else:
                self._set_live(generation)
        if bool(keep.all()):
            return block
        if not bool(keep.any()):
            return None
        return RecordBlock(
            keys[keep],
            msgs[keep],
            block.none_keys[keep] if block.none_keys is not None else None,
        )
