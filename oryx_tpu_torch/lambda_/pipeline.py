"""Pipelined speed-layer micro-batching: parse → fold → publish.

The monolithic ``run_one_batch`` serializes four phases — drain, parse,
fold, publish — so the fold solve (the only phase that can use the
accelerator) idles while text is split and bus bytes move, and vice
versa. This module runs the phases on three supervised workers joined by
bounded hand-off queues:

  stage 1  drain + parse    input bus → RatingMatrix (model-independent)
  stage 2  fold             RatingMatrix → update messages (the solve)
  stage 3  publish + commit update bus write, then offset commit

Backpressure is structural: each queue holds at most
``oryx.speed.pipeline.queue-depth`` batches and ``put`` blocks, so a slow
fold stalls the parse stage (and, through the consumer, the bus — the
shm ring's guard does the same one level down) instead of buffering
without bound.

At-least-once is preserved by construction: stage 1 snapshots the
consumer's positions when it finishes a drain, and ONLY stage 3 — after
the publish succeeded — writes them to the offset ledger
(``broker.set_offsets``). A crash anywhere between drain and commit
replays the batch; nothing is ever committed ahead of its updates. The
consumer itself is never ``commit()``-ed from the pipeline.

A batch whose fold raises is re-queued at the head of the parse→fold
queue (order preserved) and retried up to ``_FOLD_MAX_ATTEMPTS`` times;
then it is dropped with ``speed.pipeline.fold-dropped`` counting the
lost events — the pipelined analogue of the dead-letter quarantine.

Managers exposing the staged API (``parse_batch``/``fold_parsed``, e.g.
ALSSpeedModelManager) parse on stage 1; for anything else stage 1
materializes the drained blocks (transport views don't survive the
hand-off) and stage 2 calls plain ``build_updates``.

Sharding (``oryx.speed.pipeline.shards``, clamped to the input topic's
partition count): the pipeline is replicated into N independent
parse→fold→publish chains, shard s owning input partitions
``p % shards == s`` through a manually-assigned consumer. Each shard has
its own hand-off queues, commits ONLY its own partitions' offsets after
its own publish (the ledger merges disjoint subsets), and keeps the
retry/drop fold semantics per shard. Where the platform allows
(``pin-cores``, Linux with >1 CPU), a shard's three workers are pinned
to one core, round-robin over the allowed set, so shards scale across
cores instead of timeslicing one. With shards == 1 the behavior — thread
names, the layer-owned consumer, commit path — is exactly the unsharded
pipeline.

Port note: a copy of ``oryx_tpu/lambda_/pipeline.py`` (JAX-free), with its
imports pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from oryx_tpu_torch.common import metrics, tracing
from oryx_tpu_torch.common.records import BlockRecords

log = logging.getLogger(__name__)

_FOLD_MAX_ATTEMPTS = 3


class HandoffQueue:
    """A bounded stage-to-stage hand-off: blocking ``put`` (backpressure),
    timeout ``get``, and ``unget`` to return an item to the HEAD for an
    in-order retry. ``unget`` may exceed the bound by one — a retrying
    stage must never deadlock against its own upstream."""

    def __init__(self, depth: int) -> None:
        if depth < 1:
            raise ValueError("queue depth must be >= 1")
        self._depth = depth
        self._items: list = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def put(self, item, stop_event: threading.Event | None = None) -> bool:
        """Append; blocks while full. Returns False if stopped first."""
        with self._not_full:
            while len(self._items) >= self._depth:
                if stop_event is not None and stop_event.is_set():
                    return False
                self._not_full.wait(0.1)
            self._items.append(item)
            self._not_empty.notify()
            return True

    def get(self, timeout: float = 0.2):
        """Pop the head, or None after ``timeout`` with nothing queued."""
        deadline = time.monotonic() + timeout
        with self._not_empty:
            while not self._items:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
            item = self._items.pop(0)
            self._not_full.notify()
            return item

    def unget(self, item) -> None:
        """Put back at the head (retry without reordering)."""
        with self._not_empty:
            self._items.insert(0, item)
            self._not_empty.notify()


class _Shard:
    """One parse→fold→publish chain: its queues, its consumer (None in
    single-shard mode, where the layer-owned consumer is used), and the
    CPU its three workers pin to (None = no pinning)."""

    __slots__ = ("index", "consumer", "parsed", "folded", "cpu")

    def __init__(self, index: int, consumer, depth: int, cpu: int | None) -> None:
        self.index = index
        self.consumer = consumer
        self.parsed = HandoffQueue(depth)
        self.folded = HandoffQueue(depth)
        self.cpu = cpu


class SpeedPipeline:
    """The supervised stages, owned by a :class:`SpeedLayer`.

    Threads run under the layer's retry policy and count toward
    ``layer.healthy()``; the layer's stop event stops all of them.
    """

    def __init__(self, layer) -> None:
        self._layer = layer
        config = layer.config
        self._depth = config.get_optional_int("oryx.speed.pipeline.queue-depth") or 2
        min_batch_ms = config.get_optional_int("oryx.speed.pipeline.min-batch-ms")
        self._min_batch_sec = (200 if min_batch_ms is None else min_batch_ms) / 1000.0
        manager = layer.manager
        self._staged = hasattr(manager, "parse_batch") and hasattr(
            manager, "fold_parsed"
        )
        self._fold_takes_shard = False
        if self._staged:
            import inspect

            try:
                self._fold_takes_shard = (
                    "shard" in inspect.signature(manager.fold_parsed).parameters
                )
            except (TypeError, ValueError):
                pass
        shards = config.get_optional_int("oryx.speed.pipeline.shards") or 1
        nparts = max(1, layer.input_partitions)
        if shards > nparts:
            log.warning(
                "clamping oryx.speed.pipeline.shards=%d to the input topic's "
                "%d partition(s)", shards, nparts,
            )
            shards = nparts
        self.shards = max(1, shards)
        cpus: list[int] = []
        if self.shards > 1 and config.get_bool("oryx.speed.pipeline.pin-cores"):
            try:
                cpus = sorted(os.sched_getaffinity(0))
            except AttributeError:  # non-Linux
                cpus = []
            if len(cpus) < 2:
                cpus = []
        # tells a worker thread whether it already pinned itself (the pin
        # syscall is per-thread; doing it once beats once per loop)
        self._tls = threading.local()
        if self.shards > 1 and hasattr(manager, "configure_sharding"):
            manager.configure_sharding(self.shards)
        # consumers owned by the pipeline (sharded mode only); the layer
        # closes them alongside its own
        self.shard_consumers: list = []
        self._shards: list[_Shard] = []
        for s in range(self.shards):
            consumer = None
            if self.shards > 1:
                parts = [p for p in range(nparts) if p % self.shards == s]
                consumer = layer.make_input_consumer(partitions=parts)
                self.shard_consumers.append(consumer)
            cpu = cpus[s % len(cpus)] if cpus else None
            self._shards.append(_Shard(s, consumer, self._depth, cpu))
        self.threads: list = []

    def start(self) -> None:
        layer = self._layer
        multi = self.shards > 1
        self.threads = []
        for sh in self._shards:
            suffix = f"-{sh.index}" if multi else ""
            self.threads += [
                layer.supervise(
                    f"SpeedPipelineParse{suffix}",
                    lambda sh=sh: self._parse_step(sh), loop=True,
                    metrics_prefix="speed.pipeline.parse",
                ),
                layer.supervise(
                    f"SpeedPipelineFold{suffix}",
                    lambda sh=sh: self._fold_step(sh), loop=True,
                    metrics_prefix="speed.pipeline.fold",
                ),
                layer.supervise(
                    f"SpeedPipelinePublish{suffix}",
                    lambda sh=sh: self._publish_step(sh), loop=True,
                    metrics_prefix="speed.pipeline.publish",
                ),
            ]
        log.info(
            "speed pipeline started: shards=%d depth=%d min-batch=%.0fms "
            "staged=%s pinned=%s",
            self.shards, self._depth, self._min_batch_sec * 1000, self._staged,
            any(sh.cpu is not None for sh in self._shards),
        )

    def _pin(self, shard: _Shard) -> None:
        """Pin the calling worker to its shard's core, once per thread."""
        if shard.cpu is None or getattr(self._tls, "pinned", False):
            return
        self._tls.pinned = True
        try:
            os.sched_setaffinity(0, {shard.cpu})
        except OSError:  # cpuset changed under us; run unpinned
            log.warning("could not pin shard %d to cpu %d", shard.index, shard.cpu)

    # -- stage 1: drain + parse ---------------------------------------------

    def _parse_step(self, shard: _Shard) -> None:
        """Drain one accumulation window off the input bus and parse it.

        Transport blocks may be zero-copy views whose lifetime ends at the
        consumer's next poll; the consumer is pinned across the multi-poll
        drain and everything is copied out (parsed, or materialized) BEFORE
        the hand-off, so nothing downstream touches transport memory.
        """
        self._pin(shard)
        layer = self._layer
        consumer = shard.consumer if shard.consumer is not None else layer.input_consumer()
        limit = layer.max_batch_events
        deadline = time.monotonic() + self._min_batch_sec
        pin = getattr(consumer, "pin", None)
        if pin is not None:
            pin()
        t0 = time.time()
        try:
            blocks, total = layer.drain_input_blocks(
                limit, deadline=deadline, consumer=consumer
            )
            if total == 0:
                return
            # trace/freshness metadata rides the hand-off tuples so the
            # fold and publish stages (different threads, no ambient
            # context) can record their spans against the same trace
            from oryx_tpu_torch.lambda_.speed import batch_origin

            incoming_ctx, origin_ms = batch_origin(blocks)
            ingest_ms = origin_ms if origin_ms is not None else int(t0 * 1000)
            ctx = tracing.continue_from(incoming_ctx) or tracing.sample_root()
            meta = (
                ctx,
                incoming_ctx.span_id if incoming_ctx is not None else None,
                ingest_ms,
                t0,
            )
            positions = dict(consumer.positions())
            if self._staged:
                payload = layer.manager.parse_batch(BlockRecords(blocks))
            else:
                payload = BlockRecords(
                    [
                        b.materialize() if hasattr(b, "materialize") else b
                        for b in blocks
                    ]
                )
        finally:
            release = getattr(consumer, "release", None)
            if release is not None:
                release()
        if ctx is not None:
            tracing.record_span(
                "speed.parse", ctx.child(), ctx.span_id, t0,
                time.time() - t0, {"events": total, "blocks": len(blocks)},
            )
        shard.parsed.put((payload, total, positions, 0, meta), layer._stop_event)

    # -- stage 2: fold -------------------------------------------------------

    def _fold_step(self, shard: _Shard) -> None:
        self._pin(shard)
        item = shard.parsed.get(timeout=0.2)
        if item is None:
            return
        payload, total, positions, attempts, meta = item
        ctx = meta[0]
        t1 = time.time()
        try:
            with metrics.timed(metrics.registry.histogram("speed.batch.seconds")):
                if self._staged:
                    if self._fold_takes_shard:
                        result = self._layer.manager.fold_parsed(
                            payload, shard=shard.index
                        )
                    else:
                        result = self._layer.manager.fold_parsed(payload)
                else:
                    result = self._layer.manager.build_updates(payload)
                updates = list(result)
        except Exception:
            attempts += 1
            if attempts >= _FOLD_MAX_ATTEMPTS:
                metrics.registry.counter("speed.pipeline.fold-dropped").inc(total)
                log.exception(
                    "dropping batch of %d event(s) after %d failed fold(s)",
                    total, attempts,
                )
                return
            metrics.registry.counter("speed.pipeline.fold-retries").inc()
            shard.parsed.unget((payload, total, positions, attempts, meta))
            raise  # the supervisor logs, counts and backs off
        if ctx is not None:
            tracing.record_span(
                "speed.fold", ctx.child(), ctx.span_id, t1,
                time.time() - t1, {"events": total},
            )
        shard.folded.put(
            (updates, total, positions, meta), self._layer._stop_event
        )

    # -- stage 3: publish + commit -------------------------------------------

    def _publish_step(self, shard: _Shard) -> None:
        self._pin(shard)
        item = shard.folded.get(timeout=0.2)
        if item is None:
            return
        updates, total, positions, meta = item
        ctx, parent_span_id, ingest_ms, t0 = meta
        layer = self._layer
        ub = layer.update_broker()
        sent = 0
        t2 = time.time()
        if ub is not None and updates:
            records = [("UP", update) for update in updates]
            # the "@trc" header carries this trace + the batch's origin
            # timestamp onto the update topic (freshness chain)
            pub_ctx = ctx.child() if ctx is not None else None
            records, extra = tracing.with_header(records, pub_ctx, ingest_ms)
            with ub.producer(layer.update_topic) as producer:
                sent = layer.retry_policy.call(
                    lambda: producer.send_many(records),
                    retry_on=(ConnectionError, OSError),
                    metrics_prefix="speed.publish",
                    stop_event=layer._stop_event,
                ) - extra
            if ctx is not None:
                tracing.record_span(
                    "speed.publish", pub_ctx, ctx.span_id, t2,
                    time.time() - t2, {"updates": len(updates)},
                )
        # the at-least-once commit point: updates are on the bus, so the
        # drained range may now be marked consumed
        if layer.id and positions:
            layer.input_broker().set_offsets(
                layer.group_id, layer.input_topic, positions
            )
        metrics.registry.histogram("speed.freshness.seconds").observe(
            max(0.0, time.time() - ingest_ms / 1000.0)
        )
        if ctx is not None:
            tracing.record_span(
                "speed.batch", ctx, parent_span_id, t0,
                time.time() - t0, {"events": total, "updates": sent},
            )
        metrics.registry.counter("speed.events").inc(total)
        metrics.registry.counter("speed.updates").inc(sent)
        metrics.registry.counter(
            f"speed.pipeline.shard.{shard.index}.events"
        ).inc(total)
        layer.note_batch_published()
