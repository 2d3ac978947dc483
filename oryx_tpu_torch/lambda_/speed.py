"""Speed layer runtime.

Rebuild of SpeedLayer + SpeedLayerUpdate (framework/oryx-lambda/.../speed/
SpeedLayer.java:56-214, SpeedLayerUpdate.java:37-66; call stack §3.2):

- a dedicated thread consumes the update topic **from the beginning**
  (the replay-from-zero recovery story, SpeedLayer.java:107-121) feeding
  the configured SpeedModelManager.consume;
- every generation interval, the input micro-batch is handed to
  manager.build_updates and each returned delta is published to the update
  topic with key "UP".

Resilience (docs/resilience.md): both threads run supervised — restart
with backoff under ``oryx.speed.retry.*``, give up after max-attempts
consecutive failures and report the layer unhealthy. An update block that
repeatedly fails ``consume_blocks`` is quarantined to the dead-letter
topic instead of killing the consume thread, and delta publishes are
retried under the same policy.

Port note: a copy of ``oryx_tpu/lambda_/speed.py`` with its imports pointed
at ``oryx_tpu_torch``, but for one repair: a micro-batch without an
accumulation deadline drains to the input topic's end as of its start,
where the JAX package's ends at the first empty poll, which on a
``fault+`` bus is also a poll lost in flight (so its micro-batches there
take about ten polls each, one batch interval apart). The model manager must be one of the port's (a
name under ``oryx_tpu`` is refused), and the layer raises at construction
without CUDA unless the caller chose the CPU
(``oryx_tpu_torch.device.set_device("cpu")``), as the serving and batch
layers do. With ``oryx.speed.compute.profile-dir`` each micro-batch
writes a ``torch.profiler`` Chrome trace there (``common/profiling.py``).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

from oryx_tpu_torch.common.records import BlockRecords
from oryx_tpu_torch.common import metrics, profiling, tracing
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.crashpoints import crashpoint
from oryx_tpu_torch.common.lang import check_port_module, load_instance_of
from oryx_tpu_torch.device import default_device
from oryx_tpu_torch.lambda_.base import DRAIN_EMPTY_POLLS, AbstractLayer, GuardedBlockFeed, behind

log = logging.getLogger(__name__)


def batch_origin(blocks) -> tuple[tracing.TraceContext | None, int | None]:
    """(incoming sampled trace context, earliest origin ingest ms) merged
    across a drained micro-batch's transport-carried ``@trc`` headers: the
    first sampled context continues that trace through the batch's
    parse/fold/publish spans; the earliest stamped ``ts`` becomes the
    batch's origin for the freshness chain (re-stamped on the UP publish,
    so serving can observe event-ingest -> servable-visibility)."""
    ctx = None
    earliest = None
    for b in blocks:
        info = tracing.parse_header(getattr(b, "trace", None))
        if info is None:
            continue
        if ctx is None and info.ctx is not None and info.ctx.sampled:
            ctx = info.ctx
        if info.ingest_ms is not None:
            earliest = (
                info.ingest_ms
                if earliest is None
                else min(earliest, info.ingest_ms)
            )
    return ctx, earliest


def dead_letter_topic_for(config: Config) -> str:
    """The dead-letter topic name: oryx.update-topic.dead-letter.topic, or
    '<update topic>.dead-letter' when unset."""
    explicit = config.get_optional_string("oryx.update-topic.dead-letter.topic")
    if explicit:
        return explicit
    return config.get_string("oryx.update-topic.message.topic") + ".dead-letter"


class SpeedLayer(AbstractLayer):
    def __init__(self, config: Config) -> None:
        super().__init__(config, "speed")
        self.model_manager_class = config.get_string("oryx.speed.model-manager-class")
        self.max_batch_events = config.get_int("oryx.speed.streaming.max-batch-events")
        self.dead_letter_topic = dead_letter_topic_for(config)
        self.dead_letter_max_failures = (
            config.get_optional_int("oryx.update-topic.dead-letter.max-consume-failures") or 3
        )
        self.pipeline_enabled = bool(
            config.get("oryx.speed.pipeline.enabled", None)
        )
        check_port_module(self.model_manager_class, "oryx.speed.model-manager-class")
        default_device()  # the port's layers run on the card: fail now, not per batch
        self.manager = load_instance_of(self.model_manager_class, config)
        # guards _input_consumer/_batch_count: the supervised batch (or
        # pipeline publish) worker attaches the consumer and bumps the
        # counter while close()/batch_count read them from the caller's
        # thread (oryxlint lockset ORX102)
        self._state_lock = threading.Lock()
        self._input_consumer = None
        self._update_consumer = None
        self._consume_thread = None
        self._batch_thread = None
        self._pipeline = None
        self._batch_count = 0
        self._closed = False

    def prepare_input(self) -> None:
        """Attach the input consumer; from this point input is observed."""
        with self._state_lock:
            if self._input_consumer is None:
                self._input_consumer = self.make_input_consumer()

    def input_consumer(self):
        """The layer's input consumer, attaching it on first use."""
        self.prepare_input()
        with self._state_lock:
            return self._input_consumer

    def start(self) -> None:
        if self._update_consumer is not None:
            raise RuntimeError(
                "SpeedLayer.start() called twice: the live update consumer "
                "and worker threads would be overwritten and leak"
            )
        self.init_topics()
        self.maybe_start_ui()
        ub = self.update_broker()
        if ub is None:
            raise ValueError("speed layer requires an update topic")
        self._update_consumer = ub.consumer(self.update_topic, from_beginning=True)
        feed = GuardedBlockFeed(
            self._update_consumer,
            self._stop_event,
            self.dead_letter_max_failures,
            self._dead_letter,
        )
        self._consume_thread = self.supervise(
            "SpeedLayerUpdateConsumer",
            lambda: self.manager.consume_blocks(feed.blocks()),
            metrics_prefix="speed.consume",
            on_failure=feed.record_failure,
        )
        if self.pipeline_enabled:
            # pipelined micro-batching: parse/fold/publish on separate
            # supervised workers with bounded hand-off queues, replicated
            # per shard when oryx.speed.pipeline.shards > 1
            from oryx_tpu_torch.lambda_.pipeline import SpeedPipeline

            self._pipeline = SpeedPipeline(self)
            if self._pipeline.shards == 1:
                # sharded mode owns per-partition consumers instead; an
                # idle layer consumer would hold a zero-copy transport
                # guard forever and stall the ring
                self.prepare_input()
            self._pipeline.start()
        else:
            self.prepare_input()
            self._batch_thread = self.supervise(
                "SpeedLayer", self._one_interval, loop=True, metrics_prefix="speed.batch"
            )
        log.info(
            "SpeedLayer started: interval=%ss manager=%s pipeline=%s",
            self.generation_interval_sec,
            self.model_manager_class,
            self.pipeline_enabled,
        )

    def close(self) -> None:
        with self._state_lock:
            if self._closed:
                return  # idempotent: fleet drivers + atexit both call close
            self._closed = True
        super().close()
        with self._state_lock:
            input_consumer = self._input_consumer
        shard_consumers = self._pipeline.shard_consumers if self._pipeline else []
        for c in (input_consumer, self._update_consumer, *shard_consumers):
            if c is not None:
                c.close()
        pipeline_threads = self._pipeline.threads if self._pipeline else []
        self.join_or_report_leak(
            self._consume_thread, self._batch_thread, *pipeline_threads
        )
        self.manager.close()

    @property
    def batch_count(self) -> int:
        with self._state_lock:
            return self._batch_count

    def note_batch_published(self) -> None:
        """One micro-batch's updates are on the bus. Called by whichever
        worker owns the publish step — the fold loop here or the
        pipeline's publish stage — so the counter write stays under the
        layer's own lock (oryxlint caught the cross-object bare
        increment in pipeline.py as ORX103 once the attr was guarded)."""
        with self._state_lock:
            self._batch_count += 1

    # -- internals ----------------------------------------------------------

    def _dead_letter(self, block) -> None:
        """Publish a poison update block to the dead-letter topic with the
        original keys, so operators can inspect and replay it."""
        ub = self.update_broker()
        if ub is None:
            return
        ub.create_topic(self.dead_letter_topic, 1)
        records = [(km.key, km.message) for km in block.iter_key_messages()]
        with ub.producer(self.dead_letter_topic) as producer:
            n = producer.send_many(records)
        metrics.registry.counter("speed.deadletter.records").inc(n)
        log.warning("dead-lettered %d record(s) to %s", n, self.dead_letter_topic)

    def _one_interval(self) -> None:
        """One supervised micro-batch interval (wait, then batch)."""
        self._stop_event.wait(self.generation_interval_sec)
        if not self.is_stopped():
            self.run_one_batch()

    def run_one_batch(self) -> int:
        """Process one input micro-batch; returns updates published.
        Callable directly for deterministic tests."""
        try:
            return self._run_one_batch()
        except Exception:
            # operators alert on this (the loop's supervisor also logs it)
            metrics.registry.counter("speed.batch.failures").inc()
            raise

    def drain_input_blocks(
        self, limit: int, deadline: float | None = None, consumer=None
    ) -> tuple[list, int]:
        """Columnar input drain shared by the monolithic batch and the
        pipeline's parse stage: blocks of byte-string (or typed int)
        arrays, no per-record object construction — the input side of the
        100K events/s path. Without a deadline, the first empty poll ends
        the batch; with one, polling continues until the accumulation
        window closes (or ``limit`` is hit), so micro-batches stay large
        enough to amortize the fold solve. ``consumer`` overrides the
        layer-owned input consumer (the sharded pipeline drains its own
        partition-subset consumers)."""
        blocks: list = []
        total = 0
        if consumer is None:
            consumer = self.input_consumer()
        # without a deadline, an empty poll ends the batch once the
        # consumer has reached the topic's end as of now (base.behind)
        end = self.input_end() if deadline is None else {}
        empty = 0
        while total < limit and not self.is_stopped():
            timeout = 0.05
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                timeout = min(timeout, remaining)
            block = consumer.poll_block(
                max_records=min(10_000, limit - total), timeout=timeout
            )
            if block is None:
                if deadline is None:
                    empty += 1
                    if empty >= DRAIN_EMPTY_POLLS or not behind(consumer.positions(), end):
                        break
                continue
            empty = 0
            blocks.append(block)
            total += len(block)
        return blocks, total

    def _run_one_batch(self) -> int:
        consumer = self.input_consumer()
        # pin (if the transport supports it): zero-copy blocks must stay
        # valid across the multi-poll drain until build_updates has parsed
        # them; release() afterwards lets the transport reclaim
        pin = getattr(consumer, "pin", None)
        if pin is not None:
            pin()
        t0 = time.time()
        try:
            blocks, total = self.drain_input_blocks(self.max_batch_events)
            if total == 0:
                return 0
            # continue a sampled trace carried in on the input blocks, or
            # roll the sampling dice for a fresh per-micro-batch root; the
            # origin timestamp flows through to the UP publish regardless
            # of sampling (freshness is always-on)
            incoming_ctx, origin_ms = batch_origin(blocks)
            ingest_ms = origin_ms if origin_ms is not None else int(t0 * 1000)
            ctx = tracing.continue_from(incoming_ctx) or tracing.sample_root()
            if ctx is not None:
                tracing.record_span(
                    "speed.parse", ctx.child(), ctx.span_id, t0,
                    time.time() - t0,
                    {"events": total, "blocks": len(blocks)},
                )
            new_data = BlockRecords(blocks)
            with tracing.use(ctx) if ctx is not None else contextlib.nullcontext():
                with tracing.span("speed.fold", attrs={"events": total}):
                    with metrics.timed(
                        metrics.registry.histogram("speed.batch.seconds")
                    ):
                        with profiling.maybe_trace(
                            profiling.profile_dir_from_config(self.config, "speed"),
                            "speed-batch",
                        ):
                            updates = self.manager.build_updates(new_data)
        finally:
            release = getattr(consumer, "release", None)
            if release is not None:
                release()
        with tracing.use(ctx) if ctx is not None else contextlib.nullcontext():
            with metrics.timed(metrics.registry.histogram("speed.publish.seconds")):
                ub = self.update_broker()
                sent = 0
                if ub is not None:
                    with tracing.span(
                        "speed.publish", attrs={"updates": len(updates)}
                    ):
                        # each delta goes out with key "UP"
                        # (SpeedLayerUpdate.java:58-60); one batched publish
                        # per micro-batch so the bus pays one lock/write
                        # cycle, not one per delta. The publish retries
                        # under the layer policy (transient bus faults);
                        # materialized so a retry resends the same records
                        # (including the prepended "@trc" header carrying
                        # this trace + the batch's origin timestamp).
                        records = [("UP", update) for update in updates]
                        extra = 0
                        if records:
                            records, extra = tracing.with_header(
                                records, ingest_ms=ingest_ms
                            )
                        with ub.producer(self.update_topic) as producer:
                            sent = self.retry_policy.call(
                                lambda: producer.send_many(records),
                                retry_on=(ConnectionError, OSError),
                                metrics_prefix="speed.publish",
                                stop_event=self._stop_event,
                            ) - extra
                crashpoint("speed.commit.pre")
                if self.id:
                    self.input_consumer().commit()
                crashpoint("speed.commit.post")
        # the micro-batch's deltas are now servable-visible to any replica
        # that polls: event-ingest -> published, the speed half of the
        # freshness chain (serving closes it with serving.freshness.seconds)
        metrics.registry.histogram("speed.freshness.seconds").observe(
            max(0.0, time.time() - ingest_ms / 1000.0)
        )
        if ctx is not None:
            tracing.record_span(
                "speed.batch", ctx,
                incoming_ctx.span_id if incoming_ctx is not None else None,
                t0, time.time() - t0, {"events": total, "updates": sent},
            )
        metrics.registry.counter("speed.events").inc(total)
        metrics.registry.counter("speed.updates").inc(sent)
        self.note_batch_published()
        return sent
