"""Shared layer base: config parsing, topic init, input consumption.

Rebuild of AbstractSparkLayer (framework/oryx-lambda/.../AbstractSparkLayer
.java:57-254): parses id/topics/interval from config, builds the input
stream starting from stored group offsets (the reference reads them from
ZooKeeper; here from the bus's offset ledger).

Port note: a copy of ``oryx_tpu/lambda_/base.py`` with its imports pointed at
``oryx_tpu_torch``. ``oryx.batch.compute.distributed.*`` joins a
``torch.distributed`` run, and ``oryx.compute.compile-cache-dir`` is where
the kernels are built and loaded (``parallel/distributed.py``).
"""

from __future__ import annotations

import logging
import threading
from typing import Iterator

from oryx_tpu_torch.bus.core import Broker, KeyMessage, TopicConsumer, get_broker
from oryx_tpu_torch.common import ledger, metrics
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.resilience import RetryPolicy, SupervisedThread

log = logging.getLogger(__name__)

# empty polls in a row that end a drain short of the input topic's end
DRAIN_EMPTY_POLLS = 100


def behind(positions: dict[int, int], end: dict[int, int]) -> bool:
    """Whether a consumer at ``positions`` is short of ``end`` on any of
    its partitions. A poll lost in flight (a fault+ bus's drop, which
    rewinds) comes back empty while records remain: a drain polls again
    while its consumer is behind the end it took at its start, at most
    DRAIN_EMPTY_POLLS empty polls in a row."""
    return any(pos < end.get(p, 0) for p, pos in positions.items())

class AbstractLayer:
    def __init__(self, config: Config, layer_name: str) -> None:
        self.config = config
        self.layer_name = layer_name
        self.id = config.get_optional_string("oryx.id")
        self.input_broker_loc = config.get_string("oryx.input-topic.broker")
        self.input_topic = config.get_string("oryx.input-topic.message.topic")
        self.input_partitions = config.get_optional_int("oryx.input-topic.message.partitions") or 1
        self.update_broker_loc = config.get_optional_string("oryx.update-topic.broker")
        self.update_topic = config.get_optional_string("oryx.update-topic.message.topic")
        self.update_partitions = config.get_optional_int("oryx.update-topic.message.partitions") or 1
        self.generation_interval_sec = config.get_int(
            f"oryx.{layer_name}.streaming.generation-interval-sec"
        )
        # consumer group: "OryxGroup-<LayerName>[-<id>]"
        # (AbstractSparkLayer.java:108-116); without oryx.id there is no
        # durable identity so offsets are not persisted and consumption
        # starts at latest (reference.conf:14-20 comment).
        self.group_id = f"OryxGroup-{layer_name}" + (f"-{self.id}" if self.id else "")
        self._stop_event = threading.Event()
        self._input_broker: Broker | None = None
        self._update_broker: Broker | None = None
        # resilience: every long-lived thread in a layer runs supervised
        # (restart with backoff under oryx.<layer>.retry.*, give up after
        # max-attempts consecutive failures -> the layer reports unhealthy)
        self.retry_policy = RetryPolicy.from_config(config, f"oryx.{layer_name}.retry")
        self._supervised: list[SupervisedThread] = []
        # multi-process: join the run before any device is touched, so
        # the scoped devices span every rank (no-op unless
        # oryx.batch.compute.distributed.* is configured)
        from oryx_tpu_torch.parallel.distributed import (
            maybe_enable_compile_cache,
            maybe_initialize,
        )

        maybe_initialize(config)
        maybe_enable_compile_cache(config)

    # -- topics -------------------------------------------------------------

    def input_broker(self) -> Broker:
        # one broker handle per layer: a file broker is cheap to rebuild,
        # but tcp:// holds a live socket and kafka:// a client with
        # metadata — per-micro-batch reconstruction would churn a
        # connection (and defeat producer batching) every generation
        if self._input_broker is None:
            self._input_broker = get_broker(self.input_broker_loc)
        return self._input_broker

    def input_end(self) -> dict[int, int]:
        """The input topic's end offsets now, or {} where the broker cannot
        say (a drain then ends at its first empty poll)."""
        try:
            return dict(self.input_broker().latest_offsets(self.input_topic))
        except Exception:  # noqa: BLE001 - a best-effort bound
            return {}

    def update_broker(self) -> Broker | None:
        if self.update_broker_loc and self.update_topic:
            if self._update_broker is None:
                self._update_broker = get_broker(self.update_broker_loc)
            return self._update_broker
        return None

    def init_topics(self) -> None:
        """Create topics if missing (the reference delegates this to
        `oryx-run.sh kafka-setup`; layers here do it on startup for
        operational simplicity)."""
        self.input_broker().create_topic(self.input_topic, self.input_partitions)
        ub = self.update_broker()
        if ub is not None:
            ub.create_topic(self.update_topic, self.update_partitions)

    def make_input_consumer(self, partitions: list[int] | None = None) -> TopicConsumer:
        """Input consumer resuming from stored offsets when oryx.id is set
        (AbstractSparkLayer.buildInputDStream:179-252). `partitions`
        restricts the consumer to a subset of input partitions (the sharded
        speed-pipeline path); commits of disjoint subsets merge in the
        offset ledger, so shards sharing a group never clobber each other."""
        return self.input_broker().consumer(
            self.input_topic,
            group=self.group_id if self.id else None,
            partitions=partitions,
        )

    # -- lifecycle ----------------------------------------------------------

    def maybe_start_ui(self) -> None:
        """Status/metrics HTTP endpoint on ``oryx.<layer>.ui.port`` (the
        reference exposes the Spark UI on these ports, reference.conf
        batch/speed ui.port; here it serves the metrics registry and a
        one-line status as JSON). No-op when the port is null."""
        port = self.config.get(f"oryx.{self.layer_name}.ui.port", None)
        if (
            port is None
            or getattr(self, "_ui_server", None) is not None
            or getattr(self, "_ui_thread", None) is not None
        ):
            return
        # loopback by default: the endpoint has no auth (the reference's
        # Spark UI bound 0.0.0.0 unauthenticated; metrics scrapers that
        # need remote access opt in via ui.bind-address)
        host = self.config.get(f"oryx.{self.layer_name}.ui.bind-address", None) or "127.0.0.1"
        import json as _json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from oryx_tpu_torch.common import metrics as _metrics

        layer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib contract
                if self.path not in ("/", "/metrics", "/status", "/healthz"):
                    self.send_error(404)
                    return
                healthy = layer.healthy()
                if self.path == "/healthz":
                    body = {"healthy": healthy, "layer": layer.layer_name}
                    status = 200 if healthy else 503
                else:
                    if ledger.enabled():
                        ledger.ledger.refresh()
                    body = dict(_metrics.registry.snapshot())
                    body["layer"] = {
                        "type": "status",
                        "name": layer.layer_name,
                        "id": layer.id,
                        "stopped": layer.is_stopped(),
                        "healthy": healthy,
                    }
                    status = 200
                data = _json.dumps(body, indent=1).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):  # quiet: it's a metrics scrape target
                pass

        srv = ThreadingHTTPServer((host, int(port)), Handler)
        self._ui_server = srv
        self.ui_port = srv.server_address[1]  # resolved (port 0 = ephemeral)
        t = threading.Thread(target=srv.serve_forever, name=f"{self.layer_name}-ui", daemon=True)
        self._ui_thread = t
        t.start()
        ledger.register("thread", t, live=threading.Thread.is_alive)

    def supervise(
        self, name: str, target, *, loop: bool = False, metrics_prefix: str | None = None,
        on_failure=None,
    ) -> SupervisedThread:
        """Start a supervised daemon thread under this layer's retry
        policy; it counts toward `healthy()`."""
        t = SupervisedThread(
            name,
            target,
            self.retry_policy,
            self._stop_event,
            loop=loop,
            metrics_prefix=metrics_prefix or f"{self.layer_name}.{name}",
            on_failure=on_failure,
        )
        self._supervised.append(t)
        t.start()
        return t

    def healthy(self) -> bool:
        """False once any supervised thread has exhausted its restart
        policy and given up."""
        return all(t.healthy for t in self._supervised)

    def is_stopped(self) -> bool:
        return self._stop_event.is_set()

    def await_termination(self, timeout: float | None = None) -> None:
        self._stop_event.wait(timeout)

    def join_or_report_leak(self, *threads, timeout: float = 10.0) -> None:
        """Join each thread; one that outlives the timeout is logged and
        counted in `layer.threads.leaked` instead of silently abandoned."""
        for t in threads:
            if t is None:
                continue
            t.join(timeout=timeout)
            if t.is_alive():
                name = getattr(t, "name", repr(t))
                log.warning(
                    "%s layer thread %r still alive after %.0fs join; leaking it",
                    self.layer_name, name, timeout,
                )
                metrics.registry.counter("layer.threads.leaked").inc()

    def close(self) -> None:
        self._stop_event.set()
        srv = getattr(self, "_ui_server", None)
        if srv is not None:
            srv.shutdown()
            srv.server_close()
            self._ui_server = None
        t = getattr(self, "_ui_thread", None)
        if t is not None:
            self._ui_thread = None
            self.join_or_report_leak(t)


def blocking_iterator(consumer: TopicConsumer, stop_event: threading.Event) -> Iterator[KeyMessage]:
    """Endless KeyMessage iterator over a consumer, ending on close/stop."""
    while not stop_event.is_set() and not consumer.closed():
        for rec in consumer.poll(timeout=0.2):
            yield rec


class GuardedBlockFeed:
    """A restartable block feed with poison-message quarantine.

    Wraps a consumer for use under a SupervisedThread: call `blocks()` for
    a FRESH generator on every (re)start, and `record_failure` from the
    supervisor's failure hook. A block that was mid-consume when the
    manager raised is retried on restart; after `max_failures` failures of
    the SAME block it is published to the dead-letter topic instead and
    the stream moves on. A failure with no block in flight (the poll
    itself raised — broker outage) is not counted against any block.
    """

    def __init__(
        self,
        consumer: TopicConsumer,
        stop_event: threading.Event,
        max_failures: int,
        dead_letter,
        on_block=None,
    ) -> None:
        self._consumer = consumer
        self._stop_event = stop_event
        self._max_failures = max(1, max_failures)
        self._dead_letter = dead_letter  # callable(block) -> None
        self._on_block = on_block  # callable(block) after each successful poll
        self._in_flight = None
        self._pending_retry = None
        self._failures = 0

    def blocks(self):
        """A fresh generator; an abandoned predecessor (after a failure)
        holds no state — everything lives on the feed object."""
        while not self._stop_event.is_set() and not self._consumer.closed():
            if self._pending_retry is not None:
                block = self._pending_retry
                self._pending_retry = None
            else:
                block = self._consumer.poll_block(max_records=10_000, timeout=0.2)
                if block is None:
                    continue
                if self._on_block is not None:
                    self._on_block(block)
            self._in_flight = block
            yield block
            # reaching here means the manager pulled the next block: the
            # previous one was fully consumed (on a failure the generator
            # is abandoned at the yield and these lines never run)
            self._in_flight = None
            self._failures = 0

    def record_failure(self, exc: BaseException) -> None:
        """Supervisor failure hook (same thread as the consume loop)."""
        block = self._in_flight
        self._in_flight = None
        if block is None:
            return  # poll-side failure; nothing to quarantine
        self._failures += 1
        if self._failures >= self._max_failures:
            self._failures = 0
            log.error(
                "block of %d update record(s) failed consume %d times (%s); dead-lettering",
                len(block), self._max_failures, exc,
            )
            try:
                self._dead_letter(block)
            except Exception:  # noqa: BLE001 - a DL failure must not kill the stream
                log.exception("dead-letter publish failed; block lost")
        else:
            self._pending_retry = block


def blocking_block_iterator(consumer: TopicConsumer, stop_event: threading.Event):
    """Endless RecordBlock iterator over a consumer (columnar poll),
    ending on close/stop. The high-rate twin of blocking_iterator: model
    consumers that can apply whole blocks at once (vectorized UP parsing)
    drain the update topic without per-record decoding."""
    while not stop_event.is_set() and not consumer.closed():
        block = consumer.poll_block(max_records=10_000, timeout=0.2)
        if block is not None:
            yield block
