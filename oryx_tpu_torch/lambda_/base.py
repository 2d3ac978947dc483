"""Shared layer base: config parsing, topic init, input consumption.

Rebuild of AbstractSparkLayer (framework/oryx-lambda/.../AbstractSparkLayer
.java:57-254): parses id/topics/interval from config, builds the input
stream starting from stored group offsets (the reference reads them from
ZooKeeper; here from the bus's offset ledger).

Port note: a copy of ``oryx_tpu/lambda_/base.py`` with its imports pointed at
``oryx_tpu_torch``, less the JAX multi-controller runtime and the XLA
compilation cache: a config that asks for either
(``oryx.batch.compute.distributed.*`` or its ``ORYX_*`` environment
variables, ``oryx.compute.compile-cache-dir``) raises NotYetPortedError. The
speed layer's feeds (``blocking_iterator``, ``GuardedBlockFeed``) come
with the speed layer.
"""

from __future__ import annotations

import logging
import os
import threading

from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch.bus.core import Broker, TopicConsumer, get_broker
from oryx_tpu_torch.common import ledger, metrics
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.resilience import RetryPolicy, SupervisedThread

log = logging.getLogger(__name__)

# settings of oryx_tpu/parallel/distributed.py: multi-process runs (A9)
_DISTRIBUTED_KEYS = ("coordinator-address", "num-processes", "process-id", "auto")
_DISTRIBUTED_ENV = ("ORYX_COORDINATOR", "ORYX_NUM_PROCESSES", "ORYX_PROCESS_ID")


def _refuse_unported_compute(config: Config) -> None:
    """Multi-process runs and the XLA compilation cache are not ported: a
    config that asks for either must not run as one process silently."""
    for key in _DISTRIBUTED_KEYS:
        if config.get(f"oryx.batch.compute.distributed.{key}", None) not in (None, False):
            raise NotYetPortedError(
                f"oryx.batch.compute.distributed.{key} is set, but multi-process "
                "runs are not yet ported to oryx_tpu_torch"
            )
    for var in _DISTRIBUTED_ENV:
        if os.environ.get(var):
            raise NotYetPortedError(
                f"${var} is set, but multi-process runs are not yet ported to oryx_tpu_torch"
            )
    if config.get("oryx.compute.compile-cache-dir", None):
        raise NotYetPortedError(
            "oryx.compute.compile-cache-dir is set, but the port has no compilation cache"
        )


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
        _refuse_unported_compute(config)

    # -- topics -------------------------------------------------------------

    def input_broker(self) -> Broker:
        # one broker handle per layer: a file broker is cheap to rebuild,
        # but tcp:// holds a live socket and kafka:// a client with
        # metadata — per-micro-batch reconstruction would churn a
        # connection (and defeat producer batching) every generation
        if self._input_broker is None:
            self._input_broker = get_broker(self.input_broker_loc)
        return self._input_broker

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

