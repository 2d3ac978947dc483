"""The serving layer process: HTTP server + model-manager lifecycle
(counterpart of ``oryx_tpu/serving/layer.py``, slimmed).

On start it creates the input-topic producer (unless read-only), loads
the configured ServingModelManager, starts a supervised daemon thread
replaying the update topic from the beginning into the manager, and
serves the registered resources over a pooled stdlib HTTP server with a
context path, gzip and ``/ready`` readiness gating. ``oryx.serving.scan.*``
reaches the batcher's scheduler and the scan before either starts.

The port runs on CUDA: constructing a layer raises when no CUDA device
is present, unless the caller chose the CPU
(``oryx_tpu_torch.device.set_device("cpu")``).

The batcher's queue is bounded by ``oryx.serving.overload.max-queue``;
a request that finds it full is answered 429 with ``Retry-After``
(``oryx.serving.overload.retry-after-s``), as in the JAX package.

``oryx.serving.scan.ann.*`` reaches the IVF tier (``ops/ivf.py``) and
``oryx.serving.scan.ann.maintain.*`` the background index maintainer
(``serving/maintain.py``), which ``start()`` runs when it is enabled and
``close()`` stops. With ``maintain.publish`` and a model dir
(``oryx.batch.storage.model-dir``), each compaction is written there as
an index generation and announced as ``INDEX-REF`` on the update topic,
through one lazily opened producer.

Not ported yet: tenancy and online experiments (a config that declares
enabled tenants or sets ``oryx.serving.ab.fraction`` above 0 is refused
at construction), the tiered item store (``oryx.serving.store.tier.enabled``
is refused at construction), the registry's routes and rollback,
MODEL-REF restage, the rest of overload control (the admission ladder),
the native HTTP front, TLS and auth (a config that sets a key file or credentials is
refused at construction), ``/healthz``, ``/readyz``, tracing export
routes and profiling. ``/metrics`` serves the metrics registry (with the
scan kernels' launch counts), without the JAX package's per-instance
and model-state entries.
"""

from __future__ import annotations

import gzip
import importlib
import logging
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlsplit

from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch.bus.core import get_broker
from oryx_tpu_torch.common import ledger, metrics, tracing
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.lang import check_port_module, load_instance_of
from oryx_tpu_torch.common.resilience import RetryPolicy, SupervisedThread
from oryx_tpu_torch.device import default_device
from oryx_tpu_torch.ops.ivf import refuse_tier_store
from oryx_tpu_torch.serving.batcher import BatcherOverloadedError
from oryx_tpu_torch.serving.web import (
    OryxServingException,
    Request,
    Response,
    Router,
    ServingContext,
    render,
    resource,
)

log = logging.getLogger(__name__)


class _PooledHTTPServer(HTTPServer):
    """HTTP server with a bounded worker pool: a worker owns a connection
    for its keep-alive lifetime; beyond `threads` concurrent connections,
    accepts queue. Accepted sockets get a read timeout, and live
    connections are tracked so server_close() unblocks every worker."""

    daemon_threads = True
    read_timeout = 30.0
    # listen backlog: the stdlib's 5 drops the SYNs of a burst of
    # concurrent clients, whose retransmits then add 1 s and 3 s
    request_queue_size = 128

    def __init__(self, addr, handler_cls, threads: int) -> None:
        super().__init__(addr, handler_cls)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, threads), thread_name_prefix="ServingWorker"
        )

    def process_request(self, request, client_address):
        self._pool.submit(self._work, request, client_address)

    def _work(self, request, client_address):
        try:
            request.settimeout(self.read_timeout)
            with self._conns_lock:
                self._conns.add(request)
            try:
                self.finish_request(request, client_address)
            except Exception:
                self.handle_error(request, client_address)
            finally:
                with self._conns_lock:
                    self._conns.discard(request)
        finally:
            self.shutdown_request(request)

    def server_close(self):
        super().server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._pool.shutdown(wait=True, cancel_futures=True)


def _import_recursively(module_name: str) -> None:
    """Import a module — and, for a package, every submodule under it — so
    @resource decorators register."""
    mod = importlib.import_module(module_name)
    path = getattr(mod, "__path__", None)
    if path is not None:
        import pkgutil

        def _fail(name: str) -> None:
            raise ImportError(f"cannot import serving resource package {name}")

        for info in pkgutil.walk_packages(path, prefix=module_name + ".", onerror=_fail):
            importlib.import_module(info.name)


class ServingHealth:
    """Update-stream and drain state the consume thread and /ready share."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._stream_healthy: bool | None = None
        self._last_update_time: float | None = None
        self._draining = False
        self.consume_thread: SupervisedThread | None = None

    @property
    def stream_healthy(self) -> bool | None:
        with self._mu:
            return self._stream_healthy

    @property
    def draining(self) -> bool:
        with self._mu:
            return self._draining

    @draining.setter
    def draining(self, value: bool) -> None:
        with self._mu:
            self._draining = bool(value)

    def mark_stream_ok(self) -> None:
        with self._mu:
            self._stream_healthy = True

    def mark_stream_down(self) -> None:
        with self._mu:
            self._stream_healthy = False

    def mark_update(self) -> None:
        with self._mu:
            self._last_update_time = time.time()


@resource("GET", "/ready")
def _ready(ctx: ServingContext, req: Request) -> Response:
    """503 until the model is sufficiently loaded, and once draining."""
    if ctx.health is not None and ctx.health.draining:
        return Response(503, None)
    if _model_ready(ctx):
        return Response(200, None)
    return Response(503, None)


@resource("GET", "/metrics")
def _metrics(ctx: ServingContext, req: Request) -> Response:
    """The process's metrics registry as JSON, with the scan kernels'
    launches so far as ``kernels.<name>.launches`` gauges and the IVF
    tier's batches by path as ``serving.ann.<path>`` (the batch and speed
    layers serve theirs on ``oryx.<layer>.ui.port``)."""
    from oryx_tpu_torch.ops import ivf, streaming_topn

    for name, count in streaming_topn.launch_counts().items():
        metrics.registry.gauge(f"kernels.{name}.launches").set(count)
    for name, count in ivf.counts().items():
        metrics.registry.gauge(f"serving.ann.{name}").set(count)
    return Response(200, metrics.registry.snapshot(), content_type="application/json")


def _model_ready(ctx: ServingContext) -> bool:
    manager = ctx.model_manager
    if manager is None:
        return False
    model = manager.get_model()
    if model is None:
        return False
    min_fraction = ctx.config.get_float("oryx.serving.min-model-load-fraction")
    return getattr(model, "get_fraction_loaded", lambda: 1.0)() >= min_fraction


def _observe_request(method: str, status: int, t0: float) -> None:
    metrics.registry.counter(f"serving.requests.{method}").inc()
    metrics.registry.counter(f"serving.responses.{status // 100}xx").inc()
    metrics.registry.histogram("serving.request.seconds").observe(time.perf_counter() - t0)


def _refuse_tls_and_auth(config: Config) -> None:
    """TLS and HTTP Basic auth are not ported: a config that asks for
    either must not come up as a plaintext server open to anyone."""
    for key in ("keystore-file", "key-file", "keystore-password", "user-name", "password"):
        if config.get_optional_string(f"oryx.serving.api.{key}") is not None:
            raise NotYetPortedError(
                f"oryx.serving.api.{key} is set, but TLS and HTTP Basic auth are not "
                "yet ported to oryx_tpu_torch"
            )


def _configure_ann(config: Config) -> None:
    """Push oryx.serving.scan.ann.* and its maintain block into the IVF
    tier's and the maintainer's knobs."""
    from oryx_tpu_torch.ops.ivf import configure_ann
    from oryx_tpu_torch.serving.maintain import configure_maintain

    ann = "oryx.serving.scan.ann."
    configure_ann(
        enabled=config.get_optional_bool(ann + "enabled"),
        cells=config.get_optional_int(ann + "cells"),
        nprobe=config.get_optional_int(ann + "nprobe"),
        probe_fraction=config.get_optional_float(ann + "probe-fraction"),
        min_items=config.get_optional_int(ann + "min-items"),
        overlay_capacity=config.get_optional_int(ann + "overlay-capacity"),
        query_block=config.get_optional_int(ann + "query-block"),
        tile_chunks=config.get_optional_int(ann + "tile-chunks"),
        # "auto" (or unset) leaves the choice to where the index lives
        host_stage1={"true": True, "false": False}.get(
            str(config.get_optional_string(ann + "host-stage1")).lower()
        ),
    )
    configure_maintain(
        enabled=config.get_optional_bool(ann + "maintain.enabled"),
        interval_sec=config.get_optional_float(ann + "maintain.interval-sec"),
        watermark=config.get_optional_float(ann + "maintain.watermark"),
        split_max_items=config.get_optional_int(ann + "maintain.split-max-items"),
        merge_min_items=config.get_optional_int(ann + "maintain.merge-min-items"),
        publish=config.get_optional_bool(ann + "maintain.publish"),
    )


def _refuse_tenancy_and_experiments(config: Config) -> None:
    """Tenancy and online experiments are not ported: a config that
    declares tenants (the JAX package serves them when
    ``oryx.tenancy.enabled`` is on) or splits traffic to a challenger must
    not come up as one untenanted app serving the champion alone."""
    if config.get("oryx.tenancy.enabled", None) and config.get("oryx.tenancy.tenants", None):
        raise NotYetPortedError(
            "oryx.tenancy.tenants declares tenants, but tenancy is not yet ported "
            "to oryx_tpu_torch"
        )
    fraction = config.get_optional_float("oryx.serving.ab.fraction")
    if fraction is not None and fraction > 0:
        raise NotYetPortedError(
            f"oryx.serving.ab.fraction = {fraction}, but online experiments are not yet "
            "ported to oryx_tpu_torch"
        )


class ServingLayer:
    def __init__(self, config: Config) -> None:
        default_device()  # the port serves from the card: fail now, not per request
        _refuse_tls_and_auth(config)
        _refuse_tenancy_and_experiments(config)
        refuse_tier_store(config)
        self.config = config
        tracing.configure_from(config)
        self.port = config.get_int("oryx.serving.api.port")
        self.context_path = config.get_string("oryx.serving.api.context-path").rstrip("/")
        self.read_only = config.get_bool("oryx.serving.api.read-only")
        self.no_init_topics = config.get_optional_bool("oryx.serving.no-init-topics") or False
        self.model_manager_class = config.get_optional_string("oryx.serving.model-manager-class")
        self.app_resources = config.get_optional_strings("oryx.serving.application-resources")
        if self.model_manager_class:
            check_port_module(self.model_manager_class, "oryx.serving.model-manager-class")
        for mod in self.app_resources or []:
            check_port_module(mod, "oryx.serving.application-resources")

        # push oryx.serving.scan.* into the batcher's scheduler and the
        # scan before either spins up (the default batcher starts on first use)
        from oryx_tpu_torch.ops.streaming_topn import configure_scan
        from oryx_tpu_torch.serving.batcher import configure_scheduler

        configure_scheduler(
            max_batch=config.get_optional_int("oryx.serving.scan.max-batch"),
            max_inflight=config.get_optional_int("oryx.serving.scan.max-inflight"),
            latency_budget_ms=config.get_optional_float("oryx.serving.scan.latency-budget-ms"),
            # a full queue sheds at once (429) instead of queueing without bound
            max_queue=config.get_optional_int("oryx.serving.overload.max-queue"),
        )
        self.retry_after_s = config.get_optional_int("oryx.serving.overload.retry-after-s") or 1
        configure_scan(oversample=config.get_optional_int("oryx.serving.scan.oversample"))
        _configure_ann(config)

        # the model registry over the batch model dir: index generations
        # are written under it
        from oryx_tpu_torch.registry.store import RegistryStore

        model_dir = config.get_optional_string("oryx.batch.storage.model-dir")
        self.registry_store = RegistryStore(model_dir) if model_dir else None
        # the update-topic producer, opened on first use (an index
        # generation's INDEX-REF)
        self._update_producer = None
        self._update_producer_lock = threading.Lock()
        self._index_maintainer = None

        self.model_manager = None
        self.input_producer = None
        self._update_consumer = None
        self._consume_thread: SupervisedThread | None = None
        self._server: HTTPServer | None = None
        self._server_thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        self._batcher_retained = False
        self.health = ServingHealth()
        self.retry_policy = RetryPolicy.from_config(config, "oryx.serving.retry")
        self._close_lock = threading.Lock()
        self._close_done = False

        self.router = Router()
        for mod in self.app_resources or []:
            _import_recursively(mod)
        # framework resources (this module) + configured app resources only
        self.router.add_from_registry([__name__] + list(self.app_resources or []))

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        from oryx_tpu_torch.serving.batcher import retain_default_batcher

        if self._server is not None or self._update_consumer is not None:
            raise RuntimeError("ServingLayer.start() called twice")
        retain_default_batcher()
        self._batcher_retained = True
        cfg = self.config
        input_broker_loc = cfg.get_optional_string("oryx.input-topic.broker")
        input_topic = cfg.get_optional_string("oryx.input-topic.message.topic")
        update_broker_loc = cfg.get_optional_string("oryx.update-topic.broker")
        update_topic = cfg.get_optional_string("oryx.update-topic.message.topic")

        if input_broker_loc and input_topic and not self.read_only:
            broker = get_broker(input_broker_loc)
            if not self.no_init_topics:
                broker.create_topic(
                    input_topic, cfg.get_optional_int("oryx.input-topic.message.partitions") or 1
                )
            self.input_producer = broker.producer(input_topic)

        if self.model_manager_class:
            self.model_manager = load_instance_of(self.model_manager_class, cfg)
            if update_broker_loc and update_topic:
                broker = get_broker(update_broker_loc)
                if not self.no_init_topics:
                    broker.create_topic(
                        update_topic,
                        cfg.get_optional_int("oryx.update-topic.message.partitions") or 1,
                    )
                # replay the update topic from offset 0 on every start;
                # a poll failure marks the stream down and the supervised
                # thread restarts with backoff under oryx.serving.retry.*
                self._update_consumer = broker.consumer(update_topic, from_beginning=True)
                self._consume_thread = SupervisedThread(
                    "ServingUpdateConsumer",
                    self._consume_updates,
                    self.retry_policy,
                    self._stop_event,
                    metrics_prefix="serving.consume",
                )
                self.health.consume_thread = self._consume_thread
                self._consume_thread.start()

        self._start_index_maintainer(update_broker_loc, update_topic)
        ctx = ServingContext(self.model_manager, self.input_producer, self.config, self.health)
        threads = cfg.get_optional_int("oryx.serving.api.threads") or 64
        self._server = _PooledHTTPServer(("0.0.0.0", self.port), _make_handler(self, ctx), threads)
        if self.port == 0:
            self.port = self._server.server_address[1]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, name="ServingHTTP", daemon=True
        )
        self._server_thread.start()
        ledger.register("thread", self._server_thread, live=threading.Thread.is_alive)
        log.info("ServingLayer listening on :%d%s", self.port, self.context_path or "/")

    def _start_index_maintainer(self, update_broker_loc, update_topic) -> None:
        """The background IVF compaction loop, for a manager whose models
        speak the maintenance protocol (ALS); with ``maintain.publish`` and
        a registry, each compaction goes out as an index generation."""
        from oryx_tpu_torch.serving import maintain as maintain_mod

        if not (
            self.model_manager is not None
            and maintain_mod.maintain_enabled()
            and hasattr(self.model_manager, "get_model")
        ):
            return
        publish_fn = None
        if (
            maintain_mod.MAINTAIN_PUBLISH
            and self.registry_store is not None
            and update_broker_loc
            and update_topic
        ):

            def publish_fn(index, stats):
                ref = maintain_mod.write_index_generation(
                    self.registry_store.model_dir, index, stats=stats
                )
                with self._update_producer_lock:
                    if self._update_producer is None:
                        self._update_producer = get_broker(update_broker_loc).producer(
                            update_topic
                        )
                    self._update_producer.send(maintain_mod.INDEX_REF_KEY, ref)
                return ref

        self._index_maintainer = maintain_mod.IndexMaintainer(
            self.model_manager.get_model, publish_fn=publish_fn
        )
        self._index_maintainer.start()

    def _consume_updates(self) -> None:
        self.model_manager.consume_blocks(self._health_blocks())

    def _health_blocks(self):
        """The update consumer's blocks, with each poll reporting the
        stream's health and each applied block stamping the update time."""
        consumer = self._update_consumer
        while not self._stop_event.is_set() and not consumer.closed():
            try:
                block = consumer.poll_block(max_records=10_000, timeout=0.2)
            except Exception:
                self.health.mark_stream_down()
                raise
            self.health.mark_stream_ok()
            if block is not None and len(block) > 0:
                yield block
                self.health.mark_update()

    def await_termination(self, timeout: float | None = None) -> None:
        if self._server_thread is not None:
            self._server_thread.join(timeout)

    def close(self) -> None:
        with self._close_lock:
            if self._close_done:
                return
            self._close_done = True
        self.health.draining = True
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        self._stop_event.set()
        if self._update_consumer is not None:
            self._update_consumer.close()
        if self._consume_thread is not None:
            self._consume_thread.join(timeout=5)
            if self._consume_thread.is_alive():
                log.warning("serving thread %r still alive after 5s join", self._consume_thread.name)
        if self._index_maintainer is not None:
            self._index_maintainer.close()
        if self.model_manager is not None:
            self.model_manager.close()
        if self.input_producer is not None:
            self.input_producer.close()
        with self._update_producer_lock:
            if self._update_producer is not None:
                self._update_producer.close()
                self._update_producer = None
        if self._batcher_retained:
            self._batcher_retained = False
            from oryx_tpu_torch.serving.batcher import release_default_batcher

            release_default_batcher()

    def __enter__(self) -> "ServingLayer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _dispatch_parsed(layer: ServingLayer, ctx: ServingContext, method: str, raw_path: str,
                     headers, body: bytes):
    """Everything between a parsed request and a rendered (status,
    payload, content-type, extra headers) tuple."""
    split = urlsplit(raw_path)
    path = split.path
    if layer.context_path:
        if not path.startswith(layer.context_path):
            raise OryxServingException(404, "outside context path")
        path = path[len(layer.context_path):] or "/"
    if headers.get("Content-Encoding") == "gzip":
        body = gzip.decompress(body)
    req = Request(
        method="GET" if method == "HEAD" else method,  # HEAD routes like GET
        path=path,
        params={},
        query=parse_qs(split.query),
        headers={k: v for k, v in headers.items()},
        body=body,
    )
    attrs = {"path": path, "method": req.method}
    incoming = tracing.parse_traceparent(headers.get("traceparent"))
    if incoming is not None and incoming.sampled:
        with tracing.use(incoming):
            with tracing.span("serving.request", attrs=attrs) as sp:
                response = _route(layer, ctx, req)
                sp.set("status", response.status)
    else:
        with tracing.span("serving.request", attrs=attrs, root=True) as sp:
            response = _route(layer, ctx, req)
            sp.set("status", response.status)
    return render(response, headers.get("Accept", "application/json"))


def _route(layer: ServingLayer, ctx: ServingContext, req: Request) -> Response:
    """The router's answer, or 429 when the batcher's bounded queue is full
    (``oryx.serving.overload.max-queue``): an immediate shed instead of an
    unbounded wait, with Retry-After so clients back off."""
    try:
        return layer.router.dispatch(ctx, req)
    except BatcherOverloadedError:
        return Response(
            429,
            {"error": "overloaded", "retry_after_s": layer.retry_after_s},
            content_type="application/json",
            headers={"Retry-After": str(layer.retry_after_s)},
        )


def _make_handler(layer: ServingLayer, ctx: ServingContext):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "oryx_tpu_torch"
        # keep-alive clients see Nagle + delayed-ACK stalls without this
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # route to logging, not stderr
            log.debug("%s " + fmt, self.address_string(), *args)

        def _handle(self, method: str) -> None:
            t0 = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                status, payload, ct, extra = _dispatch_parsed(
                    layer, ctx, method, self.path, self.headers, body
                )
            except OryxServingException as e:
                _observe_request(method, e.status, t0)
                self._send_error(e.status, e.message)
                return
            except Exception:
                log.exception("internal error handling %s %s", method, self.path)
                _observe_request(method, 500, t0)
                self._send_error(500, "internal error")
                return
            _observe_request(method, status, t0)
            headers = dict(extra)
            if len(payload) > 1024 and "gzip" in self.headers.get("Accept-Encoding", ""):
                payload = gzip.compress(payload, mtime=0)
                headers["Content-Encoding"] = "gzip"
            self.send_response(status)
            self.send_header("Content-Type", ct)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            if method != "HEAD":
                self.wfile.write(payload)

        def _send_error(self, status: int, message: str) -> None:
            body = f"{status} {message}\n".encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except BrokenPipeError:
                pass

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def do_DELETE(self):
            self._handle("DELETE")

        def do_HEAD(self):
            self._handle("HEAD")

    return Handler
