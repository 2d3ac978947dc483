"""The serving layer process: HTTP server + model-manager lifecycle
(counterpart of ``oryx_tpu/serving/layer.py``, slimmed).

On start it creates the input-topic producer (unless read-only), loads
the configured ServingModelManager, starts a supervised daemon thread
replaying the update topic from the beginning into the manager, and
serves the registered resources with a context path, gzip, ``/ready``
readiness gating and the ``/healthz`` / ``/readyz`` probes.
``oryx.serving.scan.*`` reaches the batcher's scheduler and the scan
before either starts.

Two fronts serve the same ``_dispatch_parsed`` core, as in the JAX
package: the native epoll front (``serving/native_front.py`` over
``native/httpfront.cpp``, built by ``g++`` at first use) whenever
``oryx.serving.native.enabled`` allows it and the library builds, and
the pooled stdlib server otherwise. Either returns the same bytes.

The port runs on CUDA: constructing a layer raises when no CUDA device
is present, unless the caller chose the CPU
(``oryx_tpu_torch.device.set_device("cpu")``).

Overload control is the JAX package's (``serving/overload.py``): with
``oryx.serving.overload.enabled`` an admission controller reads the
batcher's queue-wait EWMA, its queue depth and the requests in flight
and walks the shed ladder full -> reduced-probe (the IVF tier scans a
fraction of its cells) -> stale (the last full answer of the live
generation) -> shed (fast 429 with ``Retry-After``); the served stage
rides the ``X-Oryx-Shed-Stage`` header. The batcher's queue is bounded
by ``oryx.serving.overload.max-queue`` whether or not the controller
runs: a request that finds it full is answered 429. A generation
tracker (``registry/tracking.py``) follows the update topic's MODEL
records: it names the live generation for ``/healthz`` and the stale
rung, and drops a second delivery of the live generation's MODEL.

``oryx.serving.scan.ann.*`` reaches the IVF tier (``ops/ivf.py``) and
``oryx.serving.scan.ann.maintain.*`` the background index maintainer
(``serving/maintain.py``), which ``start()`` runs when it is enabled and
``close()`` stops. With ``maintain.publish`` and a model dir
(``oryx.batch.storage.model-dir``), each compaction is written there as
an index generation and announced as ``INDEX-REF`` on the update topic,
through one lazily opened producer.

``oryx.serving.store.tier.*`` configures the tiered HBM->RAM->disk
item store (``native/store.configure_tier``): with it enabled, IVF host
planes built afterwards move into the cell store.

``/metrics`` serves the metrics registry, with the model's loaded
fraction, the live generation, the scan kernels' launch counts and the
IVF tier's batches by path: as JSON, or as Prometheus text 0.0.4 for
``?format=prometheus`` or an ``Accept`` naming ``text/plain`` or
``openmetrics`` (``?format=json`` wins), as the JAX package negotiates.

Not ported yet: tenancy and online experiments (a config that declares
enabled tenants or sets ``oryx.serving.ab.fraction`` above 0 is refused
at construction, so the per-tenant ladders and the experiment arm stay
out), ``/model/generations`` and rollback, MODEL-REF restage, TLS and
auth (a config that sets a key file or credentials is refused at
construction), tracing export routes, profiling and the per-instance
metrics registry.
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
from oryx_tpu_torch.tenancy import context as _tenancy
from oryx_tpu_torch.device import default_device
from oryx_tpu_torch.registry.tracking import GenerationTracker
from oryx_tpu_torch.serving import overload as _overload
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
    """Liveness and readiness state of the serving layer: the update
    stream's health, the time of the last applied update, the drain
    flag, and the live (and challenger) generation the tracker names.

    The update-stream consumer reports in: every successful poll marks the
    stream healthy, every poll error marks it down. When the stream is
    down the layer keeps answering from the last good model — *degraded*,
    not dead — and `staleness()` says how old that model's last delta is.
    `stream_healthy` is None until the first poll (or when no update topic
    is configured), which readiness treats as "not known to be down".
    """

    def __init__(self, clock=time.time) -> None:
        self._clock = clock
        # one lock over every flag: the consume thread writes the stream
        # marks and generation ids, the shutdown path flips draining, and
        # HTTP handler threads read all of them
        self._mu = threading.Lock()
        self._stream_healthy: bool | None = None
        self._last_update_time: float | None = None
        self.consume_thread: SupervisedThread | None = None
        self._draining: bool = False
        self._live_generation: str | None = None
        self._challenger_generation: str | None = None

    @property
    def stream_healthy(self) -> bool | None:
        with self._mu:
            return self._stream_healthy

    @property
    def last_update_time(self) -> float | None:
        with self._mu:
            return self._last_update_time

    # drain-aware shutdown: once True, /ready and /readyz answer 503 so
    # load balancers stop routing here, while in-flight requests complete
    @property
    def draining(self) -> bool:
        with self._mu:
            return self._draining

    @draining.setter
    def draining(self, value: bool) -> None:
        with self._mu:
            self._draining = bool(value)

    # generation id of the live model (set by the GenerationTracker as
    # MODEL/MODEL-REF records flow past); None until one arrives or
    # when models carry no generation identity
    @property
    def live_generation(self) -> str | None:
        with self._mu:
            return self._live_generation

    @live_generation.setter
    def live_generation(self, value: str | None) -> None:
        with self._mu:
            self._live_generation = value

    # generation id of an online experiment's challenger arm; always None
    # in the port, which refuses experiments
    @property
    def challenger_generation(self) -> str | None:
        with self._mu:
            return self._challenger_generation

    @challenger_generation.setter
    def challenger_generation(self, value: str | None) -> None:
        with self._mu:
            self._challenger_generation = value

    def mark_stream_ok(self) -> None:
        with self._mu:
            self._stream_healthy = True
        metrics.registry.gauge("serving.update-stream.healthy").set(1)

    def mark_stream_down(self) -> None:
        with self._mu:
            self._stream_healthy = False
        metrics.registry.gauge("serving.update-stream.healthy").set(0)

    def mark_update(self) -> None:
        with self._mu:
            self._last_update_time = self._clock()

    def staleness(self) -> float | None:
        """Seconds since the last model update was applied, or None if no
        update has ever arrived. Also published as a gauge."""
        with self._mu:
            last = self._last_update_time
        if last is None:
            return None
        s = self._clock() - last
        metrics.registry.gauge("serving.model.staleness-seconds").set(s)
        return s

    @property
    def alive(self) -> bool:
        """False only once the supervised consume thread exhausted its
        restart policy — the layer can no longer recover by itself."""
        t = self.consume_thread
        return t is None or not t.gave_up

    @property
    def degraded(self) -> bool:
        return self.stream_healthy is False


@resource("GET", "/ready")
def _ready(ctx: ServingContext, req: Request) -> Response:
    """503 until the model is sufficiently loaded, and once draining."""
    if ctx.health is not None and ctx.health.draining:
        return Response(503, None)
    if _model_ready(ctx):
        return Response(200, None)
    return Response(503, None)


@resource("GET", "/healthz")
def _healthz(ctx: ServingContext, req: Request) -> Response:
    """Liveness + degraded-mode report. 200 while the process can serve —
    including degraded (update stream down, answering from the last good
    model); 503 only when the update consumer has given up for good.

    ``status`` folds the two degraded notions (last-good-model serving,
    and the shed ladder's reduced-quality stages) into one word:
    down > draining > degraded > ok; ``shed_stage`` names the ladder rung
    currently serving answers."""
    health = ctx.health
    if health is None:
        return Response(200, {"alive": True}, content_type="application/json")
    stage = ctx.admission.stage if ctx.admission is not None else _overload.STAGE_FULL
    if not health.alive:
        status = "down"
    elif health.draining:
        status = "draining"
    elif health.degraded or stage > _overload.STAGE_FULL:
        status = "degraded"
    else:
        status = "ok"
    body = {
        "alive": health.alive,
        "degraded": health.degraded or stage > _overload.STAGE_FULL,
        "status": status,
        "shed_stage": _overload.STAGE_NAMES[stage],
        "stream_healthy": health.stream_healthy,
        "staleness_seconds": health.staleness(),
        "live_generation": health.live_generation,
        "challenger_generation": health.challenger_generation,
    }
    return Response(200 if health.alive else 503, body, content_type="application/json")


@resource("GET", "/readyz")
def _readyz(ctx: ServingContext, req: Request) -> Response:
    """Strict readiness for load balancers: the model must be loaded AND
    the update stream must not be known-down AND the instance must not be
    draining. Degraded/draining instances keep /healthz green but drop
    out of /readyz rotation."""
    ready = _model_ready(ctx)
    stream_ok = ctx.health is None or ctx.health.stream_healthy is not False
    draining = ctx.health is not None and ctx.health.draining
    body = {"model_ready": ready, "stream_ok": stream_ok, "draining": draining}
    ok = ready and stream_ok and not draining
    return Response(200 if ok else 503, body, content_type="application/json")


@resource("GET", "/metrics")
def _metrics(ctx: ServingContext, req: Request) -> Response:
    """The process's metrics registry and model state, with the scan
    kernels' launches so far as ``kernels.<name>.launches`` gauges and
    the IVF tier's batches by path as ``serving.ann.<path>`` (the batch
    and speed layers serve theirs on ``oryx.<layer>.ui.port``). JSON, or
    Prometheus text for a scraper (``oryx_tpu/serving/layer.py``'s
    content negotiation)."""
    from oryx_tpu_torch.ops import ivf, streaming_topn

    for name, count in streaming_topn.launch_counts().items():
        metrics.registry.gauge(f"kernels.{name}.launches").set(count)
    for name, count in ivf.counts().items():
        metrics.registry.gauge(f"serving.ann.{name}").set(count)
    if ledger.enabled():
        # resources.<kind>.live gauges: the leak alarm for week-long runs
        ledger.ledger.refresh()
    snap = metrics.registry.snapshot()
    manager = ctx.model_manager
    model = manager.get_model() if manager is not None else None
    if model is not None:
        snap["serving.model.fraction_loaded"] = {
            "type": "gauge",
            "value": getattr(model, "get_fraction_loaded", lambda: 1.0)(),
        }
    if ctx.health is not None and ctx.health.live_generation is not None:
        snap["serving.model.live_generation"] = {
            "type": "gauge",
            "value": ctx.health.live_generation,
        }
    accept = next((v for k, v in req.headers.items() if k.lower() == "accept"), "")
    if (
        req.q1("format") == "prometheus" or "text/plain" in accept or "openmetrics" in accept
    ) and req.q1("format") != "json":
        # standard-scraper exposition (Prometheus sends
        # `Accept: text/plain;version=0.0.4`); live_generation may be a
        # non-numeric id, which the renderer would choke on: drop it from
        # the text form
        prom = {
            k: v
            for k, v in snap.items()
            if not (k == "serving.model.live_generation" and _non_numeric(v))
        }
        return Response(
            200, metrics.render_prometheus(prom), content_type=metrics.PROMETHEUS_CONTENT_TYPE
        )
    return Response(200, snap, content_type="application/json")


def _non_numeric(entry) -> bool:
    try:
        float(entry.get("value"))
        return False
    except (TypeError, ValueError):
        return True


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
        self.config = config
        tracing.configure_from(config)
        self.port = config.get_int("oryx.serving.api.port")
        # refused above; the native front's decline reads them as the
        # JAX package's does
        self.use_tls = False
        self.user_name = None
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
        configure_scan(oversample=config.get_optional_int("oryx.serving.scan.oversample"))
        _configure_ann(config)
        # tiered HBM->RAM->disk item store (native/store.py): catalogs
        # bigger than RAM keep serving out of the cell store
        from oryx_tpu_torch.native.store import configure_tier

        tier_ram_mb = config.get_optional_int("oryx.serving.store.tier.ram-mb")
        configure_tier(
            enabled=config.get_optional_bool("oryx.serving.store.tier.enabled"),
            hot_cells=config.get_optional_int("oryx.serving.store.tier.hot-cells"),
            ram_bytes=None if tier_ram_mb is None else int(tier_ram_mb) << 20,
            spill_dir=config.get_optional_string("oryx.serving.store.tier.spill-dir"),
        )

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
        self._native_front = None  # serving/native_front.NativeFront | None
        self._stop_event = threading.Event()
        self._batcher_retained = False
        self.health = ServingHealth()
        self.retry_policy = RetryPolicy.from_config(config, "oryx.serving.retry")
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        self._close_lock = threading.Lock()
        self._close_done = False
        # live generation and duplicate-MODEL suppression on the update stream
        self.generation_tracker = GenerationTracker(self.health)

        # adaptive overload control: the admission controller watches the
        # batcher's queue-wait EWMA, its queue depth and the requests in
        # flight against the oryx.serving.overload.* budget and walks the
        # shed ladder; None when disabled, so the request path pays nothing
        self.overload_config = _overload.OverloadConfig.from_config(config)
        self.admission = (
            _overload.AdmissionController(
                self.overload_config,
                signals=self._overload_signals,
                generation_fn=lambda: self.health.live_generation,
            )
            if self.overload_config.enabled
            else None
        )

        self.router = Router()
        for mod in self.app_resources or []:
            _import_recursively(mod)
        # framework resources (this module) + configured app resources only
        self.router.add_from_registry([__name__] + list(self.app_resources or []))

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        from oryx_tpu_torch.serving import native_front as _native_mod
        from oryx_tpu_torch.serving.batcher import retain_default_batcher

        if (
            self._server is not None
            or self._native_front is not None
            or self._update_consumer is not None
        ):
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
        ctx = ServingContext(
            self.model_manager, self.input_producer, self.config, self.health,
            admission=self.admission,
        )
        threads = cfg.get_optional_int("oryx.serving.api.threads") or 64
        # the native front when oryx.serving.native.* allows it and g++
        # builds it; None on any decline, and the stdlib server serves
        self._native_front = _native_mod.maybe_start(self, ctx, threads)
        if self._native_front is not None:
            self.port = self._native_front.port
            ledger.register(
                "thread", self._native_front.poll_thread, live=threading.Thread.is_alive
            )
        else:
            self._server = _PooledHTTPServer(
                ("0.0.0.0", self.port), _make_handler(self, ctx), threads
            )
            if self.port == 0:
                self.port = self._server.server_address[1]
            self._server_thread = threading.Thread(
                target=self._server.serve_forever, name="ServingHTTP", daemon=True
            )
            self._server_thread.start()
            ledger.register("thread", self._server_thread, live=threading.Thread.is_alive)
        log.info(
            "ServingLayer listening on :%d%s%s",
            self.port,
            self.context_path or "/",
            " (native front)" if self._native_front is not None else "",
        )

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
            # track the live generation and drop a second delivery of its
            # MODEL before the manager sees the block
            block = self.generation_tracker.filter_block(block)
            if block is not None and len(block) > 0:
                yield block
                self.health.mark_update()
                if self._native_front is not None and _block_has_model(block):
                    # a MODEL apply flips readiness and the live generation
                    # now: the native snapshots do not wait for the next tick
                    self._native_front.push_snapshots()

    # -- in-flight requests and drain ----------------------------------------

    def _request_began(self) -> None:
        with self._inflight_cond:
            self._inflight += 1

    def _request_ended(self) -> None:
        with self._inflight_cond:
            self._inflight -= 1
            if self._inflight <= 0:
                self._inflight_cond.notify_all()

    @property
    def inflight_requests(self) -> int:
        with self._inflight_cond:
            return self._inflight

    def _overload_signals(self) -> tuple[float, int, int]:
        """(queue_wait_ewma_ms, queue_depth, http_inflight) for the
        admission controller; the batcher half reads the process-wide
        default batcher without ever creating one."""
        from oryx_tpu_torch.serving.batcher import default_batcher_signals

        queue_wait_ms, depth = default_batcher_signals()
        return queue_wait_ms, depth, self.inflight_requests

    def begin_drain(self) -> None:
        """Refuse new traffic at the readiness level: /ready and /readyz
        answer 503 so load balancers stop sending here, while requests in
        flight complete."""
        self.health.draining = True
        if self._native_front is not None:
            # the native /readyz snapshot flips now, not at the next tick
            self._native_front.push_snapshots()
        log.info("ServingLayer :%d draining (readiness now 503)", self.port)

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until no request is in flight (or timeout); True when the
        instance is idle and safe to close."""
        deadline = time.monotonic() + timeout
        with self._inflight_cond:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cond.wait(remaining)
        return True

    def await_termination(self, timeout: float | None = None) -> None:
        """Block until the front stops serving (``close()``). The JAX
        package joins only the stdlib server's thread, so its serving
        command returns at once behind the native front; the port joins
        whichever front serves."""
        if self._native_front is not None:
            self._native_front.poll_thread.join(timeout)
        elif self._server_thread is not None:
            self._server_thread.join(timeout)

    def close(self) -> None:
        with self._close_lock:
            if self._close_done:
                return
            self._close_done = True
        self.health.draining = True
        if self._native_front is not None:
            self._native_front.close()
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


def _block_has_model(block) -> bool:
    keys = getattr(block, "keys", None)
    if keys is None:
        return False
    return bool((keys == b"MODEL").any() or (keys == b"MODEL-REF").any())


def _shed_response(retry_after_s: int) -> Response:
    """Fast 429 for the top ladder rung: tiny JSON body, Retry-After so
    well-behaved clients back off instead of hammering the retry path."""
    return Response(
        429,
        {"error": "overloaded", "retry_after_s": retry_after_s},
        content_type="application/json",
        headers={"Retry-After": str(retry_after_s)},
    )


def _admit_and_route(layer: ServingLayer, ctx: ServingContext, req, cache_key, sp):
    """Route one request through the shed ladder.

    The admission decision picks the *intended* stage; this function
    reports the stage the request was *actually* served at — a stale-rung
    request that misses the answer cache falls through to a reduced-probe
    scan, and a full-quality request that finds the batcher queue full is
    shed at the door. The served stage is stamped on the response header,
    the request span and the per-stage counters."""
    tenant = _tenancy.current_tenant()
    admission = layer.admission
    decision = (
        admission.decide(req.method, req.path, tenant=tenant)
        if admission is not None
        else None
    )

    def _champion_generation():
        # the generation stale-cache entries are stamped with and checked
        # against: the tracker's live one
        return admission.generation() if admission is not None else None

    served = None  # stage name actually used; None = full quality
    response = None
    if decision is not None and decision.stage >= _overload.STAGE_SHED:
        served = "shed"
        response = _shed_response(decision.retry_after_s)
    elif (
        decision is not None
        and decision.stage >= _overload.STAGE_STALE
        and req.method == "GET"
    ):
        cached = admission.cache.get(cache_key, _champion_generation())
        if cached is not None:
            served = "stale"
            response = Response(cached.status, cached.payload, cached.content_type)
    if response is None:
        try:
            if decision is not None and decision.probe_fraction is not None:
                with _overload.probe_override(decision.probe_fraction):
                    response = layer.router.dispatch(ctx, req)
                if getattr(response, "status", 200) == 200:
                    served = "reduced-probe"
            else:
                response = layer.router.dispatch(ctx, req)
        except BatcherOverloadedError:
            # bounded-queue rejection (oryx.serving.overload.max-queue):
            # an immediate shed instead of unbounded queueing, taken even
            # when the admission controller is disabled
            served = "shed"
            response = _shed_response(layer.overload_config.retry_after_s)
        else:
            if (
                decision is not None
                and decision.stage == _overload.STAGE_FULL
                and req.method == "GET"
                and getattr(response, "status", 200) == 200
                and _champion_generation() is not None
            ):
                # feed the stale-answer cache with full-quality answers
                # only, stamped with the champion generation
                admission.cache.put(
                    cache_key,
                    _overload.CachedAnswer(
                        _champion_generation(),
                        response.status,
                        response.body,
                        response.content_type,
                    ),
                )
    if served is not None:
        _overload.count_shed(served, tenant=tenant)
        headers = getattr(response, "headers", None)
        if headers is not None:
            headers[_overload.SHED_HEADER] = served
        if sp is not None:
            sp.set("shed_stage", served)
    return response


def gzip_compress(body: bytes) -> bytes:
    """Deterministic response gzip (mtime pinned): the same body always
    gives the same bytes, which keeps the native and stdlib fronts
    byte-equal across the gzip rung."""
    return gzip.compress(body, mtime=0)


def _dispatch_parsed(layer: ServingLayer, ctx: ServingContext, method: str, raw_path: str,
                     headers, body: bytes):
    """The front-agnostic request core: everything between a parsed
    request and a rendered (status, payload, content-type, extra headers)
    tuple. The stdlib handler and the native front's dispatch workers
    (``serving/native_front.py``) both call it, so admission, tracing
    and rendering cannot drift between fronts. ``headers`` needs a
    case-insensitive ``get`` and ``items()`` (``email.Message`` and
    ``native_front._Headers`` both qualify)."""
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
    # answer-cache key: path + raw query, the whole identity of a GET the
    # stale rung serves
    cache_key = path + ("?" + split.query if split.query else "")
    attrs = {"path": path, "method": req.method}
    incoming = tracing.parse_traceparent(headers.get("traceparent"))
    # untenanted: the port refuses declared tenants
    with _tenancy.tenant_scope(None):
        if incoming is not None and incoming.sampled:
            with tracing.use(incoming):
                with tracing.span("serving.request", attrs=attrs) as sp:
                    response = _admit_and_route(layer, ctx, req, cache_key, sp)
                    sp.set("status", getattr(response, "status", 200))
        else:
            with tracing.span("serving.request", attrs=attrs, root=True) as sp:
                response = _admit_and_route(layer, ctx, req, cache_key, sp)
                sp.set("status", getattr(response, "status", 200))
    return render(response, headers.get("Accept", "application/json"))


def _make_handler(layer: ServingLayer, ctx: ServingContext):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # the JAX package's token: either package, either front, the same bytes
        server_version = "oryx_tpu"
        # keep-alive clients see Nagle + delayed-ACK stalls without this
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # route to logging, not stderr
            log.debug("%s " + fmt, self.address_string(), *args)

        def _handle(self, method: str) -> None:
            t0 = time.perf_counter()
            layer._request_began()
            try:
                self._handle_counted(method, t0)
            finally:
                layer._request_ended()

        def _handle_counted(self, method: str, t0: float) -> None:
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
                payload = gzip_compress(payload)
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
