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

Tenancy as in the JAX package (docs/multi-tenancy.md): with
``oryx.tenancy.enabled`` and declared tenants, one layer serves every
tenant's app. Each tenant gets its own model manager, health, generation
tracker, registry store and update consumer on its namespaced topic
(``tenancy.spec.tenant_config``), behind the ``TenantServingMux``; a
request's tenant comes from the ``/t/<tenant>/`` prefix, else the
``X-Oryx-Tenant`` header, else the default tenant; the batcher serves the
tenants deficit-round-robin by weight and the admission controller keeps
a ladder per tenant. ``/healthz`` lists every tenant's live generation
and the request counters carry ``tenant.<id>`` twins.

Online experiments as in the JAX package (docs/experiments.md): with
``oryx.serving.ab.fraction`` above 0 and a model dir, an
``ExperimentCoordinator`` assigns each attributed request an arm
(``X-Oryx-Experiment-Arm``), joins interaction events from the input
topic back to the served lists, and promotes or refuses the challenger
through the registry (``GET /experiments`` reports it). The model
registry answers ``GET /model/generations`` and
``POST /model/rollback/<generation>``, and ``oryx.serving.restage-dir``
stages MODEL-REF generations into a local cache (``serving/restage.py``).
Each layer keeps its own metrics registry (``instance_metrics``), which
``/metrics`` lays over the process-wide one.

TLS and HTTP Basic auth as in the JAX package: ``keystore-file`` and
``key-file`` (PEM, together) make the layer listen on ``secure-port``
over TLS >= 1.2, each accepted socket wrapped on a pool worker;
``user-name`` and ``password`` (together) gate every request of both
fronts with Basic auth, refused over plaintext unless
``allow-insecure-auth``. The native front declines either, so the
stdlib front serves them.

``GET /trace`` exports this process's recorded spans (Chrome trace, or
the span list under ``?format=spans``; ``?trace=<id>`` filters), and
``POST /debug/profile?seconds=N`` takes a ``torch.profiler`` capture of
the process and the card into ``oryx.serving.compute.profile-dir``
(``common/profiling.py``, Chrome trace format).

A traced update block (the publisher's ``@trc`` header) feeds
``serving.freshness.seconds`` and is applied inside a
``serving.model.apply`` / ``serving.apply`` span of the publisher's
trace. Autoscaling is the fleet harness's (``serving/autoscale.py``,
``tools/fleet.py``), not the layer's.
"""

from __future__ import annotations

import base64
import contextlib
import gzip
import hmac
import importlib
import logging
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlsplit

from oryx_tpu_torch.bus.core import get_broker
from oryx_tpu_torch.common import ledger, metrics, profiling, tracing
from oryx_tpu_torch.common.compute import refuse_compile_cache
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.lang import check_port_module, load_instance_of
from oryx_tpu_torch.common.resilience import RetryPolicy, SupervisedThread
from oryx_tpu_torch.device import default_device
from oryx_tpu_torch.experiments import routing as _exp_routing
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
from oryx_tpu_torch.tenancy import context as _tenancy

log = logging.getLogger(__name__)


class _PooledHTTPServer(HTTPServer):
    """HTTP server with a bounded worker pool: a worker owns a connection
    for its keep-alive lifetime; beyond `threads` concurrent connections,
    accepts queue. TLS is wrapped per connection on the pool worker, never
    on the listener, so a client that stalls mid-handshake costs one
    worker, not the accept loop. Accepted sockets get a read timeout, and
    live connections are tracked so server_close() unblocks every worker."""

    daemon_threads = True
    read_timeout = 30.0
    # listen backlog: the stdlib's 5 drops the SYNs of a burst of
    # concurrent clients, whose retransmits then add 1 s and 3 s
    request_queue_size = 128

    def __init__(self, addr, handler_cls, threads: int, tls_ctx=None) -> None:
        super().__init__(addr, handler_cls)
        self._tls_ctx = tls_ctx
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, threads), thread_name_prefix="ServingWorker"
        )

    def process_request(self, request, client_address):
        self._pool.submit(self._work, request, client_address)

    def _work(self, request, client_address):
        conn = request
        try:
            conn.settimeout(self.read_timeout)
            if self._tls_ctx is not None:
                try:
                    conn = self._tls_ctx.wrap_socket(conn, server_side=True)
                except Exception as e:
                    log.debug("TLS handshake failed from %s: %s", client_address, e)
                    return
            with self._conns_lock:
                self._conns.add(conn)
            try:
                self.finish_request(conn, client_address)
            except Exception:
                self.handle_error(conn, client_address)
            finally:
                with self._conns_lock:
                    self._conns.discard(conn)
        finally:
            self.shutdown_request(conn)

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

    # generation id of the challenger arm while an online experiment is
    # active (docs/experiments.md); None otherwise
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
    # multi-tenant serving: the model manager is a TenantServingMux and
    # each tenant has its own live generation
    live_generations = getattr(ctx.model_manager, "live_generations", None)
    if callable(live_generations):
        body["tenants"] = live_generations()
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
    if ctx.instance_metrics is not None:
        # instance-scoped values shadow the process-global ones: with
        # several layers in one process the shared registry sums them all,
        # the instance registry is this layer alone
        snap.update(ctx.instance_metrics.snapshot())
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


@resource("GET", "/trace")
def _trace(ctx: ServingContext, req: Request) -> Response:
    """This process's recorded spans: Chrome-trace/Perfetto JSON by
    default (load in chrome://tracing or ui.perfetto.dev), or the raw
    span list with parent links under ?format=spans. ?trace=<32hex>
    filters to one trace id."""
    trace_id = req.q1("trace")
    if req.q1("format") == "spans":
        body = {"spans": tracing.spans(trace_id), **tracing.stats()}
    else:
        body = tracing.export_chrome(trace_id)
    return Response(200, body, content_type="application/json")


@resource("POST", "/debug/profile")
def _debug_profile(ctx: ServingContext, req: Request) -> Response:
    """On-demand torch.profiler capture: trace this process and its card
    for ?seconds=N (default 1, capped at 30), write the Chrome trace under
    oryx.serving.compute.profile-dir, return its directory. 503 when no
    profile dir is configured or the profiler cannot start."""
    profile_dir = profiling.profile_dir_from_config(ctx.config, "serving")
    if not profile_dir:
        raise OryxServingException(503, "oryx.serving.compute.profile-dir is not configured")
    seconds = min(30.0, max(0.0, req.q_float("seconds", 1.0)))
    try:
        target = profiling.capture(profile_dir, "serving-ondemand", seconds)
    except RuntimeError as e:
        raise OryxServingException(503, str(e))
    metrics.registry.counter("serving.debug.profiles").inc()
    return Response(200, {"path": target, "seconds": seconds}, content_type="application/json")


@resource("GET", "/model/generations")
def _model_generations(ctx: ServingContext, req: Request) -> Response:
    """The registry's view of the model dir plus what this instance is
    actually serving — the skew between the two is what the `health` CLI
    probe alerts on (docs/model-registry.md)."""
    registry = ctx.registry
    if registry is None:
        raise OryxServingException(404, "no model registry configured")
    generations = []
    for gen_id in registry.list_generations():
        manifest = registry.read_manifest(gen_id)
        entry = {"generation_id": gen_id}
        if manifest is not None:
            entry.update(
                status=manifest.status,
                parent_id=manifest.parent_id,
                eval_metric=manifest.eval_metric,
                created_at_ms=manifest.created_at_ms,
            )
        generations.append(entry)
    body = {
        "live_generation": ctx.health.live_generation if ctx.health else None,
        "champion": registry.champion_id(),
        "generations": generations,
    }
    return Response(200, body, content_type="application/json")


@resource("POST", "/model/rollback/{generationID}")
def _model_rollback(ctx: ServingContext, req: Request) -> Response:
    """Republish an archived generation onto the update topic so every
    consumer (this instance, other serving replicas, the speed layer)
    converges on it, and move the CHAMPION pointer so subsequent batch
    runs gate/warm-start against the rolled-back generation."""
    registry = ctx.registry
    if registry is None:
        raise OryxServingException(404, "no model registry configured")
    if ctx.config.get_bool("oryx.serving.api.read-only"):
        raise OryxServingException(403, "serving layer is read-only")
    if ctx.rollback_publisher is None:
        raise OryxServingException(503, "no update topic configured")
    generation_id = req.params["generationID"]
    if not registry.has_generation(generation_id):
        raise OryxServingException(404, f"no such generation {generation_id}")
    key = ctx.rollback_publisher(generation_id)
    registry.set_champion(generation_id)
    metrics.registry.counter("serving.model.rollbacks").inc()
    log.warning("rollback: republished generation %s as %s", generation_id, key)
    body = {"generation_id": generation_id, "published_as": key}
    return Response(200, body, content_type="application/json")


@resource("GET", "/experiments")
def _experiments_report(ctx: ServingContext, req: Request) -> Response:
    """Online-experiment report (docs/experiments.md): arm assignment
    config, champion/challenger generations, per-arm online metrics and
    the standing online-gate decision. Always answers — with experiments
    disabled the body just says so."""
    if ctx.experiments is None:
        return Response(200, {"enabled": False, "active": False}, content_type="application/json")
    return Response(200, ctx.experiments.report(), content_type="application/json")


def _model_ready(ctx: ServingContext) -> bool:
    manager = ctx.model_manager
    if manager is None:
        return False
    min_fraction = ctx.config.get_float("oryx.serving.min-model-load-fraction")
    tenant_models = getattr(manager, "tenant_models", None)
    if tenant_models is not None:
        # multi-tenant mux: ready when EVERY tenant's model is loaded past
        # the threshold, since a replica missing one tenant's model would
        # answer that tenant 503
        models = tenant_models()
        if not models:
            return False
        return all(
            m is not None and getattr(m, "get_fraction_loaded", lambda: 1.0)() >= min_fraction
            for m in models.values()
        )
    model = manager.get_model()
    if model is None:
        return False
    return getattr(model, "get_fraction_loaded", lambda: 1.0)() >= min_fraction


def _observe_request(
    method: str, status: int, t0: float, layer=None, tenant: str | None = None
) -> None:
    dt = time.perf_counter() - t0
    metrics.registry.counter(f"serving.requests.{method}").inc()
    metrics.registry.counter(f"serving.responses.{status // 100}xx").inc()
    metrics.registry.histogram("serving.request.seconds").observe(dt)
    if layer is None:
        return
    # instance-scoped mirrors plus the per-generation counter that makes
    # a rotation observable: the live generation at response time is
    # stamped on the request
    im = layer.instance_metrics
    im.counter(f"serving.requests.{method}").inc()
    im.counter(f"serving.responses.{status // 100}xx").inc()
    im.histogram("serving.request.seconds").observe(dt)
    generation = layer.health.live_generation or "none"
    im.counter(f"serving.requests.generation.{generation}").inc()
    im.histogram(f"serving.request.seconds.generation.{generation}").observe(dt)
    if tenant is not None:
        # tenant-labeled twins: per-tenant rate and latency on a shared
        # multi-tenant layer (docs/multi-tenancy.md)
        im.counter(f"serving.requests.tenant.{tenant}").inc()
        im.histogram(f"serving.request.seconds.tenant.{tenant}").observe(dt)


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


class ServingLayer:
    def __init__(self, config: Config) -> None:
        default_device()  # the port serves from the card: fail now, not per request
        self.config = config
        refuse_compile_cache(config)
        tracing.configure_from(config)
        self.port = config.get_int("oryx.serving.api.port")
        self.context_path = config.get_string("oryx.serving.api.context-path").rstrip("/")
        self.read_only = config.get_bool("oryx.serving.api.read-only")
        self.user_name = config.get_optional_string("oryx.serving.api.user-name")
        self.password = config.get_optional_string("oryx.serving.api.password")
        if self.user_name and not self.password:
            # auth needs both: a missing password must not degrade to a
            # guessable credential
            raise ValueError("oryx.serving.api.user-name set without password")
        self.keystore_file = config.get_optional_string("oryx.serving.api.keystore-file")
        self.key_file = config.get_optional_string("oryx.serving.api.key-file")
        self.keystore_password = config.get_optional_string("oryx.serving.api.keystore-password")
        if bool(self.keystore_file) != bool(self.key_file):
            raise ValueError("oryx.serving.api.keystore-file and key-file must be set together")
        self.use_tls = bool(self.keystore_file)
        if self.use_tls:
            self.port = config.get_int("oryx.serving.api.secure-port")
        if self.user_name and not self.use_tls:
            # Basic credentials in cleartext need an explicit opt-in (a
            # deployment behind a TLS terminator)
            if not (config.get_optional_bool("oryx.serving.api.allow-insecure-auth") or False):
                raise ValueError(
                    "oryx.serving.api.user-name is set but TLS is not configured; "
                    "set keystore-file/key-file, or allow-insecure-auth = true "
                    "behind a TLS terminator"
                )
        self.no_init_topics = config.get_optional_bool("oryx.serving.no-init-topics") or False
        self.model_manager_class = config.get_optional_string("oryx.serving.model-manager-class")
        self.app_resources = config.get_optional_strings("oryx.serving.application-resources")
        if self.model_manager_class:
            check_port_module(self.model_manager_class, "oryx.serving.model-manager-class")
        for mod in self.app_resources or []:
            check_port_module(mod, "oryx.serving.application-resources")

        # multi-tenant mode (docs/multi-tenancy.md): the oryx.tenancy
        # block declares N tenants this one layer serves — None keeps the
        # single-tenant wiring
        from oryx_tpu_torch.tenancy.spec import TenantRegistry

        self.tenants = TenantRegistry.from_config(config)
        self.tenant_mux = None
        if self.tenants is not None:
            # one router hosts every tenant's app endpoints (a tenant's
            # class overrides were held to the port's modules at parse)
            merged = list(self.app_resources or [])
            for mod in self.tenants.resource_modules():
                if mod not in merged:
                    merged.append(mod)
            self.app_resources = merged

        # push oryx.serving.scan.* into the batcher's scheduler and the
        # scan before either spins up (the default batcher starts on first use)
        from oryx_tpu_torch.ops.streaming_topn import configure_scan
        from oryx_tpu_torch.serving.batcher import configure_fairness, configure_scheduler

        if self.tenants is not None and self.tenants.fair_share:
            # DRR fair scheduling in the batcher: each tenant's entries
            # drain from a private queue at its weighted share
            configure_fairness(self.tenants.weights(), self.tenants.quantum)
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

        # the model registry over the batch model dir: /model/generations
        # and rollback, the CHAMPION pointer that classifies a challenger,
        # and the index generations written under it
        from oryx_tpu_torch.registry.store import RegistryStore

        model_dir = config.get_optional_string("oryx.batch.storage.model-dir")
        self.registry_store = RegistryStore(model_dir) if model_dir else None
        # the update-topic producer, opened on first use (a rollback's
        # republish, an index generation's INDEX-REF); its lock serialises
        # whole publishes, so two rollbacks never interleave their bytes
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
        # this layer's own metrics: with several layers in one process the
        # module-global registry sums them, this one is the layer alone
        self.instance_metrics = metrics.MetricsRegistry()
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        self._close_lock = threading.Lock()
        self._close_done = False

        # MODEL-REF restage cache (docs/durability.md): referenced
        # generation dirs download locally through an atomic temp-dir +
        # rename; registered process-wide, so layers sharing a process
        # share one staged copy per generation
        self.model_stager = None
        restage_dir = config.get_optional_string("oryx.serving.restage-dir")
        if restage_dir:
            from oryx_tpu_torch.serving import restage

            self.model_stager = restage.ModelStager(restage_dir)
            restage.set_active(self.model_stager)

        # online experiments (docs/experiments.md): arm router, online
        # evaluator and evidence-gated promotion, built only with
        # oryx.serving.ab.fraction > 0 AND a registry (the CHAMPION
        # pointer classifies challenger publishes)
        self.experiments = None
        if self.registry_store is not None and config.get_float("oryx.serving.ab.fraction") > 0:
            from oryx_tpu_torch.experiments.coordinator import ExperimentCoordinator

            self.experiments = ExperimentCoordinator(
                config, self.registry_store, instance_metrics=self.instance_metrics
            )
        # live generation (and challenger) and duplicate-MODEL suppression
        # on the update stream
        self.generation_tracker = GenerationTracker(self.health, experiments=self.experiments)
        if self.experiments is not None:
            self.experiments.attach_tracker(self.generation_tracker)

        # adaptive overload control: the admission controller watches the
        # batcher's queue-wait EWMA, its queue depth and the requests in
        # flight against the oryx.serving.overload.* budget and walks the
        # shed ladder; None when disabled, so the request path pays nothing
        self.overload_config = _overload.OverloadConfig.from_config(config)
        self.admission = (
            _overload.AdmissionController(
                self.overload_config,
                signals=self._overload_signals,
                instance_metrics=self.instance_metrics,
                generation_fn=lambda: self.health.live_generation,
            )
            if self.overload_config.enabled
            else None
        )
        if self.admission is not None and self.tenants is not None:
            from oryx_tpu_torch.serving.batcher import default_tenant_depths

            # per-tenant shed ladders: a noisy tenant's own queue depth
            # (against its weighted share) walks its private ladder
            self.admission.configure_tenants(self.tenants.weights(), default_tenant_depths)

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
            or self._server_thread is not None
            or self._native_front is not None
            or self._update_consumer is not None
        ):
            raise RuntimeError(
                "ServingLayer.start() called twice (or retried after a "
                "partial start): the live HTTP server, update consumer, "
                "and consume thread would be overwritten and leak"
            )
        retain_default_batcher()
        self._batcher_retained = True
        cfg = self.config
        input_broker_loc = cfg.get_optional_string("oryx.input-topic.broker")
        input_topic = cfg.get_optional_string("oryx.input-topic.message.topic")
        update_broker_loc = cfg.get_optional_string("oryx.update-topic.broker")
        update_topic = cfg.get_optional_string("oryx.update-topic.message.topic")

        if self.tenants is None and input_broker_loc and input_topic and not self.read_only:
            broker = get_broker(input_broker_loc)
            if not self.no_init_topics:
                broker.create_topic(
                    input_topic, cfg.get_optional_int("oryx.input-topic.message.partitions") or 1
                )
            self.input_producer = broker.producer(input_topic)

        if self.experiments is not None and input_broker_loc and input_topic:
            # online evaluator: follow the input topic live (new events
            # only — historical interactions can't join future serves)
            broker = get_broker(input_broker_loc)
            if not self.no_init_topics:
                broker.create_topic(
                    input_topic, cfg.get_optional_int("oryx.input-topic.message.partitions") or 1
                )
            self.experiments.start(broker.consumer(input_topic))

        if self.tenants is not None:
            # one runtime per tenant behind the mux facades replaces the
            # single manager/consumer pair
            self._start_tenants(cfg, input_broker_loc, update_broker_loc)
        elif self.model_manager_class:
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
        rollback_publisher = None
        if self.registry_store is not None and update_broker_loc and update_topic:
            max_size = cfg.get_int("oryx.update-topic.message.max-size")

            def rollback_publisher(generation_id: str) -> str:
                from oryx_tpu_torch.registry.store import publish_generation

                # the lock covers the whole publish: concurrent rollbacks
                # serialise, so the last one to publish wins cleanly
                with self._update_producer_lock:
                    if self._update_producer is None:
                        self._update_producer = get_broker(update_broker_loc).producer(
                            update_topic
                        )
                    return publish_generation(
                        self.registry_store,
                        generation_id,
                        self._update_producer,
                        max_size,
                        retry_policy=self.retry_policy,
                    )

        ctx = ServingContext(
            self.model_manager,
            self.input_producer,
            self.config,
            self.health,
            registry=self.registry_store,
            rollback_publisher=rollback_publisher,
            instance_metrics=self.instance_metrics,
            admission=self.admission,
            experiments=self.experiments,
        )
        threads = cfg.get_optional_int("oryx.serving.api.threads") or 64
        tls_ctx = None
        if self.use_tls:
            import ssl

            # the listener stays plaintext; each accepted socket is wrapped
            # on a pool worker so a stalled handshake cannot starve accept()
            tls_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            tls_ctx.minimum_version = ssl.TLSVersion.TLSv1_2
            tls_ctx.load_cert_chain(
                certfile=self.keystore_file,
                keyfile=self.key_file,
                password=self.keystore_password,
            )
        # the native front when oryx.serving.native.* allows it and g++
        # builds it; None on any decline (TLS and auth among them), and
        # the stdlib server serves
        self._native_front = _native_mod.maybe_start(self, ctx, threads)
        if self._native_front is not None:
            self.port = self._native_front.port
            ledger.register(
                "thread", self._native_front.poll_thread, live=threading.Thread.is_alive
            )
        else:
            self._server = _PooledHTTPServer(
                ("0.0.0.0", self.port), _make_handler(self, ctx), threads, tls_ctx=tls_ctx
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
        stream's health and each applied block stamping the update time.
        A block whose transport carried a trace header feeds the
        freshness histogram and is applied inside a span that continues
        the publisher's trace (``serving.model.apply`` for a MODEL,
        ``serving.apply`` otherwise)."""
        consumer = self._update_consumer
        while not self._stop_event.is_set() and not consumer.closed():
            try:
                block = consumer.poll_block(max_records=10_000, timeout=0.2)
            except Exception:
                self.health.mark_stream_down()
                raise
            self.health.mark_stream_ok()
            raw_trace = getattr(block, "trace", None)
            # track the live generation and drop a second delivery of its
            # MODEL before the manager sees the block
            block = self.generation_tracker.filter_block(block)
            if block is not None and len(block) > 0:
                # generation-aware managers read the challenger id while
                # they consume, to load a challenger without swapping it live
                with _exp_routing.consume_challenger(
                    self.generation_tracker.challenger_generation
                ), self._apply_span(raw_trace, block, self.health):
                    yield block
                self.health.mark_update()
                if self._native_front is not None and _block_has_model(block):
                    # a MODEL apply flips readiness and the live generation
                    # now: the native snapshots do not wait for the next tick
                    self._native_front.push_snapshots()

    # -- multi-tenant wiring (docs/multi-tenancy.md) ---------------------------

    def _start_tenants(self, cfg, input_broker_loc, update_broker_loc) -> None:
        """One serving runtime per tenant — private model manager, health,
        generation tracker, registry store, and a namespaced update-topic
        consumer replaying from offset 0 — multiplexed behind the single
        ``ServingContext`` surface the resource handlers already use."""
        from functools import partial

        from oryx_tpu_torch.registry.store import RegistryStore
        from oryx_tpu_torch.tenancy.mux import TenantInputMux, TenantRuntime, TenantServingMux
        from oryx_tpu_torch.tenancy.spec import tenant_config

        runtimes: dict[str, TenantRuntime] = {}
        producers: dict = {}
        for spec in self.tenants:
            tid = spec.tenant_id
            tcfg = tenant_config(cfg, spec)
            manager = load_instance_of(spec.wiring("serving-manager"), tcfg)
            health = ServingHealth()
            tracker = GenerationTracker(health)
            model_dir = tcfg.get_optional_string("oryx.batch.storage.model-dir")
            rt = TenantRuntime(
                spec, tcfg, manager, health, tracker,
                store=RegistryStore(model_dir) if model_dir else None,
            )
            tenant_input = tcfg.get_optional_string("oryx.input-topic.message.topic")
            if input_broker_loc and tenant_input and not self.read_only:
                broker = get_broker(input_broker_loc)
                if not self.no_init_topics:
                    broker.create_topic(
                        tenant_input,
                        tcfg.get_optional_int("oryx.input-topic.message.partitions") or 1,
                    )
                rt.producer = broker.producer(tenant_input)
                producers[tid] = rt.producer
            tenant_update = tcfg.get_optional_string("oryx.update-topic.message.topic")
            if update_broker_loc and tenant_update:
                broker = get_broker(update_broker_loc)
                if not self.no_init_topics:
                    broker.create_topic(
                        tenant_update,
                        tcfg.get_optional_int("oryx.update-topic.message.partitions") or 1,
                    )
                rt.consumer = broker.consumer(tenant_update, from_beginning=True)
                rt.thread = SupervisedThread(
                    f"ServingUpdateConsumer-{tid}",
                    partial(self._consume_tenant_updates, rt),
                    self.retry_policy,
                    self._stop_event,
                    metrics_prefix="serving.consume",
                )
                health.consume_thread = rt.thread
                rt.thread.start()
            runtimes[tid] = rt
        self.tenant_mux = TenantServingMux(runtimes, self.tenants.default_tenant)
        self.model_manager = self.tenant_mux
        if producers:
            self.input_producer = TenantInputMux(producers, self.tenants.default_tenant)

    def _consume_tenant_updates(self, rt) -> None:
        rt.manager.consume_blocks(self._tenant_blocks(rt))

    def _tenant_blocks(self, rt):
        """The per-tenant twin of :meth:`_health_blocks`: the same stream
        health marks, duplicate-MODEL suppression, freshness accounting
        and apply spans (each carrying the tenant id), against the
        tenant's own consumer, tracker and health."""
        consumer = rt.consumer
        while not self._stop_event.is_set() and not consumer.closed():
            try:
                block = consumer.poll_block(max_records=10_000, timeout=0.2)
            except Exception:
                rt.health.mark_stream_down()
                raise
            rt.health.mark_stream_ok()
            raw_trace = getattr(block, "trace", None)
            block = rt.tracker.filter_block(block)
            if block is not None and len(block) > 0:
                with self._apply_span(raw_trace, block, rt.health, rt.spec.tenant_id):
                    yield block
                rt.health.mark_update()

    @contextlib.contextmanager
    def _apply_span(self, raw_trace, block, health, tenant: str | None = None):
        """The publish -> apply half of a traced update: observe the
        block's freshness, and when it carries the publisher's context,
        run the apply (the manager's processing of the block) in a span
        whose parent is the publisher's span."""
        info = observe_block_freshness(raw_trace, self.instance_metrics)
        if info is None or info.ctx is None:
            yield
            return
        attrs = {"instance": self.port, "records": len(block)}
        if tenant is not None:
            attrs["tenant"] = tenant
        name = "serving.model.apply" if _block_has_model(block) else "serving.apply"
        with tracing.use(info.ctx), tracing.span(name, attrs=attrs) as sp:
            if info.ingest_ms is not None:
                sp.set("skew_ms", round(time.time() * 1000 - info.ingest_ms, 3))
            yield
            if health.live_generation is not None:
                sp.set("generation", health.live_generation)

    # -- in-flight requests and drain ----------------------------------------

    def _request_began(self) -> None:
        with self._inflight_cond:
            self._inflight += 1
            n = self._inflight
        self.instance_metrics.gauge("serving.requests.in-flight").set(n)

    def _request_ended(self) -> None:
        with self._inflight_cond:
            self._inflight -= 1
            n = self._inflight
            if n <= 0:
                self._inflight_cond.notify_all()
        self.instance_metrics.gauge("serving.requests.in-flight").set(n)

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
        self.instance_metrics.gauge("serving.draining").set(1)
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

    def close(self, drain_seconds: float = 0.0) -> None:
        """Stop the layer; with ``drain_seconds``, readiness goes 503 first
        and requests in flight get that long to complete."""
        with self._close_lock:
            if self._close_done:
                return
            self._close_done = True
        if drain_seconds > 0:
            self.begin_drain()
            if not self.drain(drain_seconds):
                log.warning(
                    "close: %d request(s) still in flight after %.1fs drain",
                    self.inflight_requests,
                    drain_seconds,
                )
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
        if self.tenant_mux is not None:
            # close every tenant consumer first (unblocks the polls), then
            # join the consume threads
            runtimes = self.tenant_mux.runtimes()
            for rt in runtimes.values():
                if rt.consumer is not None:
                    rt.consumer.close()
            for rt in runtimes.values():
                if rt.thread is not None:
                    rt.thread.join(timeout=5)
                    if rt.thread.is_alive():
                        log.warning("serving thread %r still alive after 5s join", rt.thread.name)
        if self._index_maintainer is not None:
            self._index_maintainer.close()
        if self.model_manager is not None:
            self.model_manager.close()
        if self.experiments is not None:
            self.experiments.close()
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
        if self.model_stager is not None:
            from oryx_tpu_torch.serving import restage

            # clear the process-wide hook only while it is still ours: a
            # layer started after this one may have registered its own
            if restage.active() is self.model_stager:
                restage.set_active(None)

    def __enter__(self) -> "ServingLayer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def observe_block_freshness(raw_trace, instance_metrics=None):
    """Parse an update block's transport-carried ``@trc`` header and feed
    the freshness histogram: seconds from the origin timestamp the
    publisher stamped (earliest event-ingest time for speed updates,
    publish time for model publishes) to visibility on this replica.
    Returns the parsed :class:`tracing.BlockTrace` (or None) so the
    caller can continue the publisher's trace."""
    info = tracing.parse_header(raw_trace)
    if info is None:
        return None
    if info.ingest_ms is not None:
        age_s = max(0.0, time.time() - info.ingest_ms / 1000.0)
        metrics.registry.histogram("serving.freshness.seconds").observe(age_s)
        if instance_metrics is not None:
            instance_metrics.histogram("serving.freshness.seconds").observe(age_s)
    return info


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
    the request span and the per-stage counters.

    While an online experiment is active the request is first assigned an
    arm: dispatch runs under a generation override (generation-aware
    managers serve the challenger's model to the challenger arm), the arm
    lands on the X-Oryx-Experiment-Arm header and the request span, and
    the serve is recorded with the evaluator for the interaction join."""
    t_arrive = time.perf_counter()
    experiments = layer.experiments
    assignment = (
        experiments.assign_request(req.path, req.headers) if experiments is not None else None
    )

    def _dispatch():
        if experiments is not None:
            # pin every request to the tracker's generation for its arm
            # (challenger for the challenger arm, live for everything
            # else); managers without per-generation retention ignore it
            generation = assignment[1] if assignment is not None else layer.health.live_generation
            with _exp_routing.serve_generation(generation):
                return layer.router.dispatch(ctx, req)
        return layer.router.dispatch(ctx, req)

    tenant = _tenancy.current_tenant()
    admission = layer.admission
    decision = (
        admission.decide(req.method, req.path, tenant=tenant)
        if admission is not None
        else None
    )

    def _champion_generation():
        # the generation stale-cache entries are stamped with and checked
        # against: the tenant's own live one on a multi-tenant layer (each
        # tenant has a private lineage), the tracker's otherwise
        if tenant is not None and layer.tenant_mux is not None:
            rt = layer.tenant_mux.runtime(tenant)
            return rt.health.live_generation if rt is not None else None
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
                    response = _dispatch()
                if getattr(response, "status", 200) == 200:
                    served = "reduced-probe"
            else:
                response = _dispatch()
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
                # challenger answers never enter the stale cache: it is
                # stamped with the champion generation
                and (assignment is None or assignment[0] != _exp_routing.ARM_CHALLENGER)
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
        _overload.count_shed(
            served,
            layer.instance_metrics,
            generation=(
                assignment[1]
                if assignment is not None
                else (_champion_generation() or layer.health.live_generation)
            ),
            tenant=tenant,
        )
        headers = getattr(response, "headers", None)
        if headers is not None:
            headers[_overload.SHED_HEADER] = served
        if sp is not None:
            sp.set("shed_stage", served)
    if assignment is not None:
        arm, generation, user = assignment
        headers = getattr(response, "headers", None)
        if headers is not None:
            headers[_exp_routing.ARM_HEADER] = arm
        if sp is not None:
            sp.set("experiment_arm", arm)
            if generation is not None:
                sp.set("experiment_generation", generation)
        items = (
            _served_items(getattr(response, "body", None))
            if getattr(response, "status", 200) == 200
            else ()
        )
        experiments.observe_request(
            user,
            arm,
            generation,
            items,
            latency_s=time.perf_counter() - t_arrive,
            shed_stage=served,
        )
    return response


def _served_items(body):
    """Item ids in a recommendation response body, in rank order, for the
    online join. Understands the shapes the app endpoints produce: a dict
    with an ``items`` list, and a ranked list of item / (item, score) /
    id-value entries.

    The id-value records (``IDValue``, what ALS's /recommend returns) are
    the port's addition: the JAX package reads them as no items, so its
    ALS serves never join an interaction and the online gate never
    concludes on an ALS experiment."""
    if isinstance(body, dict):
        items = body.get("items")
        if isinstance(items, list):
            return [str(i) for i in items]
        return ()
    if isinstance(body, list):
        out = []
        for entry in body:
            if isinstance(entry, (list, tuple)) and entry:
                out.append(str(entry[0]))
            elif isinstance(entry, (str, int)):
                out.append(str(entry))
            elif isinstance(getattr(entry, "id", None), str):
                out.append(entry.id)
        return out
    return ()


def _check_auth(layer: ServingLayer, headers) -> None:
    """Basic-auth gate shared by both fronts; raises 401 on failure."""
    if not layer.user_name:
        return
    auth = headers.get("Authorization", "") or ""
    if not auth.startswith("Basic "):
        raise OryxServingException(401, "unauthorized")
    try:
        userpass = base64.b64decode(auth[6:]).decode("utf-8")
    except Exception:
        raise OryxServingException(401, "unauthorized")
    if not hmac.compare_digest(userpass, f"{layer.user_name}:{layer.password}"):
        raise OryxServingException(401, "unauthorized")


def gzip_compress(body: bytes) -> bytes:
    """Deterministic response gzip (mtime pinned): the same body always
    gives the same bytes, which keeps the native and stdlib fronts
    byte-equal across the gzip rung."""
    return gzip.compress(body, mtime=0)


def _dispatch_parsed(layer: ServingLayer, ctx: ServingContext, method: str, raw_path: str,
                     headers, body: bytes, tenant_box):
    """The front-agnostic request core: everything between a parsed
    request and a rendered (status, payload, content-type, extra headers)
    tuple. The stdlib handler and the native front's dispatch workers
    (``serving/native_front.py``) both call it, so tenant resolution,
    admission, tracing, experiments and rendering cannot drift between
    fronts. ``headers`` needs a case-insensitive ``get`` and ``items()``
    (``email.Message`` and ``native_front._Headers`` both qualify);
    ``tenant_box[0]`` receives the resolved tenant even when dispatch
    later raises."""
    _check_auth(layer, headers)
    split = urlsplit(raw_path)
    path = split.path
    if layer.context_path:
        if not path.startswith(layer.context_path):
            raise OryxServingException(404, "outside context path")
        path = path[len(layer.context_path):] or "/"
    # tenant resolution (docs/multi-tenancy.md): the /t/<tenant>/ prefix
    # wins over the X-Oryx-Tenant header; untenanted data-plane requests
    # fall to the default tenant. Resolved before routing so the stripped
    # path matches the resources, and scoped over the dispatch so the
    # batcher, admission and mux all see it.
    tenant = None
    if layer.tenants is not None:
        tenant, path = _tenancy.split_tenant_path(path)
        if tenant is None:
            tenant = headers.get(_tenancy.TENANT_HEADER)
        if tenant is None and not _overload.exempt(path):
            tenant = layer.tenants.default_tenant
        if tenant is not None and tenant not in layer.tenants:
            raise OryxServingException(404, f"unknown tenant {tenant!r}")
        tenant_box[0] = tenant
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
    # stale rung serves; the tenant rides in front so two tenants'
    # answers for the same path never alias in the cache
    cache_key = path + ("?" + split.query if split.query else "")
    if tenant is not None:
        cache_key = f"/t/{tenant}{cache_key}"
    attrs = {"path": path, "method": req.method}
    if tenant is not None:
        attrs["tenant"] = tenant
    incoming = tracing.parse_traceparent(headers.get("traceparent"))
    with _tenancy.tenant_scope(tenant):
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
            tenant_box = [None]
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                status, payload, ct, extra = _dispatch_parsed(
                    layer, ctx, method, self.path, self.headers, body, tenant_box
                )
            except OryxServingException as e:
                _observe_request(method, e.status, t0, layer, tenant_box[0])
                self._send_error(e.status, e.message)
                return
            except Exception:
                log.exception("internal error handling %s %s", method, self.path)
                _observe_request(method, 500, t0, layer, tenant_box[0])
                self._send_error(500, "internal error")
                return
            _observe_request(method, status, t0, layer, tenant_box[0])
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
            if status == 401:
                self.send_header("WWW-Authenticate", 'Basic realm="Oryx"')
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
