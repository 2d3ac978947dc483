"""ctypes binding for the native (C++) serving data plane (counterpart
of ``oryx_tpu/serving/native_front.py``).

``maybe_start()`` is the single entry point: the serving layer calls it
during start() and either gets a running :class:`NativeFront` (the epoll
front owns the listen socket; the stdlib server is never created) or
``None`` (any decline — disabled by config, TLS or Basic auth configured,
toolchain missing — and the layer falls back to the pooled stdlib server
with identical behavior).

The division of labor (docs/serving-native.md):

- C++ (native/httpfront.cpp) accepts, parses, and classifies every
  request without the GIL. Cheap rungs — /healthz //readyz //ready
  snapshots, overload fast-429, champion-gated stale answer-cache hits —
  are answered natively from byte templates this module pre-renders with
  the REAL Python resources, so the bytes on the wire are the Python
  front's bytes (only the Date header is stamped in C++, in the same
  IMF-fixdate format).
- Everything else crosses the boundary once, as a micro-batched RBLK
  KIND_HTTP frame (bus/blockcodec.py), and runs through the exact same
  ``layer._dispatch_parsed`` core the stdlib handler uses — tenant
  resolution, admission ladder, tracing, experiments, rendering cannot
  drift between fronts.
- A control thread pushes ladder/tenant snapshots down (overload.py
  stays the single decision-maker; C++ only applies the last pushed
  stage), mirrors answer-cache puts, re-renders liveness snapshots, and
  drains native stats/trace events back into the Python registries.

Parity contract: for every request the native front chooses to answer,
the response bytes are identical to what the Python front would have
produced (tests/test_torch_native_front.py holds the line). When in
doubt the front forwards — csv Accept negotiation, gzip-eligible bodies,
tenant-prefixed control paths, experiments (A/B arms) all route through
Python rather than risk divergence.

Port note: a copy with the port's imports. The C++ side,
``oryx_tpu_torch/native/httpfront.cpp``, is the JAX package's byte for
byte, so the tenant table pushed here and the per-tenant stats slots
drained here keep that package's wire layout.
"""

from __future__ import annotations

import ctypes
import logging
import struct
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from email.utils import formatdate
from http.server import BaseHTTPRequestHandler

from oryx_tpu_torch import native
from oryx_tpu_torch.bus import blockcodec
from oryx_tpu_torch.common import metrics, tracing
from oryx_tpu_torch.serving import overload as _overload
from oryx_tpu_torch.serving.web import OryxServingException, Request, render
from oryx_tpu_torch.tenancy import context as _tenancy

log = logging.getLogger(__name__)

# mirrors BaseHTTPRequestHandler.version_string() of the layer's stdlib
# handler: "oryx_tpu Python/3.x.y"
_SERVER = f"oryx_tpu Python/{sys.version.split()[0]}"

# liveness endpoints pre-rendered into C++ (post-context-strip forms)
_SNAPSHOT_PATHS = ("/healthz", "/readyz", "/ready")

# hf_stats slot names, in the exact order httpfront.cpp writes them
_SCALARS = (
    "conns_accepted", "conns_closed", "requests", "forwarded",
    "parse_errors", "ans_snapshot", "ans_shed", "ans_stale",
    "m_get", "m_post", "m_delete", "m_head", "m_other",
    "c1xx", "c2xx", "c3xx", "c4xx", "c5xx",
    "lat_count", "lat_sum_us", "events_dropped", "responses_dropped",
    "bytes_in", "bytes_out", "pending_hwm",
)
_N_BUCKETS = 29  # 28 latency buckets + overflow (metrics.Histogram mirror)
_TENANT_SLOTS = 4 + _N_BUCKETS
_TRACE_REC = 184
_TRACE_CAP = 4096  # matches kMaxEvents so one drain empties the ring

_METHOD_NAMES = ("GET", "POST", "DELETE", "HEAD", "OTHER")
_RUNG_NAMES = ("snapshot", "shed", "stale")


def _reason(status: int) -> str:
    entry = BaseHTTPRequestHandler.responses.get(status)
    return entry[0] if entry else ""


def _http_date() -> str:
    return formatdate(time.time(), usegmt=True)


class _Headers:
    """Case-insensitive ``get`` over the original-cased header pairs —
    the same contract email.Message gives ``_dispatch_parsed``."""

    __slots__ = ("_pairs",)

    def __init__(self, pairs):
        self._pairs = pairs

    def get(self, name, default=None):
        lname = name.lower()
        for k, v in self._pairs:
            if k.lower() == lname:
                return v
        return default

    def items(self):
        return list(self._pairs)


def _template_pre(status):
    """Everything up to the Date value; C++ stamps the date at send time
    in the same IMF-fixdate format formatdate(usegmt=True) emits."""
    return (
        f"HTTP/1.1 {status} {_reason(status)}\r\nServer: {_SERVER}\r\nDate: "
    ).encode("latin-1")


def _success_template(status, payload, ct, extra):
    """Template for a rendered (render()) response: mirrors
    Handler._handle_counted's write path byte for byte. The gzip rung is
    handled by C++ forwarding instead (accept_blocks_native), so the
    template always holds the identity body."""
    body = payload
    pre = _template_pre(status)
    lines = [f"Content-Type: {ct}", f"Content-Length: {len(body)}"]
    for k, v in dict(extra).items():
        lines.append(f"{k}: {v}")
    post = ("\r\n" + "\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body
    return pre, post, len(body), status


def _error_template(status, message):
    """Template for _send_error(): plain text body, written even for
    HEAD (body_len 0 disables C++ HEAD stripping to match)."""
    body = f"{status} {message}\n".encode("utf-8")
    pre = _template_pre(status)
    lines = []
    if status == 401:
        lines.append('WWW-Authenticate: Basic realm="Oryx"')
    lines.append("Content-Type: text/plain")
    lines.append(f"Content-Length: {len(body)}")
    post = ("\r\n" + "\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body
    return pre, post, 0, status


def _u8(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else \
        (ctypes.c_uint8 * 1)()


def maybe_start(layer, ctx, threads):
    """Start the native front for ``layer`` or return None (fallback).

    Declines (each logged at most once, loudly only when the operator
    forced ``enabled = "true"``):

    - ``oryx.serving.native.enabled = "false"``
    - TLS or Basic auth configured: the stdlib front owns the TLS wrap
      and the 401 gate; a native snapshot answer would bypass auth
    - more tenants than the C++ table holds
    - toolchain missing / native build disabled (ORYX_NATIVE=0)
    """
    cfg = layer.config
    mode = (cfg.get_string("oryx.serving.native.enabled") or "auto").lower()
    if mode not in ("auto", "true", "false"):
        raise ValueError(
            f"oryx.serving.native.enabled must be auto/true/false, got {mode!r}"
        )
    if mode == "false":
        return None
    forced = mode == "true"
    if layer.use_tls or layer.user_name:
        if forced:
            log.warning(
                "oryx.serving.native.enabled=true but TLS/auth is configured; "
                "falling back to the Python front"
            )
        return None
    if layer.tenants is not None and len(layer.tenants.ids()) > 64:
        if forced:
            log.warning(
                "oryx.serving.native.enabled=true but >64 tenants configured; "
                "falling back to the Python front"
            )
        return None
    lib = native.get_library()
    if lib is None or not hasattr(lib, "hf_create"):
        if forced:
            log.warning(
                "oryx.serving.native.enabled=true but the native library is "
                "unavailable (no toolchain or ORYX_NATIVE=0); falling back"
            )
        return None
    max_header = cfg.get_int("oryx.serving.native.max-header-bytes")
    max_body = cfg.get_int("oryx.serving.native.max-body-bytes")
    idle_s = cfg.get_float("oryx.serving.native.idle-timeout-s")
    max_conns = cfg.get_int("oryx.serving.native.max-connections")
    handle = lib.hf_create(layer.port, 128, max_header, max_body, idle_s,
                           max_conns)
    if not handle:
        log.warning("native front failed to bind :%d; falling back",
                    layer.port)
        return None
    front = NativeFront(layer, ctx, lib, handle, threads,
                        max_header=max_header, max_body=max_body)
    front.start()
    return front


class NativeFront:
    def __init__(self, layer, ctx, lib, handle, threads, *, max_header,
                 max_body):
        self._layer = layer
        self._ctx = ctx
        self._lib = lib
        self._handle = handle
        self.port = lib.hf_port(handle)
        cfg = layer.config
        self._interval_s = max(
            0.005, cfg.get_float("oryx.serving.native.control-interval-ms")
            / 1000.0)
        dispatch = cfg.get_optional_int("oryx.serving.native.dispatch-threads")
        self._pool = ThreadPoolExecutor(
            max_workers=dispatch or threads, thread_name_prefix="NativeServe"
        )
        # one full-size record always fits: header + target + headers + body
        self._poll_cap = 64 * 1024 + int(max_header) + int(max_body) + 256
        self._poll_buf = (ctypes.c_uint8 * self._poll_cap)()
        self._trace_buf = (ctypes.c_uint8 * (_TRACE_CAP * _TRACE_REC))()
        self._tenant_names = (
            list(layer.tenants.ids()) if layer.tenants is not None else []
        )
        self._stats_need = len(_SCALARS) + _N_BUCKETS + \
            len(self._tenant_names) * _TENANT_SLOTS
        self._stats_buf = (ctypes.c_uint64 * self._stats_need)()
        # _stats_buf/_trace_buf are shared between the control tick and
        # the on-demand scrape drain in _serve_one
        self._drain_lock = threading.Lock()
        self._stop = threading.Event()
        self._respond_lock = threading.Lock()
        self._closed = False
        self._close_lock = threading.Lock()
        self._closing = False
        # answer-cache mirror: overload.AnswerCache.put -> this queue ->
        # control tick renders and pushes the template down to C++
        self._cache_queue: deque = deque()
        self._mirror_generation = None
        self.poll_thread: threading.Thread | None = None
        self._control_thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.poll_thread is not None or self._control_thread is not None:
            raise RuntimeError("NativeFront.start() called twice")
        layer = self._layer
        ctx_path = (layer.context_path or "").encode("latin-1")
        self._lib.hf_set_context(self._handle, _u8(ctx_path), len(ctx_path))
        items = [p.encode("latin-1") for p in _overload._EXEMPT_PREFIXES]
        blob = struct.pack("<I", len(items)) + b"".join(
            struct.pack("<H", len(i)) + i for i in items
        )
        self._lib.hf_set_exempt(self._handle, _u8(blob), len(blob))
        self._lib.hf_cache_cap(self._handle,
                               layer.overload_config.cache_entries)
        self._push_shed_template()
        if layer.admission is not None:
            layer.admission.cache.listener = self._on_cache_put
        self.push_control()
        self.poll_thread = threading.Thread(
            target=self._poll_loop, name="NativePoll", daemon=True
        )
        self.poll_thread.start()
        self._control_thread = threading.Thread(
            target=self._control_loop, name="NativeControl", daemon=True
        )
        self._control_thread.start()

    def close(self) -> None:
        with self._close_lock:
            if self._closing:
                return
            self._closing = True
        self._stop.set()
        if self._control_thread is not None:
            self._control_thread.join(timeout=5)
        # two-phase teardown: shutdown unblocks hf_poll (-1) and closes
        # sockets but keeps the handle alive so in-flight hf_respond
        # calls return -1 instead of touching freed memory; hf_close
        # only runs once every thread that could hold the handle is done
        self._lib.hf_shutdown(self._handle)
        if self.poll_thread is not None:
            self.poll_thread.join(timeout=5)
        self._pool.shutdown(wait=True, cancel_futures=True)
        adm = self._layer.admission
        if adm is not None and adm.cache.listener is self._on_cache_put:
            adm.cache.listener = None
        try:
            self._drain_stats()
            self._drain_trace()
        except Exception:
            log.exception("final native stats drain failed")
        # _handle itself is never reassigned: _closed (set under the
        # respond lock) is the gate that keeps hf_respond from touching
        # the handle after hf_close frees it
        with self._respond_lock:
            self._closed = True
        self._lib.hf_close(self._handle)

    # -- forwarded-request data plane ---------------------------------------

    def _poll_loop(self) -> None:
        lib, handle = self._lib, self._handle
        buf, cap = self._poll_buf, self._poll_cap
        while True:
            n = lib.hf_poll(handle, buf, cap, 250)
            if n < 0:
                return  # shutdown
            if n == 0:
                continue
            raw = ctypes.string_at(buf, n)
            try:
                frame = blockcodec.decode_frame(raw)
                records = blockcodec.decode_http_records(
                    frame.payload, frame.count
                )
            except blockcodec.FrameError:
                log.exception("native front produced an undecodable frame")
                metrics.registry.counter("serving.http.frame.errors").inc()
                continue
            for rec in records:
                self._pool.submit(self._serve_one, rec)

    def _serve_one(self, rec) -> None:
        """Mirror of Handler._handle for one pre-parsed request."""
        layer = self._layer
        t0 = time.perf_counter()
        layer._request_began()
        try:
            path = rec.target.split("?", 1)[0]
            ctxp = layer.context_path or ""
            if ctxp and path.startswith(ctxp):
                path = path[len(ctxp):]
            if path.startswith(("/metrics", "/trace")):
                # an ops scrape must reflect every request answered so
                # far — including ones C++ answered since the last
                # control tick — so fold the native counters/spans in
                # before the handler renders the snapshot
                self._drain_stats()
                self._drain_trace()
            headers = _Headers(rec.headers)
            tenant_box = [None]
            try:
                from oryx_tpu_torch.serving.layer import (_dispatch_parsed,
                                                    _observe_request)
                status, payload, ct, extra = _dispatch_parsed(
                    layer, self._ctx, rec.method, rec.target, headers,
                    rec.body, tenant_box,
                )
            except OryxServingException as e:
                _observe_request(rec.method, e.status, t0, layer,
                                 tenant_box[0])
                self._respond(rec, self._error_bytes(e.status, e.message))
                return
            except Exception:
                log.exception("internal error handling %s %s", rec.method,
                              rec.target)
                _observe_request(rec.method, 500, t0, layer, tenant_box[0])
                self._respond(rec, self._error_bytes(500, "internal error"))
                return
            _observe_request(rec.method, status, t0, layer, tenant_box[0])
            self._respond(
                rec,
                self._assemble(status, payload, ct, extra,
                               headers.get("Accept-Encoding", ""),
                               rec.method == "HEAD"),
            )
        finally:
            layer._request_ended()

    def _assemble(self, status, payload, ct, extra, accept_encoding,
                  is_head) -> bytes:
        """Byte-for-byte mirror of Handler._handle_counted's write path."""
        from oryx_tpu_torch.serving.layer import gzip_compress

        body = payload
        headers = dict(extra)
        if len(body) > 1024 and "gzip" in accept_encoding:
            body = gzip_compress(body)
            headers["Content-Encoding"] = "gzip"
        lines = [
            f"HTTP/1.1 {status} {_reason(status)}",
            f"Server: {_SERVER}",
            f"Date: {_http_date()}",
            f"Content-Type: {ct}",
            f"Content-Length: {len(body)}",
        ]
        for k, v in headers.items():
            lines.append(f"{k}: {v}")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        return head if is_head else head + body

    def _error_bytes(self, status, message) -> bytes:
        """Byte-for-byte mirror of Handler._send_error (the error body is
        written even for HEAD, matching the Python front)."""
        body = f"{status} {message}\n".encode("utf-8")
        lines = [
            f"HTTP/1.1 {status} {_reason(status)}",
            f"Server: {_SERVER}",
            f"Date: {_http_date()}",
        ]
        if status == 401:
            lines.append('WWW-Authenticate: Basic realm="Oryx"')
        lines.append("Content-Type: text/plain")
        lines.append(f"Content-Length: {len(body)}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body

    def _respond(self, rec, data: bytes) -> None:
        with self._respond_lock:
            if self._closed:
                return
            self._lib.hf_respond(self._handle, rec.conn_id, rec.req_id,
                                 _u8(data), len(data), 0)

    # -- control plane -------------------------------------------------------

    def _control_loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self.push_control()
            except Exception:
                log.exception("native front control tick failed")

    def push_control(self) -> None:
        """One control tick: evaluate the ladder, push stages + tenant
        stages + fresh snapshots down, mirror cache puts, drain stats and
        trace events back up. Public so tests can force a tick."""
        adm = self._layer.admission
        if adm is not None:
            try:
                adm.evaluate()
            except Exception:
                log.exception("admission evaluate failed")
        self._push_ladder()
        self._sync_cache()
        self.push_snapshots()
        self._drain_stats()
        self._drain_trace()

    def _flags(self) -> int:
        layer = self._layer
        flags = 0
        # experiments assign sticky A/B arms and stamp ARM_HEADER on
        # data-plane responses; every native rung would skip that, so all
        # native answering is off while an experiment coordinator exists
        if layer.experiments is None:
            flags |= 1  # snapshots
            if layer.admission is not None:
                flags |= 2 | 4  # shed fast-429 + stale cache rungs
        if layer.tenants is not None:
            flags |= 8
        return flags

    def _push_ladder(self) -> None:
        layer = self._layer
        adm = layer.admission
        stage = adm.stage if adm is not None else 0
        retry = layer.overload_config.retry_after_s
        self._lib.hf_set_ladder(self._handle, stage, retry, self._flags())
        if layer.tenants is not None and adm is not None:
            names = self._tenant_names
            try:
                default_idx = names.index(layer.tenants.default_tenant)
            except ValueError:
                default_idx = -1
            parts = [struct.pack("<iI", default_idx, len(names))]
            for name in names:
                nb = name.encode("utf-8")
                parts.append(
                    struct.pack("<HBB", len(nb), adm.tenant_stage(name), 0)
                    + nb
                )
            blob = b"".join(parts)
            self._lib.hf_set_tenants(self._handle, _u8(blob), len(blob))

    def _push_shed_template(self) -> None:
        from oryx_tpu_torch.serving.layer import _shed_response

        resp = _shed_response(self._layer.overload_config.retry_after_s)
        resp.headers[_overload.SHED_HEADER] = "shed"
        status, payload, ct, extra = render(resp, "application/json")
        pre, post, body_len, _ = _success_template(status, payload, ct, extra)
        self._lib.hf_set_shed_template(
            self._handle, _u8(pre), len(pre), _u8(post), len(post), body_len
        )

    def push_snapshots(self) -> None:
        """Re-render the liveness endpoints with the REAL resources and
        push the byte templates down. Runs every control tick so the
        native answers track health/readiness within one interval.
        Public: begin_drain() pushes immediately so /readyz flips to 503
        before the drain starts."""
        ctx_path = self._layer.context_path or ""
        for path in _SNAPSHOT_PATHS:
            pre, post, body_len, status = self._snapshot_template(path)
            raw = (ctx_path + path).encode("latin-1")
            self._lib.hf_set_snapshot(
                self._handle, _u8(raw), len(raw), _u8(pre), len(pre),
                _u8(post), len(post), body_len, status,
            )

    def _snapshot_template(self, path):
        """Dispatch ``path`` straight into the router (not through
        _dispatch_parsed: a per-tick synthetic request must not roll root
        sampling dice or bump request counters) and template the result."""
        req = Request(method="GET", path=path, params={}, query={},
                      headers={}, body=b"")
        try:
            with _tenancy.tenant_scope(None):
                response = self._layer.router.dispatch(self._ctx, req)
            status, payload, ct, extra = render(response, "application/json")
        except OryxServingException as e:
            return _error_template(e.status, e.message)
        except Exception:
            log.exception("snapshot render failed for %s", path)
            return _error_template(500, "internal error")
        return _success_template(status, payload, ct, extra)

    # -- answer-cache mirror -------------------------------------------------

    def _on_cache_put(self, key, answer) -> None:
        # called from request threads under no lock: just enqueue; the
        # control tick renders (rendering needs no request context)
        self._cache_queue.append((key, answer))

    def _sync_cache(self) -> None:
        adm = self._layer.admission
        if adm is None:
            return
        champion = adm.generation()
        if champion != self._mirror_generation:
            # promotion/rollback: the Python cache gates per-lookup, the
            # C++ mirror is wiped wholesale (same observable effect)
            self._mirror_generation = champion
            self._lib.hf_cache_clear(self._handle)
            self._cache_queue.clear()
        while True:
            try:
                key, answer = self._cache_queue.popleft()
            except IndexError:
                break
            if answer.generation != champion:
                continue
            from oryx_tpu_torch.serving.web import Response

            resp = Response(
                answer.status, answer.payload, answer.content_type,
                headers={_overload.SHED_HEADER: "stale"},
            )
            try:
                status, payload, ct, extra = render(resp, "application/json")
            except Exception:
                log.exception("cache mirror render failed for %s", key)
                continue
            pre, post, body_len, _ = _success_template(
                status, payload, ct, extra
            )
            kb = key.encode("utf-8")
            self._lib.hf_cache_put(
                self._handle, _u8(kb), len(kb), _u8(pre), len(pre),
                _u8(post), len(post), body_len,
            )

    # -- stats / trace drains ------------------------------------------------

    def _drain_stats(self) -> None:
        with self._drain_lock:
            self._drain_stats_locked()

    def _drain_stats_locked(self) -> None:
        n_tenants = len(self._tenant_names)
        got = self._lib.hf_stats(self._handle, self._stats_buf,
                                 self._stats_need, n_tenants)
        if got != self._stats_need:
            return
        vals = list(self._stats_buf)
        if not any(vals):
            return
        s = dict(zip(_SCALARS, vals))
        buckets = vals[len(_SCALARS):len(_SCALARS) + _N_BUCKETS]
        reg = metrics.registry
        im = self._layer.instance_metrics

        def bump(name, n):
            if n:
                reg.counter(name).inc(n)

        bump("serving.http.connections", s["conns_accepted"])
        bump("serving.http.requests", s["requests"])
        bump("serving.http.forwarded", s["forwarded"])
        bump("serving.http.parse.errors", s["parse_errors"])
        bump("serving.http.read.bytes", s["bytes_in"])
        bump("serving.http.write.bytes", s["bytes_out"])
        bump("serving.http.events.dropped", s["events_dropped"])
        bump("serving.http.native-answered.snapshot", s["ans_snapshot"])
        bump("serving.http.native-answered.shed", s["ans_shed"])
        bump("serving.http.native-answered.stale", s["ans_stale"])
        im.gauge("serving.http.queue.depth").set(s["pending_hwm"])
        # natively-answered requests feed the same serving.* families the
        # Python front's _observe_request feeds, so dashboards see one
        # stream regardless of which side answered
        for i, mname in enumerate(_METHOD_NAMES[:4]):
            n = vals[8 + i]
            if n:
                reg.counter(f"serving.requests.{mname}").inc(n)
                im.counter(f"serving.requests.{mname}").inc(n)
        for cls in range(1, 6):
            n = s[f"c{cls}xx"]
            if n:
                reg.counter(f"serving.responses.{cls}xx").inc(n)
                im.counter(f"serving.responses.{cls}xx").inc(n)
        if s["lat_count"]:
            secs = s["lat_sum_us"] / 1e6
            reg.histogram("serving.request.seconds").merge_buckets(
                buckets, secs
            )
            im.histogram("serving.request.seconds").merge_buckets(
                buckets, secs
            )
            generation = self._layer.health.live_generation or "none"
            im.counter(f"serving.requests.generation.{generation}").inc(
                s["lat_count"]
            )
            im.histogram(
                f"serving.request.seconds.generation.{generation}"
            ).merge_buckets(buckets, secs)
        adm = self._layer.admission
        champion = adm.generation() if adm is not None else None
        for stage_name, n in (("shed", s["ans_shed"]),
                              ("stale", s["ans_stale"])):
            if not n:
                continue
            name = f"serving.overload.shed.{stage_name}"
            reg.counter(name).inc(n)
            im.counter(name).inc(n)
            generation = champion or self._layer.health.live_generation
            if generation:
                im.counter(f"{name}.generation.{generation}").inc(n)
        off = len(_SCALARS) + _N_BUCKETS
        for i, tenant in enumerate(self._tenant_names):
            blk = vals[off + i * _TENANT_SLOTS: off + (i + 1) * _TENANT_SLOTS]
            count, sum_us, shed_stale, shed_shed = blk[:4]
            if count:
                im.counter(f"serving.requests.tenant.{tenant}").inc(count)
                im.histogram(
                    f"serving.request.seconds.tenant.{tenant}"
                ).merge_buckets(blk[4:], sum_us / 1e6)
            if shed_shed:
                im.counter(
                    f"serving.overload.shed.shed.tenant.{tenant}"
                ).inc(shed_shed)
            if shed_stale:
                im.counter(
                    f"serving.overload.shed.stale.tenant.{tenant}"
                ).inc(shed_stale)

    def _drain_trace(self) -> None:
        with self._drain_lock:
            self._drain_trace_locked()

    def _drain_trace_locked(self) -> None:
        n = self._lib.hf_drain_trace(self._handle, self._trace_buf,
                                     len(self._trace_buf))
        if n <= 0:
            return
        buf = bytes(self._trace_buf[: n * _TRACE_REC])
        for i in range(n):
            base = i * _TRACE_REC
            (wall_ms,) = struct.unpack_from("<Q", buf, base)
            dur_us, status = struct.unpack_from("<IH", buf, base + 8)
            rung = buf[base + 14]
            method = buf[base + 15]
            tenant_idx, tp_len, path_len = struct.unpack_from(
                "<hHH", buf, base + 16
            )
            tp = buf[base + 24: base + 24 + tp_len].decode(
                "latin-1", "replace"
            )
            path = buf[base + 88: base + 88 + path_len].decode(
                "latin-1", "replace"
            )
            parent = tracing.parse_traceparent(tp)
            if parent is None or not parent.sampled:
                continue
            attrs = {
                "path": path,
                "method": _METHOD_NAMES[method] if method < 5 else "OTHER",
                "status": status,
                "native_rung": _RUNG_NAMES[rung] if rung < 3 else "?",
            }
            if 0 <= tenant_idx < len(self._tenant_names):
                attrs["tenant"] = self._tenant_names[tenant_idx]
            tracing.record_span(
                "serving.request", parent.child(), parent.span_id,
                wall_ms / 1000.0, dur_us / 1e6, attrs,
            )
