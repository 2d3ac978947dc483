"""The open-loop engine: fire arrivals on their own clock, measure what
production users would feel.

Closed-loop generators hide overload: a slow server
slows the *generator*, so measured latency stays flat while real demand
would be queueing. This engine schedules requests from an arrival
process and fires them regardless of outstanding responses; latency is
measured **from the scheduled arrival time**, so scheduler lag and
worker-queue wait — the queueing delay open-loop exists to expose — land
in the reported percentiles instead of vanishing (the
coordinated-omission correction, per Tene's HdrHistogram argument).

Concurrency is bounded (``max_inflight`` pool workers) but *accounted*:
an arrival that finds every worker busy queues, and its eventual latency
includes the wait. ``LoadResult.queued_arrivals`` counts them — a
nonzero value at a sustainable rate means the bound, not the server, is
the bottleneck, and the run should be re-read accordingly.

Routing is readiness-aware across N replica targets: a poller thread
watches each target's /readyz and arrivals only route to ready replicas
(round-robin). A draining or faulted replica drops out of rotation
exactly the way it would behind a production load balancer — and if NO
replica is ready, the arrival is recorded as a ``no-ready-replica``
failure, which is what makes "zero-downtime" an assertable outcome.

Failures are classified by kind (timeout / http-5xx / http-4xx /
connection / no-ready-replica), never folded into latency stats.

Port note: a copy of ``oryx_tpu/loadgen/engine.py`` (JAX-free), with its imports pointed
at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import http.client
import socket
import threading
import time
import urllib.error
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from urllib.parse import urlsplit

from oryx_tpu_torch.common import tracing
from oryx_tpu_torch.common.metrics import SLOWindow

__all__ = [
    "KeepAliveClient",
    "LoadResult",
    "OpenLoopEngine",
    "RequestRecord",
    "Target",
    "classify_error",
]

# Mirrors oryx_tpu_torch.serving.overload.SHED_HEADER / STAGE_NAMES —
# declared locally because importing the serving package would drag the
# whole layer (and torch) into the loadgen client; tests/test_torch_loadgen.py
# asserts the two stay in sync.
SHED_HEADER = "X-Oryx-Shed-Stage"
SHED_STAGES = ("full", "reduced-probe", "stale", "shed")
# Mirrors oryx_tpu_torch.experiments.routing.ARM_HEADER the same way.
ARM_HEADER = "X-Oryx-Experiment-Arm"
# Mirrors oryx_tpu_torch.tenancy.context.TENANT_HEADER /
# TENANT_PATH_PREFIX the same way.
TENANT_HEADER = "X-Oryx-Tenant"
TENANT_PATH_PREFIX = "/t/"


def _quantile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def classify_error(exc: Exception) -> str:
    """Map a request exception to an error KIND — timeouts must never be
    indistinguishable from 5xx (they exhaust client patience and server
    capacity in completely different ways)."""
    if isinstance(exc, urllib.error.HTTPError):
        return f"http-{exc.code // 100}xx"
    if isinstance(exc, (socket.timeout, TimeoutError)):
        return "timeout"
    if isinstance(exc, urllib.error.URLError):
        reason = getattr(exc, "reason", None)
        if isinstance(reason, (socket.timeout, TimeoutError)):
            return "timeout"
        return "connection"
    return "connection"


class KeepAliveClient:
    """Persistent-connection HTTP client: one ``http.client``
    connection per (worker thread, scheme+host), reused across requests.

    urllib.request stamps ``Connection: close`` on every request, so
    each request pays a fresh TCP connect — which dominates the
    single-digit-ms latencies the native serving front produces and is
    the cost its keep-alive epoll path exists to amortize. Connect time
    is returned separately per request (0.0 on a reused socket) so
    reports can split connect from service.

    Failure semantics preserve crash-failover detection: a connection
    that dies after serving at least one request is retried ONCE on a
    fresh socket (the server may simply have reaped it idle between
    requests); a first-use failure, a timeout, or a repeat failure
    propagates, so a SIGKILLed replica still surfaces as an immediate
    connection error to the failover logic upstream.
    """

    def __init__(self, timeout_s: float = 10.0) -> None:
        self.timeout_s = float(timeout_s)
        self._local = threading.local()

    def _cache(self) -> dict:
        cache = getattr(self._local, "conns", None)
        if cache is None:
            cache = self._local.conns = {}
        return cache

    def _connect(self, key, timeout: float):
        scheme, netloc = key
        t0 = time.perf_counter()
        if scheme == "https":
            import ssl

            conn = http.client.HTTPSConnection(
                netloc, timeout=timeout,
                context=ssl._create_unverified_context(),
            )
        else:
            conn = http.client.HTTPConnection(netloc, timeout=timeout)
        conn.connect()
        return conn, time.perf_counter() - t0

    def close(self) -> None:
        """Close this THREAD's cached connections."""
        cache = self._cache()
        for entry in cache.values():
            try:
                entry[0].close()
            except Exception:  # noqa: BLE001
                pass
        cache.clear()

    def request(
        self, url: str, method: str = "GET", headers=None, body=None,
        timeout: float | None = None,
    ):
        """One request over a (possibly reused) persistent connection.

        Returns ``(status, headers, body_bytes, connect_s)`` — never
        raises for HTTP error statuses, only for transport failures.
        """
        parts = urlsplit(url)
        key = (parts.scheme or "http", parts.netloc)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        t = timeout if timeout is not None else self.timeout_s
        cache = self._cache()
        for attempt in (0, 1):
            entry = cache.get(key)
            connect_s = 0.0
            if entry is None:
                conn, connect_s = self._connect(key, t)
                entry = cache[key] = [conn, 0]
            conn, served = entry
            if conn.sock is not None:
                conn.sock.settimeout(t)
            try:
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
                data = resp.read()
            except Exception as e:  # noqa: BLE001 - classified below
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                cache.pop(key, None)
                # only a previously-working keep-alive socket earns a
                # silent retry; timeouts are real latency, never retried
                retryable = isinstance(
                    e, (http.client.HTTPException, OSError)
                ) and not isinstance(e, (socket.timeout, TimeoutError))
                if served > 0 and attempt == 0 and retryable:
                    continue
                raise
            if resp.will_close:
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                cache.pop(key, None)
            else:
                entry[1] = served + 1
            return resp.status, resp.msg, data, connect_s
        raise RuntimeError("unreachable")  # pragma: no cover


class Target:
    """One serving replica the engine routes to."""

    def __init__(self, name: str, base_url: str) -> None:
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.ready = True  # until the poller learns otherwise
        self.slo = SLOWindow()
        self.ok = 0
        self.failed = 0
        self.shed = 0  # deliberate 429s from the overload ladder
        self.error_kinds: Counter = Counter()

    def __repr__(self) -> str:  # pragma: no cover
        return f"Target({self.name} @ {self.base_url}, ready={self.ready})"


@dataclass
class RequestRecord:
    t_sched: float  # scheduled arrival, seconds from run start
    latency: float  # completion - scheduled arrival (includes queueing)
    service: float  # completion - send (server + network only)
    target: str
    ok: bool
    kind: str  # "ok" or an error kind
    # sampled requests carry a traceparent header, so the client-side
    # record can be joined against the server's spans in GET /trace
    trace_id: str | None = None
    # the X-Oryx-Shed-Stage response header: which overload-ladder rung
    # actually served the answer ("full" when absent)
    shed_stage: str = "full"
    # the X-Oryx-Experiment-Arm response header: which experiment arm
    # served the answer (None when no experiment attributed the request)
    arm: str | None = None
    # the user the request was made for (arm-stickiness assertions
    # group records by user)
    user: int | None = None
    # the tenant the request was made for (per-tenant SLO verdicts
    # group records by tenant); None on a single-tenant run
    tenant: str | None = None
    # seconds spent establishing TCP connections for this request (0.0
    # when the keep-alive socket was reused); reported separately so
    # connect cost never hides inside service latency
    connect_ms: float = 0.0


@dataclass
class LoadResult:
    duration_s: float
    offered: int  # arrivals scheduled
    completed: int  # responses received (ok or failed)
    ok: int
    failed: int
    error_kinds: Counter
    records: list[RequestRecord]
    queued_arrivals: int  # arrivals that found all workers busy
    peak_inflight: int
    per_target: dict[str, Target]
    # deliberate overload-ladder 429s (X-Oryx-Shed-Stage: shed). Counted
    # separately from `failed`: a shed is the server absorbing excess load
    # by design, not an outage — "zero failed requests" stays assertable
    # through a spike while quality() reports what the shedding cost.
    shed: int = 0
    # connection-refused attempts that failed over to a surviving replica
    # (crash failover); nonzero during a SIGKILL campaign, not an error
    retried: int = 0

    def tenant_records(self) -> dict[str, list[RequestRecord]]:
        """Records grouped by tenant (tenanted runs only)."""
        grouped: dict[str, list[RequestRecord]] = {}
        for r in self.records:
            if r.tenant is not None:
                grouped.setdefault(r.tenant, []).append(r)
        return grouped

    @property
    def offered_rate(self) -> float:
        return self.offered / self.duration_s if self.duration_s else 0.0

    @property
    def achieved_rate(self) -> float:
        return self.ok / self.duration_s if self.duration_s else 0.0

    @property
    def error_rate(self) -> float:
        return self.failed / self.completed if self.completed else 0.0

    def latency_quantile(self, q: float) -> float:
        lats = sorted(r.latency for r in self.records if r.ok)
        if not lats:
            return 0.0
        return lats[min(len(lats) - 1, int(q * len(lats)))]

    def service_quantile(self, q: float) -> float:
        svc = sorted(r.service for r in self.records if r.ok)
        if not svc:
            return 0.0
        return svc[min(len(svc) - 1, int(q * len(svc)))]

    def quality(self) -> dict[str, float]:
        """Fraction of ANSWERED requests served at each ladder stage —
        the achieved-quality dimension next to latency. Answered = ok
        responses plus deliberate sheds (the 429 IS the ladder's answer);
        genuine failures are excluded, they're accounted in `failed`."""
        answered = [r for r in self.records if r.ok or r.kind == "shed"]
        if not answered:
            return {stage: 0.0 for stage in SHED_STAGES}
        counts = Counter(r.shed_stage for r in answered)
        return {
            stage: counts.get(stage, 0) / len(answered) for stage in SHED_STAGES
        }

    def summary(self) -> dict:
        return {
            "duration_s": round(self.duration_s, 3),
            "offered": self.offered,
            "offered_rate": round(self.offered_rate, 2),
            "achieved_rate": round(self.achieved_rate, 2),
            "ok": self.ok,
            "failed": self.failed,
            "shed": self.shed,
            "quality": {k: round(v, 4) for k, v in self.quality().items()},
            "error_rate": round(self.error_rate, 6),
            "error_kinds": dict(self.error_kinds),
            "p50_ms": round(self.latency_quantile(0.50) * 1000, 2),
            "p99_ms": round(self.latency_quantile(0.99) * 1000, 2),
            "service_p99_ms": round(self.service_quantile(0.99) * 1000, 2),
            "connects": sum(1 for r in self.records if r.connect_ms > 0),
            "connect_p99_ms": round(
                _quantile([r.connect_ms for r in self.records
                           if r.connect_ms > 0], 0.99), 2),
            "queued_arrivals": self.queued_arrivals,
            "peak_inflight": self.peak_inflight,
            "retried": self.retried,
            "per_target": {
                name: {
                    "ok": t.ok,
                    "failed": t.failed,
                    "shed": t.shed,
                    "errors": dict(t.error_kinds),
                }
                for name, t in self.per_target.items()
            },
        }


class OpenLoopEngine:
    def __init__(
        self,
        targets: list[Target],
        template: str = "/probe/recommend/u%d",
        max_inflight: int = 128,
        timeout_s: float = 10.0,
        readiness_poll_s: float = 0.2,
        on_response=None,
        connect_retries: int = 1,
        tenant_mix: dict[str, float] | None = None,
        tenant_templates: dict[str, str] | None = None,
        tenant_seed: int = 0,
    ) -> None:
        if not targets:
            raise ValueError("need at least one target")
        self.targets = targets
        self.template = template
        # per-tenant traffic mix: tenant -> weight. Each arrival draws a
        # tenant (seeded, reproducible), routes under /t/<tenant>/ with
        # the tenant's own path template, and stamps the tenant on its
        # record so per-tenant SLOs are judged from the same run.
        self.tenant_mix = dict(tenant_mix) if tenant_mix else None
        self.tenant_templates = dict(tenant_templates or {})
        self._tenant_dist = None  # (sorted items, total weight)
        if self.tenant_mix:
            import random

            self._tenant_rng = random.Random(tenant_seed)
            items = sorted(self.tenant_mix.items())
            self._tenant_dist = (items, sum(w for _, w in items))
        self.max_inflight = int(max_inflight)
        self.timeout_s = float(timeout_s)
        self.readiness_poll_s = float(readiness_poll_s)
        # callable(user:int, status:int, headers, body:bytes) invoked for
        # every 2xx response — the hook scripted interaction feedback
        # (oryx_tpu_torch/loadgen/feedback.py) uses to close the loop. Errors
        # are swallowed: feedback must never fail the load run.
        self.on_response = on_response
        # crash failover: a connection-refused attempt demotes its target
        # and retries on a surviving replica up to this many times — the
        # GET endpoints are idempotent, so failover cannot double-apply
        self.connect_retries = int(connect_retries)
        # persistent connections, one per (worker thread, target)
        self._client = KeepAliveClient(timeout_s=self.timeout_s)
        self._rr = 0
        self._lock = threading.Lock()
        self._inflight = 0
        self._peak_inflight = 0
        self._retried = 0
        self._stop = threading.Event()

    # -- readiness routing ---------------------------------------------------

    def _poll_readiness(self) -> None:
        while not self._stop.wait(self.readiness_poll_s):
            for t in self.targets:
                try:
                    status, _, _, _ = self._client.request(
                        f"{t.base_url}/readyz"
                    )
                    # 404 = no /readyz resource on this server: treat as
                    # ready (bare routers); 503 = deliberately not ready
                    t.ready = status in (200, 404)
                except Exception:
                    t.ready = False

    def _pick_target(self) -> Target | None:
        with self._lock:
            n = len(self.targets)
            for i in range(n):
                t = self.targets[(self._rr + i) % n]
                if t.ready:
                    self._rr = (self._rr + i + 1) % n
                    return t
        return None

    # -- request execution ---------------------------------------------------

    def set_tenant_mix(self, tenant_mix: dict[str, float]) -> None:
        """Retune the per-tenant mix mid-run — how a scenario scripts a
        noisy-neighbor burst on a tenanted fleet. Only valid on an engine
        constructed with a tenant mix (the RNG is seeded there). The new
        distribution is swapped in as one tuple, so the arrival thread
        always reads a consistent (items, total) pair."""
        if self._tenant_dist is None:
            raise RuntimeError("engine was not constructed with a tenant mix")
        self.tenant_mix = dict(tenant_mix)
        items = sorted(self.tenant_mix.items())
        self._tenant_dist = (items, sum(w for _, w in items))

    def _pick_tenant(self) -> str | None:
        """Weighted seeded tenant draw for one arrival (None = untenanted)."""
        dist = self._tenant_dist
        if dist is None:
            return None
        items, total = dist
        r = self._tenant_rng.random() * total
        acc = 0.0
        for tid, w in items:
            acc += w
            if r < acc:
                return tid
        return items[-1][0]

    def _attempt(
        self, target: Target, user: int, ctx, tenant: str | None = None
    ) -> tuple[bool, str, str, str | None, float]:
        """One HTTP attempt against one target:
        (ok, kind, shed_stage, arm, connect_s)."""
        template = (
            self.tenant_templates.get(tenant, self.template)
            if tenant is not None
            else self.template
        )
        path = template % user if "%d" in template else template
        if tenant is not None:
            path = f"{TENANT_PATH_PREFIX}{tenant}{path}"
        headers = {}
        if ctx is not None:
            headers["traceparent"] = ctx.traceparent()
        try:
            status, hdrs, data, connect_s = self._client.request(
                target.base_url + path, headers=headers
            )
        except Exception as e:  # noqa: BLE001 - classified, not swallowed
            return False, classify_error(e), "full", None, 0.0
        shed_stage = hdrs.get(SHED_HEADER) or "full"
        arm = hdrs.get(ARM_HEADER)
        if 200 <= status < 300:
            if self.on_response is not None:
                try:
                    self.on_response(user, status, hdrs, data)
                except Exception:  # noqa: BLE001
                    pass
            return True, "ok", shed_stage, arm, connect_s
        if status < 400:  # 3xx
            return False, f"http-{status // 100}xx", shed_stage, arm, connect_s
        # a 429 stamped by the shed ladder is the overload controller
        # doing its job — account it as shed load, not as a failure
        if status == 429 and hdrs.get(SHED_HEADER) == "shed":
            return False, "shed", "shed", None, connect_s
        return False, f"http-{status // 100}xx", "full", None, connect_s

    def _execute(
        self,
        t_run0: float,
        t_sched: float,
        user: int,
        sink: list,
        tenant: str | None = None,
    ) -> None:
        t_send = time.perf_counter()
        t_wall0 = time.time()
        target = self._pick_target()
        ok = False
        kind = "ok"
        shed_stage = "full"
        arm = None
        connect_s = 0.0
        # client root span: sampled requests ship their context as a
        # traceparent header, so the server's serving.request (and the
        # queue-wait/scan/rescore spans under it) land in the same trace
        ctx = tracing.sample_root()
        if target is None:
            kind = "no-ready-replica"
        else:
            retries = 0
            while True:
                ok, kind, shed_stage, arm, c_s = self._attempt(
                    target, user, ctx, tenant
                )
                connect_s += c_s
                if kind != "connection" or retries >= self.connect_retries:
                    break
                # a replica refusing connections is GONE (SIGKILLed, not
                # draining — a drain answers 503s). Demote it now instead
                # of waiting out a readiness-poll tick, and fail the
                # request over to a surviving replica; the poller
                # re-promotes the slot when its /readyz answers 200 again
                target.ready = False
                nxt = self._pick_target()
                if nxt is None:
                    # no survivor to fail over to: keep the lone replica
                    # routable (the failure is recorded either way) and
                    # let the poller, if any, own its readiness
                    target.ready = True
                    break
                with self._lock:
                    self._retried += 1
                retries += 1
                target = nxt
        t_end = time.perf_counter()
        if ctx is not None:
            tracing.record_span(
                "client.request", ctx, None, t_wall0, t_end - t_send,
                {"target": target.name if target is not None else "-",
                 "kind": kind},
            )
        rec = RequestRecord(
            t_sched=t_sched,
            latency=(t_end - t_run0) - t_sched,
            service=t_end - t_send,
            target=target.name if target is not None else "-",
            ok=ok,
            kind=kind,
            trace_id=ctx.trace_id if ctx is not None else None,
            shed_stage=shed_stage,
            arm=arm,
            user=user,
            tenant=tenant,
            connect_ms=connect_s * 1000.0,
        )
        with self._lock:
            sink.append(rec)
            self._inflight -= 1
        if target is not None:
            if kind != "shed":
                # sheds stay out of the SLO window: the 429 is deliberate
                # absorption, not an error burning budget, and its tiny
                # latency would skew the quantiles the SLO is about
                target.slo.record(ok, rec.latency)
            with self._lock:
                if ok:
                    target.ok += 1
                elif kind == "shed":
                    target.shed += 1
                else:
                    target.failed += 1
                    target.error_kinds[kind] += 1

    # -- the run -------------------------------------------------------------

    def run(self, arrivals, users, duration_s: float) -> LoadResult:
        """Drive `arrivals` over `duration_s` seconds against the targets,
        users drawn from `users` (PowerLawUsers or any .one() provider).
        Returns after all scheduled requests complete (each is bounded by
        the request timeout, so the tail is bounded too)."""
        records: list[RequestRecord] = []
        offered = 0
        queued = 0
        self._stop.clear()
        poller = None
        if self.readiness_poll_s > 0:
            poller = threading.Thread(
                target=self._poll_readiness, name="LoadgenReadiness", daemon=True
            )
            poller.start()
        pool = ThreadPoolExecutor(
            max_workers=self.max_inflight, thread_name_prefix="LoadgenWorker"
        )
        t_run0 = time.perf_counter()
        try:
            for t_sched in arrivals.times(duration_s):
                # open loop: sleep until the scheduled arrival, then fire
                # whether or not earlier requests came back
                delay = t_sched - (time.perf_counter() - t_run0)
                if delay > 0:
                    time.sleep(delay)
                user = users.one()
                tenant = self._pick_tenant()
                with self._lock:
                    self._inflight += 1
                    if self._inflight > self.max_inflight:
                        queued += 1
                    self._peak_inflight = max(self._peak_inflight, self._inflight)
                offered += 1
                pool.submit(self._execute, t_run0, t_sched, user, records, tenant)
            pool.shutdown(wait=True)
        finally:
            self._stop.set()
            pool.shutdown(wait=False)
            if poller is not None:
                poller.join(timeout=self.readiness_poll_s + self.timeout_s + 1.0)
        with self._lock:
            recs = list(records)
        kinds = Counter(r.kind for r in recs if not r.ok and r.kind != "shed")
        n_ok = sum(1 for r in recs if r.ok)
        n_shed = sum(1 for r in recs if r.kind == "shed")
        return LoadResult(
            # rates are over the SCHEDULED window: the post-deadline tail
            # draining responses is not extra serving time
            duration_s=duration_s,
            offered=offered,
            completed=len(recs),
            ok=n_ok,
            failed=len(recs) - n_ok - n_shed,
            error_kinds=kinds,
            records=recs,
            queued_arrivals=queued,
            peak_inflight=self._peak_inflight,
            per_target={t.name: t for t in self.targets},
            shed=n_shed,
            retried=self._retried,
        )
