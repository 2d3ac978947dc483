"""Adaptive overload control: admission controller + staged quality shedding.

Production serving tiers that only queue under overload convert a traffic
spike into an unbounded latency tail (BENCH_r05: 8.9-18 s p99 queued behind
the pipeline).  Following DAGOR-style admission control (Zhou et al.,
SoCC'18, "Overload Control for Scaling WeChat Microservices") this module
degrades answer *quality* in stages instead of degrading *latency*
unboundedly.  A per-replica :class:`AdmissionController` watches the
adaptive batcher's queue-wait EWMA, queue depth, and HTTP in-flight count
against the ``oryx.serving.overload.*`` budget, folds them into a single
smoothed pressure ratio, and walks a shed ladder one rung at a time:

    stage 0  full           exact / full-nprobe ANN scan
    stage 1  reduced-probe  ANN with ``nprobe`` scaled down per request
    stage 2  stale          cached top-N from the champion generation
    stage 3  shed           fast 429 with Retry-After

Hysteresis prevents flapping: a rung engages when smoothed pressure crosses
its engage threshold, releases only when pressure drops below
``engage * release-fraction``, and both directions dwell ``hold-s`` seconds
between moves.  Every shed decision is counted per stage, carried on the
response as the ``X-Oryx-Shed-Stage`` header, and recorded as a trace
attribute so loadgen can report achieved quality alongside latency
(docs/overload.md).

This module deliberately imports only the metrics registry — the batcher
imports it for the queue-full shed path, so it must never import the
batcher back.

Port note: a copy of ``oryx_tpu/serving/overload.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Callable

from oryx_tpu_torch.common import metrics

# Ladder stages, in engagement order. Indexes are meaningful: the
# controller only ever moves one rung at a time.
STAGE_FULL = 0
STAGE_REDUCED_PROBE = 1
STAGE_STALE = 2
STAGE_SHED = 3
STAGE_NAMES = ("full", "reduced-probe", "stale", "shed")

# Response header carrying the stage a request was actually served at.
SHED_HEADER = "X-Oryx-Shed-Stage"

# Control-plane paths are exempt from shedding: health and drain signals
# must stay accurate precisely when the data plane is overloaded.
_EXEMPT_PREFIXES = (
    "/healthz",
    "/readyz",
    "/ready",
    "/metrics",
    "/trace",
    "/model/",
    "/debug/",
    "/experiments",
)


def exempt(path: str) -> bool:
    """True when `path` is control-plane and must never be shed."""
    return any(path == p.rstrip("/") or path.startswith(p) for p in _EXEMPT_PREFIXES)


# -- per-request probe override ---------------------------------------------
#
# The admission decision is taken on the HTTP worker thread; the same
# thread calls into the batcher's enqueue path, so a ContextVar carries
# the reduced probe fraction from the controller to the batcher without
# widening every scoring signature in between (the batcher snapshots it
# into the entry before handing off to the dispatcher thread).

_probe_override: ContextVar[float | None] = ContextVar("oryx_probe_override", default=None)


def active_probe_fraction() -> float | None:
    """The probe fraction the current request should scan with, if reduced."""
    return _probe_override.get()


@contextmanager
def probe_override(fraction: float | None):
    """Scope a reduced probe fraction over a router dispatch."""
    token = _probe_override.set(fraction)
    try:
        yield
    finally:
        _probe_override.reset(token)


# -- configuration -----------------------------------------------------------


@dataclass(frozen=True)
class OverloadConfig:
    """Parsed ``oryx.serving.overload.*`` budget (reference.conf defaults)."""

    enabled: bool = True
    target_queue_wait_ms: float = 50.0
    inflight_target: int = 64
    max_queue: int | None = 2048
    engage_reduced: float = 0.7
    engage_stale: float = 1.0
    engage_shed: float = 1.3
    release_fraction: float = 0.75
    hold_s: float = 1.0
    alpha: float = 0.3
    probe_fraction: float = 0.25
    cache_entries: int = 256
    retry_after_s: int = 1
    control_interval_ms: float = 100.0

    @classmethod
    def from_config(cls, config) -> "OverloadConfig":
        p = "oryx.serving.overload."
        return cls(
            enabled=config.get_bool(p + "enabled"),
            target_queue_wait_ms=config.get_float(p + "target-queue-wait-ms"),
            inflight_target=config.get_int(p + "inflight-target"),
            max_queue=config.get_optional_int(p + "max-queue"),
            engage_reduced=config.get_float(p + "engage-reduced"),
            engage_stale=config.get_float(p + "engage-stale"),
            engage_shed=config.get_float(p + "engage-shed"),
            release_fraction=config.get_float(p + "release-fraction"),
            hold_s=config.get_float(p + "hold-s"),
            alpha=config.get_float(p + "alpha"),
            probe_fraction=config.get_float(p + "probe-fraction"),
            cache_entries=config.get_int(p + "cache-entries"),
            retry_after_s=config.get_int(p + "retry-after-s"),
            control_interval_ms=config.get_float(p + "control-interval-ms"),
        )

    def engage_threshold(self, stage: int) -> float:
        return (self.engage_reduced, self.engage_stale, self.engage_shed)[stage - 1]


# -- shed accounting ---------------------------------------------------------

# Registered here so the literal names live next to the catalog entries in
# docs/observability.md; the family is docs-cataloged as
# serving.overload.shed.<stage>.
_SHED_COUNTER_PREFIX = "serving.overload.shed."


def count_shed(
    stage_name: str, instance_metrics=None, generation=None, tenant=None
) -> None:
    """Count one answer served below full quality at `stage_name`.

    When the generation that would have served the request is known, a
    generation-labeled twin is counted alongside, so per-generation (and
    per-experiment-arm) dashboards see *which* model's traffic was
    degraded; likewise a tenant-labeled twin
    (``serving.overload.shed.<stage>.tenant.<tenant>``) attributes the
    degradation to the tenant that absorbed it."""
    name = _SHED_COUNTER_PREFIX + stage_name
    metrics.registry.counter(name).inc()
    if instance_metrics is not None:
        instance_metrics.counter(name).inc()
        if generation is not None:
            instance_metrics.counter(f"{name}.generation.{generation}").inc()
        if tenant is not None:
            instance_metrics.counter(f"{name}.tenant.{tenant}").inc()


# -- stale-answer cache ------------------------------------------------------


@dataclass
class CachedAnswer:
    generation: str
    status: int
    payload: object  # the un-rendered Response body; re-rendered per Accept
    content_type: str | None


class AnswerCache:
    """Bounded LRU of last-good answers keyed by request path+query.

    Entries are stamped with the generation that produced them; lookups
    only hit when the stamped generation still equals the tracked champion
    — a rollback or promotion implicitly invalidates the whole cache, so
    the stale rung can never serve answers from an abandoned candidate
    generation. Only full-quality (stage 0) 200s are cached, so "stale"
    means *older* full answers, never degraded ones.
    """

    def __init__(self, max_entries: int = 256) -> None:
        self._max = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, CachedAnswer] = OrderedDict()
        self.hits = 0
        self.misses = 0
        # optional mirror hook (serving/native_front.py): called after
        # each put, off the lock, so the native front can mirror the
        # entry into its C++ answer cache. Must be cheap and
        # non-blocking — the native front just enqueues and renders on
        # its control tick, never on this (request) thread.
        self.listener: Callable[[str, CachedAnswer], None] | None = None

    def put(self, key: str, answer: CachedAnswer) -> None:
        with self._lock:
            self._entries[key] = answer
            self._entries.move_to_end(key)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)
        listener = self.listener
        if listener is not None:
            listener(key, answer)

    def get(self, key: str, champion_generation: str | None) -> CachedAnswer | None:
        with self._lock:
            entry = self._entries.get(key)
            if (
                entry is None
                or champion_generation is None
                or entry.generation != champion_generation
            ):
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# -- admission controller ----------------------------------------------------


@dataclass
class _TenantLadder:
    """One tenant's private shed ladder (same control law, scoped signal).

    A tenant's pressure is its *own* queue depth against its *weighted
    share* of the bounded queue, so a noisy neighbor climbs its ladder —
    and gets shed — while the global ladder (which all tenants inherit as
    a floor) stays low and victims keep full quality."""

    weight: float = 1.0
    stage: int = STAGE_FULL
    pressure: float = 0.0
    last_move: float = -float("inf")


@dataclass(frozen=True)
class Decision:
    """One admission decision: the stage to serve the request at."""

    stage: int
    probe_fraction: float | None = None
    retry_after_s: int = 1

    @property
    def name(self) -> str:
        return STAGE_NAMES[self.stage]


class AdmissionController:
    """Per-replica shed-ladder controller with hysteresis.

    `signals` returns ``(queue_wait_ms, queue_depth, inflight)``; the
    controller normalises each against its budget, takes the max (the
    bottleneck dominates, per DAGOR), and EWMA-smooths it into a single
    pressure ratio.  1.0 means "exactly at budget".  Rung moves are rate
    limited to one per `hold-s` in either direction; evaluation itself is
    rate limited to `control-interval-ms` so the idle fast path is one
    monotonic read + compare.  `clock` is injectable for deterministic
    tests.
    """

    def __init__(
        self,
        cfg: OverloadConfig,
        signals: Callable[[], tuple[float, int, int]],
        clock: Callable[[], float] = time.monotonic,
        instance_metrics=None,
        generation_fn: Callable[[], str | None] | None = None,
    ) -> None:
        self.cfg = cfg
        self._signals = signals
        self._clock = clock
        self._instance_metrics = instance_metrics
        self._generation_fn = generation_fn
        self.cache = AnswerCache(cfg.cache_entries)
        self._lock = threading.Lock()
        self._stage = STAGE_FULL
        self._pressure = 0.0
        self._last_eval = -float("inf")
        self._last_move = -float("inf")
        self.transitions: list[tuple[float, int, int, float]] = []
        # per-tenant ladders (configure_tenants); empty = tenancy off
        self._tenants: dict[str, _TenantLadder] = {}
        self._tenant_depths: Callable[[], dict[str, int]] | None = None

    def configure_tenants(
        self,
        weights: dict[str, float],
        depths_fn: Callable[[], dict[str, int]],
    ) -> None:
        """Attach per-tenant shed ladders (serving layer, at startup).

        `depths_fn` returns the batcher's per-tenant queued-entry counts;
        each tenant's ladder normalises its own depth against its weighted
        share of ``max-queue`` and walks the same hysteresis rungs as the
        global ladder."""
        with self._lock:
            self._tenants = {
                tid: _TenantLadder(weight=w) for tid, w in weights.items()
            }
            self._tenant_depths = depths_fn

    # -- signal plumbing --

    def generation(self) -> str | None:
        """The tracked champion generation (None before the first model)."""
        return self._generation_fn() if self._generation_fn is not None else None

    @property
    def stage(self) -> int:
        return self._stage

    @property
    def pressure(self) -> float:
        return self._pressure

    def _raw_pressure(self) -> float:
        queue_wait_ms, queue_depth, inflight = self._signals()
        ratios = [
            queue_wait_ms / self.cfg.target_queue_wait_ms,
            inflight / max(1, self.cfg.inflight_target),
        ]
        if self.cfg.max_queue:
            ratios.append(queue_depth / self.cfg.max_queue)
        return max(ratios)

    # -- control law --

    def evaluate(self, now: float | None = None) -> int:
        """Fold signals into smoothed pressure and move at most one rung."""
        t = self._clock() if now is None else now
        with self._lock:
            self._last_eval = t
            raw = self._raw_pressure()
            a = self.cfg.alpha
            self._pressure = a * raw + (1.0 - a) * self._pressure
            stage = self._stage
            if t - self._last_move >= self.cfg.hold_s:
                if (
                    stage < STAGE_SHED
                    and self._pressure >= self.cfg.engage_threshold(stage + 1)
                ):
                    self._move(stage + 1, t)
                elif (
                    stage > STAGE_FULL
                    and self._pressure
                    <= self.cfg.engage_threshold(stage) * self.cfg.release_fraction
                ):
                    self._move(stage - 1, t)
            if self._tenants:
                self._evaluate_tenants(t)
            metrics.registry.gauge("serving.overload.stage").set(self._stage)
            metrics.registry.gauge("serving.overload.pressure").set(self._pressure)
            if self._instance_metrics is not None:
                self._instance_metrics.gauge("serving.overload.stage").set(self._stage)
                self._instance_metrics.gauge("serving.overload.pressure").set(
                    self._pressure
                )
            return self._stage

    def _evaluate_tenants(self, t: float) -> None:
        """Walk each tenant ladder one step (caller holds the lock)."""
        depths = self._tenant_depths() if self._tenant_depths else {}
        total_weight = sum(l.weight for l in self._tenants.values())
        max_queue = self.cfg.max_queue
        for tid, ladder in self._tenants.items():
            if not max_queue:
                break  # unbounded queue: per-tenant shares are undefined
            share = max(1.0, max_queue * ladder.weight / max(total_weight, 1e-9))
            raw = depths.get(tid, 0) / share
            a = self.cfg.alpha
            ladder.pressure = a * raw + (1.0 - a) * ladder.pressure
            if t - ladder.last_move >= self.cfg.hold_s:
                if (
                    ladder.stage < STAGE_SHED
                    and ladder.pressure
                    >= self.cfg.engage_threshold(ladder.stage + 1)
                ):
                    ladder.stage += 1
                    ladder.last_move = t
                elif (
                    ladder.stage > STAGE_FULL
                    and ladder.pressure
                    <= self.cfg.engage_threshold(ladder.stage)
                    * self.cfg.release_fraction
                ):
                    ladder.stage -= 1
                    ladder.last_move = t
            if self._instance_metrics is not None:
                self._instance_metrics.gauge(
                    f"serving.overload.stage.tenant.{tid}"
                ).set(ladder.stage)
                self._instance_metrics.gauge(
                    f"serving.overload.pressure.tenant.{tid}"
                ).set(ladder.pressure)

    def tenant_stage(self, tenant: str | None) -> int:
        """The tenant's own ladder stage (STAGE_FULL when untracked)."""
        if tenant is None:
            return STAGE_FULL
        ladder = self._tenants.get(tenant)
        return ladder.stage if ladder is not None else STAGE_FULL

    def _move(self, to_stage: int, t: float) -> None:
        self.transitions.append((t, self._stage, to_stage, self._pressure))
        self._stage = to_stage
        self._last_move = t
        metrics.registry.counter("serving.overload.transitions").inc()
        if self._instance_metrics is not None:
            self._instance_metrics.counter("serving.overload.transitions").inc()

    def decide(
        self, method: str, path: str, tenant: str | None = None
    ) -> Decision | None:
        """Admission decision for one request; None = exempt, serve normally.

        With tenancy on, the effective stage is the *max* of the global
        ladder and the tenant's own — global pressure degrades everyone,
        a noisy neighbor additionally degrades only itself."""
        if exempt(path):
            return None
        t = self._clock()
        if t - self._last_eval >= self.cfg.control_interval_ms / 1000.0:
            self.evaluate(t)
        stage = max(self._stage, self.tenant_stage(tenant))
        if stage == STAGE_FULL:
            return Decision(STAGE_FULL)
        if stage == STAGE_REDUCED_PROBE:
            return Decision(
                STAGE_REDUCED_PROBE, probe_fraction=self.cfg.probe_fraction
            )
        if stage == STAGE_STALE:
            # stale only helps GETs; mutations fall through at reduced probe
            return Decision(
                STAGE_STALE,
                probe_fraction=self.cfg.probe_fraction,
                retry_after_s=self.cfg.retry_after_s,
            )
        return Decision(STAGE_SHED, retry_after_s=self.cfg.retry_after_s)
