"""Predictive fleet autoscaling on multi-window burn-rate + queue-wait signals.

The policy half of the fleet control loop (the actuator half — drain-aware
replica rotation — lives in oryx_tpu_torch/tools/fleet.py).  :class:`FleetAutoscaler`
combines two laws:

* **Predictive**: observed arrival rates are fitted to the raised-cosine
  diurnal curve the loadgen emits (``DiurnalRampProcess``:
  ``rate(t) = base + swing * (1 - cos(2*pi*(t/period + phase)))``) by
  linear least squares on the ``(1, cos wt, sin wt)`` basis — the period
  is operator-known (it's a diurnal cycle), so the fit is a 3x3 solve,
  no iteration.  Desired replicas = ceil(rate(now + lead-s) /
  per-replica-rate): the fleet is sized for where the curve will be one
  replica-startup lead ahead, so scale-out lands *before* the peak.

* **Reactive**: Google-SRE multi-window burn-rate — when BOTH the short
  and long latency-burn windows exceed ``burn-hi``, or queue wait blows
  past ``queue-wait-hi-ms``, demand one replica more than the fit asked
  for.  Two windows mean a single slow request can't trigger churn while
  a sustained breach still reacts in seconds.

Scale-in is deliberately timid: it waits ``scale-in-quiet-evals``
consecutive calm evaluations, then asks the actuator to drain — the
actuator uses the begin_drain/drain rotation, so scale-in never fails a
request; a refused drain (False) leaves the replica in place.

The harness in oryx_tpu_torch/tools/fleet.py supplies the actuator and
signal callbacks.  `clock` is injectable: unit tests drive a scripted
trace through `step(now)` with no threads and no sleeping.  Its metrics
go in the port's process registry under the JAX package's names.

Port note: a copy of ``oryx_tpu/serving/autoscale.py`` (JAX-free), with its imports pointed
at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from oryx_tpu_torch.common import metrics


def fit_raised_cosine(
    times: list[float], rates: list[float], period_s: float
) -> Callable[[float], float] | None:
    """Least-squares fit of observed (t, rate) samples to
    ``c0 + c1*cos(wt) + c2*sin(wt)`` with known period; returns a
    non-negative rate predictor, or None when the system is singular
    (fewer than 3 samples, or samples spanning < ~2% of the period so the
    basis columns are collinear)."""
    n = len(times)
    if n < 3 or period_s <= 0:
        return None
    w = 2.0 * math.pi / period_s
    # normal equations A^T A x = A^T b for A = [1, cos(wt), sin(wt)]
    ata = [[0.0] * 3 for _ in range(3)]
    atb = [0.0] * 3
    for t, r in zip(times, rates):
        row = (1.0, math.cos(w * t), math.sin(w * t))
        for i in range(3):
            atb[i] += row[i] * r
            for j in range(3):
                ata[i][j] += row[i] * row[j]
    coef = _solve3(ata, atb)
    if coef is None:
        return None
    c0, c1, c2 = coef

    def predict(t: float) -> float:
        return max(0.0, c0 + c1 * math.cos(w * t) + c2 * math.sin(w * t))

    return predict


def _solve3(a: list[list[float]], b: list[float]) -> list[float] | None:
    """Gaussian elimination with partial pivoting for a 3x3 system."""
    m = [row[:] + [bi] for row, bi in zip(a, b)]
    for col in range(3):
        pivot = max(range(col, 3), key=lambda r: abs(m[r][col]))
        if abs(m[pivot][col]) < 1e-9:
            return None
        m[col], m[pivot] = m[pivot], m[col]
        for r in range(3):
            if r != col:
                f = m[r][col] / m[col][col]
                for c in range(col, 4):
                    m[r][c] -= f * m[col][c]
    return [m[i][3] / m[i][i] for i in range(3)]


@dataclass(frozen=True)
class AutoscaleConfig:
    """Parsed ``oryx.fleet.autoscale.*`` knobs (reference.conf defaults)."""

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 8
    interval_s: float = 1.0
    lead_s: float = 30.0
    period_s: float = 86400.0
    per_replica_rate: float = 100.0
    cooldown_s: float = 5.0
    burn_hi: float = 2.0
    burn_window_short_s: float = 5.0
    burn_window_long_s: float = 30.0
    queue_wait_hi_ms: float = 200.0
    scale_in_quiet_evals: int = 5
    min_fit_samples: int = 8

    @classmethod
    def from_config(cls, config) -> "AutoscaleConfig":
        p = "oryx.fleet.autoscale."
        return cls(
            enabled=config.get_bool(p + "enabled"),
            min_replicas=config.get_int(p + "min-replicas"),
            max_replicas=config.get_int(p + "max-replicas"),
            interval_s=config.get_float(p + "interval-s"),
            lead_s=config.get_float(p + "lead-s"),
            period_s=config.get_float(p + "period-s"),
            per_replica_rate=config.get_float(p + "per-replica-rate"),
            cooldown_s=config.get_float(p + "cooldown-s"),
            burn_hi=config.get_float(p + "burn-hi"),
            burn_window_short_s=config.get_float(p + "burn-window-short-s"),
            burn_window_long_s=config.get_float(p + "burn-window-long-s"),
            queue_wait_hi_ms=config.get_float(p + "queue-wait-hi-ms"),
            scale_in_quiet_evals=config.get_int(p + "scale-in-quiet-evals"),
            min_fit_samples=config.get_int(p + "min-fit-samples"),
        )


@dataclass
class AutoscaleSignals:
    """One evaluation's inputs, supplied by the harness."""

    rate: float  # observed arrival rate, req/s
    queue_wait_ms: float  # worst batcher queue-wait EWMA across replicas
    burn_short: float  # latency burn rate over the short window
    burn_long: float  # latency burn rate over the long window
    # per-tenant arrival-rate split on a multi-tenant fleet: published as
    # fleet.autoscale.rate.tenant.<tenant> gauges so capacity dashboards
    # attribute demand to tenants (sizing itself uses the aggregate rate
    # — replicas host every tenant, so capacity is fungible across them)
    tenant_rates: dict[str, float] = field(default_factory=dict)


@dataclass
class ScaleEvent:
    t: float
    direction: str  # "out" | "in"
    reason: str  # "predictive" | "reactive" | "quiet"
    replicas: int  # replica count after the event


class FleetAutoscaler:
    """Sizing policy over an actuator; call :meth:`step` once per interval.

    `actuator` needs three methods: ``replica_count() -> int``,
    ``scale_out() -> bool`` and ``scale_in() -> bool`` (scale_in drains
    first and returns False when it refuses, e.g. at min capacity or when
    the drain would strand in-flight requests).
    """

    def __init__(
        self,
        actuator,
        signals: Callable[[], AutoscaleSignals],
        cfg: AutoscaleConfig,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.actuator = actuator
        self._signals = signals
        self.cfg = cfg
        self._clock = clock
        self._samples: deque[tuple[float, float]] = deque(maxlen=4096)
        self._last_scale = -float("inf")
        self._quiet_evals = 0
        self.events: list[ScaleEvent] = []
        self.last_predicted_rate = 0.0

    def step(self, now: float | None = None) -> int:
        """One control evaluation; returns the replica count afterwards."""
        t = self._clock() if now is None else now
        cfg = self.cfg
        sig = self._signals()
        self._samples.append((t, sig.rate))
        current = self.actuator.replica_count()

        # predictive demand from the diurnal fit, one lead ahead
        desired = cfg.min_replicas
        predict = None
        if len(self._samples) >= cfg.min_fit_samples:
            ts = [s[0] for s in self._samples]
            rs = [s[1] for s in self._samples]
            predict = fit_raised_cosine(ts, rs, cfg.period_s)
        if predict is not None:
            predicted = predict(t + cfg.lead_s)
            self.last_predicted_rate = predicted
            desired = max(
                desired, math.ceil(predicted / max(1e-9, cfg.per_replica_rate))
            )
        else:
            # no usable fit yet: size reactively on the observed rate
            self.last_predicted_rate = sig.rate
            desired = max(
                desired, math.ceil(sig.rate / max(1e-9, cfg.per_replica_rate))
            )

        # reactive override: sustained multi-window burn or queue blow-up
        overloaded = (
            sig.burn_short > cfg.burn_hi and sig.burn_long > cfg.burn_hi
        ) or sig.queue_wait_ms > cfg.queue_wait_hi_ms
        if overloaded:
            desired = max(desired, current + 1)
        desired = max(cfg.min_replicas, min(cfg.max_replicas, desired))

        if desired > current:
            self._quiet_evals = 0
            if t - self._last_scale >= cfg.cooldown_s and self.actuator.scale_out():
                self._last_scale = t
                reason = "reactive" if overloaded else "predictive"
                self._record(t, "out", reason)
        elif desired < current and not overloaded:
            self._quiet_evals += 1
            if (
                self._quiet_evals >= cfg.scale_in_quiet_evals
                and t - self._last_scale >= cfg.cooldown_s
                and self.actuator.scale_in()
            ):
                self._last_scale = t
                self._quiet_evals = 0
                self._record(t, "in", "quiet")
        else:
            self._quiet_evals = 0

        count = self.actuator.replica_count()
        metrics.registry.gauge("fleet.autoscale.replicas").set(count)
        metrics.registry.gauge("fleet.autoscale.predicted-rate").set(
            self.last_predicted_rate
        )
        for tid, tenant_rate in sig.tenant_rates.items():
            metrics.registry.gauge(f"fleet.autoscale.rate.tenant.{tid}").set(
                tenant_rate
            )
        return count

    def _record(self, t: float, direction: str, reason: str) -> None:
        count = self.actuator.replica_count()
        self.events.append(ScaleEvent(t, direction, reason, count))
        if direction == "out":
            metrics.registry.counter("fleet.autoscale.scale-outs").inc()
        else:
            metrics.registry.counter("fleet.autoscale.scale-ins").inc()


class AutoscalerThread:
    """Background thread calling ``step`` every ``interval-s``; the harness
    owns start/stop so replica mutation stays on one thread."""

    def __init__(self, policy: FleetAutoscaler) -> None:
        self.policy = policy
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="fleet-autoscaler", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.policy.cfg.interval_s):
            try:
                self.policy.step()
            except Exception:  # autoscaling must never kill the harness
                metrics.registry.counter("fleet.autoscale.errors").inc()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
