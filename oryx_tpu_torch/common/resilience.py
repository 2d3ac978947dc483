"""Resilience primitives: retry/backoff, deadlines, circuit breaking,
and supervised threads.

The reference leans on Kafka/Spark for its recovery story (replay-from-zero
on the update topic, SpeedLayer.java:107-121, and Spark task retry). The
rebuild owns its transport and layer runtimes, so it owns the failure
handling too. This module is the one place that policy lives:

- :class:`RetryPolicy` — bounded exponential backoff with deterministic
  jitter (seeded through :mod:`oryx_tpu_torch.common.rng`, so chaos tests
  replay exactly), loadable from ``oryx.*.retry.*`` config blocks.
- :class:`Deadline` — a monotonic time budget shared across retries.
- :class:`CircuitBreaker` — closed/open/half-open, for dependencies that
  fail fast rather than fail slow.
- :class:`SupervisedThread` — a restart-with-backoff wrapper for the
  long-lived consume/batch threads in the lambda layers: restart on
  failure, give up after the policy is exhausted, and report health.

Everything emits into :mod:`oryx_tpu_torch.common.metrics` so operators can see
retries, breaker state, and supervisor restarts at /metrics.

Port note: a copy of ``oryx_tpu/common/resilience.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Iterator

from oryx_tpu_torch.common import metrics, rng

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "Deadline",
    "DeadlineExceeded",
    "RetryError",
    "RetryPolicy",
    "SupervisedThread",
]

log = logging.getLogger(__name__)


class RetryError(Exception):
    """A retried call exhausted its policy; __cause__ is the last failure."""


class DeadlineExceeded(Exception):
    """A Deadline expired before the work completed."""


class CircuitOpenError(Exception):
    """A call was refused because the circuit breaker is open."""


class Deadline:
    """A monotonic time budget. Cheap to pass down call chains so one
    top-level budget bounds every retry loop underneath it."""

    def __init__(self, seconds: float, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._expires = clock() + seconds

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(seconds)

    def remaining(self) -> float:
        return max(0.0, self._expires - self._clock())

    def expired(self) -> bool:
        return self._clock() >= self._expires

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExceeded(f"{what} exceeded its deadline")

    def clamp(self, delay: float) -> float:
        """A sleep no longer than what's left of the budget."""
        return min(delay, self.remaining())


class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``max_attempts`` counts total tries including the first; backoff before
    retry ``n`` (1-based) is ``initial_backoff * multiplier**(n-1)`` capped
    at ``max_backoff``, then jittered by ``±jitter`` fraction. Jitter draws
    come from :func:`oryx_tpu_torch.common.rng.get_random`, so under
    ``use_test_seed()`` (or an explicit ``seed``) the delay sequence is
    reproducible — the property the chaos suite depends on.
    """

    def __init__(
        self,
        max_attempts: int = 5,
        initial_backoff: float = 0.1,
        max_backoff: float = 5.0,
        multiplier: float = 2.0,
        jitter: float = 0.1,
        seed: int | None = None,
    ) -> None:
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if multiplier < 1.0:
            raise ValueError("multiplier must be >= 1.0")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_attempts = max_attempts
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self.multiplier = multiplier
        self.jitter = jitter
        self._rng = rng.get_random(seed)
        self._rng_lock = threading.Lock()

    @classmethod
    def from_config(cls, config, prefix: str, **defaults: Any) -> "RetryPolicy":
        """Build from an ``oryx.*.retry`` block, e.g.
        ``RetryPolicy.from_config(cfg, "oryx.speed.retry")``. Missing keys
        fall back to ``defaults`` then to the constructor defaults."""

        def opt(key: str, kind: str):
            getter = config.get_optional_int if kind == "int" else config.get_optional_float
            return getter(f"{prefix}.{key}")

        kw: dict[str, Any] = dict(defaults)
        v = opt("max-attempts", "int")
        if v is not None:
            kw["max_attempts"] = v
        v = opt("initial-backoff-ms", "float")
        if v is not None:
            kw["initial_backoff"] = v / 1000.0
        v = opt("max-backoff-ms", "float")
        if v is not None:
            kw["max_backoff"] = v / 1000.0
        v = opt("multiplier", "float")
        if v is not None:
            kw["multiplier"] = v
        v = opt("jitter", "float")
        if v is not None:
            kw["jitter"] = v
        return cls(**kw)

    def backoff(self, attempt: int) -> float:
        """Jittered delay before retry `attempt` (1-based)."""
        base = min(self.max_backoff, self.initial_backoff * self.multiplier ** (attempt - 1))
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        with self._rng_lock:
            u = float(self._rng.random())
        return base * (1.0 - self.jitter + 2.0 * self.jitter * u)

    def backoff_or_none(self, attempt: int) -> float | None:
        """backoff(), or None once the policy is exhausted (attempt counts
        failures so far; the policy allows max_attempts - 1 retries)."""
        if attempt >= self.max_attempts:
            return None
        return self.backoff(attempt)

    def delays(self) -> Iterator[float]:
        """The max_attempts - 1 retry delays, in order."""
        for attempt in range(1, self.max_attempts):
            yield self.backoff(attempt)

    def call(
        self,
        fn: Callable[[], Any],
        *,
        retry_on: tuple[type[BaseException], ...] = (Exception,),
        deadline: Deadline | None = None,
        metrics_prefix: str | None = None,
        stop_event: threading.Event | None = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> Any:
        """Run fn(), retrying on `retry_on` with this policy's backoff.

        Raises :class:`RetryError` (cause = last failure) once attempts are
        exhausted, :class:`DeadlineExceeded` when the deadline runs out
        first. With `metrics_prefix`, emits `<prefix>.retry.retries` and
        `<prefix>.retry.failures` counters. A set `stop_event` aborts the
        backoff wait and re-raises the last failure immediately.
        """
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except retry_on as e:
                if isinstance(e, (CircuitOpenError, DeadlineExceeded)):
                    raise  # refusals are not transient faults
                delay = self.backoff_or_none(attempt)
                if delay is None:
                    if metrics_prefix:
                        metrics.registry.counter(f"{metrics_prefix}.retry.failures").inc()
                    raise RetryError(f"gave up after {attempt} attempts: {e}") from e
                if deadline is not None:
                    if deadline.expired():
                        raise DeadlineExceeded("deadline expired during retries") from e
                    delay = deadline.clamp(delay)
                if metrics_prefix:
                    metrics.registry.counter(f"{metrics_prefix}.retry.retries").inc()
                log.debug("retry %d/%d after %.3fs: %s", attempt, self.max_attempts, delay, e)
                if stop_event is not None:
                    if stop_event.wait(delay):
                        raise
                else:
                    sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover


class CircuitBreaker:
    """Closed/open/half-open circuit breaker.

    CLOSED: calls flow; `failure_threshold` consecutive failures trip it
    OPEN. OPEN: calls are refused with :class:`CircuitOpenError` until
    `reset_timeout` elapses, then one probe is let through (HALF_OPEN).
    HALF_OPEN: probe success closes the circuit, probe failure re-opens it
    and restarts the timeout. State is exported as the gauge
    `<name>.circuit.state` (0=closed, 1=open, 2=half-open).
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
    _STATE_VALUE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(
        self,
        name: str,
        failure_threshold: int = 5,
        reset_timeout: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._set_gauge()

    def _set_gauge(self) -> None:
        metrics.registry.gauge(f"{self.name}.circuit.state").set(
            self._STATE_VALUE[self._state]
        )

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        """Caller holds the lock."""
        if self._state == self.OPEN and self._clock() - self._opened_at >= self.reset_timeout:
            self._state = self.HALF_OPEN
            self._set_gauge()

    def allow(self) -> bool:
        """True if a call may proceed now (an allowed call in half-open is
        the probe: its record_success/record_failure decides the state)."""
        with self._lock:
            self._maybe_half_open()
            return self._state != self.OPEN

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self._set_gauge()

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN or (
                self._state == self.CLOSED and self._failures >= self.failure_threshold
            ):
                self._state = self.OPEN
                self._opened_at = self._clock()
                metrics.registry.counter(f"{self.name}.circuit.opens").inc()
                self._set_gauge()

    def call(self, fn: Callable[[], Any]) -> Any:
        """Guarded call: refuses with CircuitOpenError while open, records
        the outcome otherwise."""
        if not self.allow():
            metrics.registry.counter(f"{self.name}.circuit.refused").inc()
            raise CircuitOpenError(f"circuit {self.name} is open")
        try:
            result = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result


class SupervisedThread:
    """A daemon thread whose target is restarted with backoff on failure.

    Two shapes of target:

    - ``loop=False`` (default): `target` is long-running (e.g. a blocking
      consume loop). Normal return ends the thread. An exception restarts
      it after the policy's backoff; a run that survived `min_uptime_sec`
      resets the failure count, so only *rapid* consecutive crashes walk
      toward give-up.
    - ``loop=True``: `target` is ONE iteration (e.g. one micro-batch
      interval). It is invoked repeatedly until the stop event is set;
      each normal return resets the failure count.

    Once the policy is exhausted the thread gives up: `healthy` flips
    False, `<metrics_prefix>.giveups` increments, and the owning layer
    reports unhealthy. `on_failure(exc)` (if given) runs after each
    failure, before the backoff — the hook the speed layer uses to
    dead-letter poison blocks.
    """

    def __init__(
        self,
        name: str,
        target: Callable[[], None],
        policy: RetryPolicy,
        stop_event: threading.Event,
        *,
        loop: bool = False,
        metrics_prefix: str | None = None,
        on_failure: Callable[[BaseException], None] | None = None,
        min_uptime_sec: float = 5.0,
    ) -> None:
        self.name = name
        self._target = target
        self._policy = policy
        self._stop_event = stop_event
        self._loop = loop
        self._metrics_prefix = metrics_prefix or f"supervised.{name}"
        self._on_failure = on_failure
        self._min_uptime_sec = min_uptime_sec
        # guards _gave_up/restarts: written on the supervisor thread,
        # read by health probes on request threads (oryxlint ORX102)
        self._state_lock = threading.Lock()
        self._gave_up = False
        self.restarts = 0
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        metrics.registry.gauge(f"{self._metrics_prefix}.healthy").set(1)

    # -- thread surface ------------------------------------------------------

    def start(self) -> None:
        from oryx_tpu_torch.common import ledger

        self._thread.start()
        # registered at start (not construction) so an unstarted thread
        # never counts as a live resource; live while the OS thread runs
        ledger.register("thread", self, live=SupervisedThread.is_alive)

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def healthy(self) -> bool:
        with self._state_lock:
            return not self._gave_up

    @property
    def gave_up(self) -> bool:
        with self._state_lock:
            return self._gave_up

    # -- supervisor loop -----------------------------------------------------

    def _run(self) -> None:
        failures = 0
        while not self._stop_event.is_set():
            started = time.monotonic()
            try:
                self._target()
                if not self._loop:
                    return
                failures = 0
                continue
            except Exception as e:  # noqa: BLE001 - that's the job
                if self._stop_event.is_set():
                    return
                log.exception("supervised thread %s failed", self.name)
                metrics.registry.counter(f"{self._metrics_prefix}.restarts").inc()
                if self._on_failure is not None:
                    try:
                        self._on_failure(e)
                    except Exception:  # noqa: BLE001
                        log.exception("on_failure hook for %s failed", self.name)
                if not self._loop and time.monotonic() - started >= self._min_uptime_sec:
                    failures = 0
                failures += 1
                with self._state_lock:
                    self.restarts += 1
                delay = self._policy.backoff_or_none(failures)
                if delay is None:
                    with self._state_lock:
                        self._gave_up = True
                    metrics.registry.counter(f"{self._metrics_prefix}.giveups").inc()
                    metrics.registry.gauge(f"{self._metrics_prefix}.healthy").set(0)
                    log.error(
                        "supervised thread %s giving up after %d consecutive failures",
                        self.name,
                        failures,
                    )
                    return
                self._stop_event.wait(delay)
