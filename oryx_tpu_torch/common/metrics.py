"""Step/request metrics: counters, gauges, latency histograms.

The reference has no metrics registry at all — observability is the Spark
web UI plus log lines every 10k updates (SURVEY.md §5: "Rebuild should
exceed this (step metrics, eval metrics, serving QPS/latency
histograms)"). This module is that exceedance: a small thread-safe
registry the layers report into, exposed by the serving layer at
/metrics as JSON.

Port note: a copy of ``oryx_tpu/common/metrics.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PROMETHEUS_CONTENT_TYPE",
    "SLOWindow",
    "registry",
    "render_prometheus",
    "timed",
]


class Counter:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict[str, Any]:
        return {"type": "counter", "value": self._value}


class Gauge:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value: float | None = None

    def set(self, value: float) -> None:
        # a bare float store is atomic in CPython, but `set` must stay
        # safe if a gauge ever grows read-modify-write semantics; the
        # uncontended lock costs ~100ns on a path that is never hot
        with self._lock:
            self._value = value

    @property
    def value(self) -> float | None:
        with self._lock:
            return self._value

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {"type": "gauge", "value": self._value}


class Histogram:
    """Log-bucketed histogram for latencies/durations in seconds.

    Buckets are powers of `base` from `start` (default: 1 µs up through
    ~2 min); quantiles are estimated from bucket boundaries — plenty for
    QPS/latency dashboards and assertions in tests.
    """

    def __init__(self, start: float = 1e-6, base: float = 2.0, count: int = 28) -> None:
        self._lock = threading.Lock()
        self._bounds = [start * base**i for i in range(count)]
        self._buckets = [0] * (count + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = 0.0

    def observe(self, value: float) -> None:
        idx = 0
        while idx < len(self._bounds) and value > self._bounds[idx]:
            idx += 1
        with self._lock:
            self._buckets[idx] += 1
            self._sum += value
            self._count += 1
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    def merge_buckets(self, buckets, total_sum: float) -> None:
        """Fold pre-bucketed observations in (native-front stats drain).

        ``buckets`` must use THIS histogram's bucketing (the C++ side
        mirrors the 1e-6·2^i bounds and the same upper-bound-inclusive
        index rule); ``total_sum`` is the sum of the raw values in
        seconds. min/max are approximated by the populated bucket
        bounds — exact raw values never crossed the drain."""
        n = sum(buckets)
        if n == 0:
            return
        with self._lock:
            for i, c in enumerate(buckets):
                if i < len(self._buckets):
                    self._buckets[i] += c
                else:
                    self._buckets[-1] += c
            self._sum += total_sum
            self._count += n
            lo = next(i for i, c in enumerate(buckets) if c)
            hi = max(i for i, c in enumerate(buckets) if c)
            self._min = min(self._min, self._bounds[lo] if lo < len(self._bounds) else self._bounds[-1])
            self._max = max(self._max, self._bounds[hi] if hi < len(self._bounds) else self._bounds[-1])

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def _quantile_locked(self, q: float) -> float:
        target = q * self._count
        seen = 0
        for i, c in enumerate(self._buckets):
            seen += c
            if seen >= target:
                return self._bounds[i] if i < len(self._bounds) else self._max
        return self._max

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile observation."""
        with self._lock:
            if not self._count:
                return 0.0
            return self._quantile_locked(q)

    def snapshot(self) -> dict[str, Any]:
        # the whole snapshot is taken under ONE lock acquisition so a
        # concurrent observe() can never yield a torn view (e.g. a count
        # that doesn't match the bucket sum, or a min/max from a later
        # observation than the count reflects)
        with self._lock:
            if not self._count:
                return {"type": "histogram", "count": 0}
            cumulative = []
            seen = 0
            for i, c in enumerate(self._buckets):
                seen += c
                le = self._bounds[i] if i < len(self._bounds) else math.inf
                cumulative.append((le, seen))
            return {
                "type": "histogram",
                "count": self._count,
                "mean": self._sum / self._count,
                "min": self._min,
                "max": self._max,
                "p50": self._quantile_locked(0.50),
                "p90": self._quantile_locked(0.90),
                "p99": self._quantile_locked(0.99),
                "sum": self._sum,
                # cumulative (le, count) pairs, Prometheus-style, ending
                # with the +Inf bucket == count
                "buckets": cumulative,
            }


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is {type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


class SLOWindow:
    """Sliding-window SLO accounting with burn rates (Google SRE workbook
    multi-window style): record per-request (ok, latency) events, then ask
    for the error rate, a latency quantile, or a *burn rate* — the ratio
    of the observed bad fraction to the fraction the SLO budgets — over
    any trailing window up to `horizon_s`.

    A burn rate of 1.0 consumes the error budget exactly as fast as the
    SLO allows; sustained > 1.0 means the budget exhausts early (14.4x
    over 1h burns a 30-day 99.9% budget in ~2 days — the classic paging
    threshold). The open-loop traffic harness asserts burn rates over
    short windows as first-class test outcomes (docs/traffic-harness.md).

    Thread-safe; `clock` is injectable for deterministic tests.
    """

    def __init__(self, horizon_s: float = 600.0, clock=time.monotonic) -> None:
        self._horizon = horizon_s
        self._clock = clock
        self._lock = threading.Lock()
        # (t, ok, latency_s) — appended monotonically, pruned from the left
        self._events: deque[tuple[float, bool, float]] = deque()

    def record(self, ok: bool, latency_s: float, now: float | None = None) -> None:
        t = self._clock() if now is None else now
        with self._lock:
            self._events.append((t, bool(ok), float(latency_s)))
            cutoff = t - self._horizon
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()

    def _window(self, window_s: float, now: float | None) -> list[tuple[float, bool, float]]:
        t = self._clock() if now is None else now
        cutoff = t - window_s
        with self._lock:
            return [e for e in self._events if e[0] >= cutoff]

    def count(self, window_s: float, now: float | None = None) -> int:
        return len(self._window(window_s, now))

    def error_rate(self, window_s: float, now: float | None = None) -> float:
        """Fraction of requests in the window that failed (0.0 when empty)."""
        ev = self._window(window_s, now)
        if not ev:
            return 0.0
        return sum(1 for _, ok, _ in ev if not ok) / len(ev)

    def error_burn_rate(
        self, window_s: float, slo_error_rate: float, now: float | None = None
    ) -> float:
        """observed error fraction / budgeted error fraction over the window."""
        if slo_error_rate <= 0.0:
            # a zero-error SLO: any failure is an infinite burn
            return math.inf if self.error_rate(window_s, now) > 0.0 else 0.0
        return self.error_rate(window_s, now) / slo_error_rate

    def latency_quantile(self, q: float, window_s: float, now: float | None = None) -> float:
        """Latency quantile over the window's requests (0.0 when empty)."""
        lats = sorted(lat for _, _, lat in self._window(window_s, now))
        if not lats:
            return 0.0
        return lats[min(len(lats) - 1, int(q * len(lats)))]

    def latency_burn_rate(
        self,
        window_s: float,
        threshold_s: float,
        slo_violation_rate: float,
        now: float | None = None,
    ) -> float:
        """Burn rate of a latency SLO of the form "no more than
        `slo_violation_rate` of requests slower than `threshold_s`"
        (e.g. p99 <= 50 ms is threshold_s=0.05, slo_violation_rate=0.01)."""
        ev = self._window(window_s, now)
        if not ev:
            return 0.0
        slow = sum(1 for _, _, lat in ev if lat > threshold_s) / len(ev)
        if slo_violation_rate <= 0.0:
            return math.inf if slow > 0.0 else 0.0
        return slow / slo_violation_rate


registry = MetricsRegistry()
"""Process-global default registry (each layer is its own process)."""


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_PROM_BAD_CHARS = None  # compiled lazily; most processes never render


def _prom_name(name: str) -> str:
    global _PROM_BAD_CHARS
    if _PROM_BAD_CHARS is None:
        import re

        _PROM_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
    out = _PROM_BAD_CHARS.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_num(v) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def render_prometheus(snapshot: dict[str, dict[str, Any]]) -> str:
    """A registry snapshot as Prometheus text exposition format 0.0.4,
    for standard scrapers (`/metrics` content-negotiates this alongside
    the JSON form). Dotted names map to underscored ones; histograms emit
    cumulative `_bucket{le=...}` series plus `_sum` / `_count`; unset
    gauges are omitted. Unknown entry shapes are skipped, so callers can
    merge extra JSON-only context into the dict without breaking
    scrapers."""
    lines: list[str] = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        if not isinstance(entry, dict):
            continue
        kind = entry.get("type")
        pname = _prom_name(name)
        if kind == "counter":
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_prom_num(entry.get('value') or 0.0)}")
        elif kind == "gauge":
            value = entry.get("value")
            if value is None:
                continue
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_prom_num(value)}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            buckets = entry.get("buckets") or []
            for le, cum in buckets:
                le_s = "+Inf" if math.isinf(float(le)) else _prom_num(le)
                lines.append(f'{pname}_bucket{{le="{le_s}"}} {cum}')
            if not buckets:  # empty histogram still needs its +Inf bucket
                lines.append(f'{pname}_bucket{{le="+Inf"}} 0')
            lines.append(f"{pname}_sum {_prom_num(entry.get('sum') or 0.0)}")
            lines.append(f"{pname}_count {entry.get('count') or 0}")
    return "\n".join(lines) + "\n"


class timed:
    """Context manager observing elapsed seconds into a histogram:

    with timed(registry.histogram("serving.request.seconds")): ...
    """

    def __init__(self, histogram: Histogram) -> None:
        self._h = histogram

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._h.observe(time.perf_counter() - self._t0)
        return False
