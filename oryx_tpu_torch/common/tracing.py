"""Lightweight always-on sampled distributed tracer (Dapper-style).

Answers the two questions the flat `/metrics` registry cannot: "where did
this request's 9 ms go?" and "how stale is what serving returns?". The
design follows Dapper / W3C Trace Context:

- A ``TraceContext`` is (trace id, span id, sampled flag), serialized as
  the W3C ``traceparent`` string ``00-<32hex>-<16hex>-<2hex>``. HTTP
  clients send it as a ``traceparent`` header; bus publishers carry it in
  a reserved control record (key ``@trc``) prepended to the batch, so the
  same context flows through every transport (inproc / file / net / shm
  text frames) without any transport-specific framing. The shm columnar
  path uses a dedicated zero-count trace frame (blockcodec KIND_TRACE).
- Sampling is parent-based: an incoming sampled context is always
  honored; new roots sample at ``oryx.tracing.sample-rate``. Unsampled
  work records nothing and emits no bus header — the hot columnar paths
  stay byte-identical to the untraced build.
- Completed spans land in a bounded in-process ring buffer (oldest
  evicted first) with parent links, exported as Chrome-trace JSON
  (``GET /trace`` on the serving layer, ``cli trace``) or as a raw span
  list for tests.

The control-record message is ``<traceparent or "-">[;ts=<ms>]`` where ``ts``
is the origin ingest timestamp (epoch ms): speed publishes stamp the
micro-batch's earliest event-ingest time, model publishes stamp publish
time — consumers derive the freshness histogram (event-ingest to
servable-visibility) and the per-generation propagation skew from it.

Config: ``oryx.tracing.enabled`` / ``oryx.tracing.sample-rate`` /
``oryx.tracing.ring-capacity``; env overrides ``ORYX_TRACING`` (0/1) and
``ORYX_TRACING_SAMPLE_RATE`` let the bench toggle tracing in
subprocesses without threading config through every tool.

Port note: a copy of ``oryx_tpu/common/tracing.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass

# Reserved bus record key for the trace control record. Consumers strip
# it from delivered blocks and surface it as ``block.trace``.
TRACE_KEY = "@trc"

_DEFAULT_SAMPLE_RATE = 0.01
_DEFAULT_RING_CAPACITY = 4096


def _env_enabled(default: bool) -> bool:
    raw = os.environ.get("ORYX_TRACING")
    if raw is None:
        return default
    return raw.strip() not in ("0", "false", "no", "off", "")


def _env_sample_rate(default: float) -> float:
    raw = os.environ.get("ORYX_TRACING_SAMPLE_RATE")
    if raw is None:
        return default
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return default


_lock = threading.Lock()
_enabled: bool = _env_enabled(True)
_sample_rate: float = _env_sample_rate(_DEFAULT_SAMPLE_RATE)
_ring: deque = deque(maxlen=_DEFAULT_RING_CAPACITY)
_recorded: int = 0
# private RNG: sampling must not consume draws from the global `random`
# sequence tests seed deterministically
_rng = random.Random()
_local = threading.local()


@dataclass(frozen=True)
class TraceContext:
    """W3C-style trace context: ids are lowercase hex strings."""

    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    sampled: bool = True

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"

    def child(self) -> "TraceContext":
        """Same trace, fresh span id (a redelivered duplicate gets the
        same trace id but a new span per delivery)."""
        return TraceContext(self.trace_id, _new_span_id(), self.sampled)


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(value: str | None) -> TraceContext | None:
    """Parse a ``traceparent`` header; None when malformed (malformed
    context never poisons the request — it just starts untraced)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16 or len(flags) != 2:
        return None
    try:
        int(version, 16)
        int(flags, 16)
        bad = int(trace_id, 16) == 0 or int(span_id, 16) == 0
    except ValueError:
        return None
    if version == "ff" or bad:
        return None
    return TraceContext(trace_id.lower(), span_id.lower(), bool(int(flags, 16) & 1))


# -- configuration -----------------------------------------------------------


def configure(
    enabled: bool | None = None,
    sample_rate: float | None = None,
    ring_capacity: int | None = None,
) -> None:
    global _enabled, _sample_rate, _ring
    with _lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if sample_rate is not None:
            _sample_rate = min(1.0, max(0.0, float(sample_rate)))
        if ring_capacity is not None and ring_capacity != _ring.maxlen:
            _ring = deque(_ring, maxlen=max(1, int(ring_capacity)))


def configure_from(config) -> None:
    """Apply ``oryx.tracing.*``; env vars win (bench subprocess toggle)."""
    enabled = config.get("oryx.tracing.enabled", True)
    rate = config.get("oryx.tracing.sample-rate", _DEFAULT_SAMPLE_RATE)
    cap = config.get("oryx.tracing.ring-capacity", _DEFAULT_RING_CAPACITY)
    configure(
        enabled=_env_enabled(bool(enabled)),
        sample_rate=_env_sample_rate(float(rate)),
        ring_capacity=int(cap),
    )


def enabled() -> bool:
    return _enabled


def sample_rate() -> float:
    return _sample_rate


def reset() -> None:
    """Test hook: clear the ring and ambient context, restore defaults."""
    global _enabled, _sample_rate, _ring, _recorded
    with _lock:
        _enabled = _env_enabled(True)
        _sample_rate = _env_sample_rate(_DEFAULT_SAMPLE_RATE)
        _ring = deque(maxlen=_DEFAULT_RING_CAPACITY)
        _recorded = 0
    _local.ctx = None


# -- ambient context ---------------------------------------------------------


def current() -> TraceContext | None:
    return getattr(_local, "ctx", None)


@contextmanager
def use(ctx: TraceContext | None):
    """Set the thread's ambient context for the body."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def sample_root() -> TraceContext | None:
    """Roll the sampling dice for a new root; None when unsampled (the
    caller then records nothing and emits no headers)."""
    if not _enabled or _sample_rate <= 0.0:
        return None
    if _sample_rate < 1.0 and _rng.random() >= _sample_rate:
        return None
    return TraceContext(_new_trace_id(), _new_span_id(), True)


def continue_from(ctx_or_traceparent) -> TraceContext | None:
    """Child context continuing an incoming trace (parent-based sampling:
    a sampled parent is always honored). Accepts a TraceContext or a raw
    traceparent string; None when absent/unsampled/disabled."""
    if not _enabled:
        return None
    ctx = ctx_or_traceparent
    if isinstance(ctx, str):
        ctx = parse_traceparent(ctx)
    if ctx is None or not ctx.sampled:
        return None
    return ctx.child()


# -- span recording ----------------------------------------------------------


class Span:
    """Handle yielded by ``span()``; ``set()`` attaches attributes."""

    __slots__ = ("name", "ctx", "parent_id", "attrs", "_t0", "_wall0")

    def __init__(self, name: str, ctx: TraceContext, parent_id: str | None, attrs):
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self._t0 = time.perf_counter()
        self._wall0 = time.time()

    def set(self, key: str, value) -> None:
        self.attrs[key] = value


class _NullSpan:
    __slots__ = ()
    ctx = None

    def set(self, key: str, value) -> None:
        pass


_NULL_SPAN = _NullSpan()


def record_span(
    name: str,
    ctx: TraceContext,
    parent_id: str | None,
    wall_start: float,
    duration: float,
    attrs: dict | None = None,
) -> None:
    """Append one completed span to the ring (explicit-timestamp form,
    for call sites that measured the interval themselves, e.g. the
    batcher's queue-wait)."""
    global _recorded
    if not _enabled or not ctx.sampled:
        return
    entry = {
        "name": name,
        "trace": ctx.trace_id,
        "span": ctx.span_id,
        "parent": parent_id,
        "ts": wall_start,
        "dur": max(0.0, duration),
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "attrs": dict(attrs) if attrs else {},
    }
    with _lock:
        _ring.append(entry)
        _recorded += 1


@contextmanager
def span(
    name: str,
    ctx: TraceContext | None = None,
    attrs: dict | None = None,
    root: bool = False,
):
    """Record a span around the body. ``ctx`` (or the ambient context)
    is the PARENT; the body runs with a fresh child context ambient so
    nested spans and bus headers link to this span. With ``root=True``
    and no traced parent, the sampling dice are rolled and (if sampled)
    the span becomes a trace root with no parent link. No-op (null span)
    when untraced."""
    parent = ctx if ctx is not None else current()
    if not _enabled or parent is None or not parent.sampled:
        if root:
            rc = sample_root()
            if rc is not None:
                sp = Span(name, rc, None, attrs)
                prev = getattr(_local, "ctx", None)
                _local.ctx = rc
                try:
                    yield sp
                finally:
                    _local.ctx = prev
                    record_span(
                        name, rc, None, sp._wall0,
                        time.perf_counter() - sp._t0, sp.attrs,
                    )
                return
        yield _NULL_SPAN
        return
    child = parent.child()
    sp = Span(name, child, parent.span_id, attrs)
    prev = getattr(_local, "ctx", None)
    _local.ctx = child
    try:
        yield sp
    finally:
        _local.ctx = prev
        record_span(
            name, child, parent.span_id, sp._wall0, time.perf_counter() - sp._t0, sp.attrs
        )


def spans(trace_id: str | None = None) -> list[dict]:
    """Snapshot of recorded spans (optionally one trace), oldest first."""
    with _lock:
        out = list(_ring)
    if trace_id is not None:
        out = [s for s in out if s["trace"] == trace_id]
    return out


def stats() -> dict:
    with _lock:
        return {
            "enabled": _enabled,
            "sample_rate": _sample_rate,
            "ring_capacity": _ring.maxlen,
            "buffered": len(_ring),
            "recorded": _recorded,
        }


def export_chrome(trace_id: str | None = None) -> dict:
    """Chrome-trace/Perfetto JSON (load via chrome://tracing or
    ui.perfetto.dev). Durations are complete events (ph "X")."""
    events = []
    for s in spans(trace_id):
        events.append(
            {
                "name": s["name"],
                "ph": "X",
                "ts": s["ts"] * 1e6,
                "dur": s["dur"] * 1e6,
                "pid": s["pid"],
                "tid": s["tid"],
                "args": {
                    "trace": s["trace"],
                    "span": s["span"],
                    "parent": s["parent"],
                    **s["attrs"],
                },
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms", **stats()}


# -- bus control-record carriage ---------------------------------------------


def header_record(
    ctx: TraceContext | None = None, ingest_ms: int | None = None
) -> tuple[str, str] | None:
    """The ``@trc`` control record to prepend to a bus batch, or None
    when there is nothing to carry (untraced and no origin timestamp) —
    the default-off case that keeps hot paths header-free."""
    if not _enabled:
        return None
    if ctx is None:
        ctx = current()
    traced = ctx is not None and ctx.sampled
    if not traced and ingest_ms is None:
        return None
    msg = ctx.traceparent() if traced else "-"
    if ingest_ms is not None:
        msg += f";ts={int(ingest_ms)}"
    return (TRACE_KEY, msg)


def with_header(records, ctx: TraceContext | None = None, ingest_ms: int | None = None):
    """(records-with-optional-header, extra) — ``extra`` is how many
    control records were prepended (0 or 1) so publishers can report
    caller-visible counts: ``sent = producer.send_many(recs) - extra``."""
    header = header_record(ctx, ingest_ms)
    out = records if isinstance(records, list) else list(records)
    if header is None:
        return out, 0
    return [header, *out], 1


@dataclass(frozen=True)
class BlockTrace:
    """Parsed ``@trc`` message as surfaced on ``block.trace``."""

    ctx: TraceContext | None
    ingest_ms: int | None


def parse_header(message: str | bytes | None) -> BlockTrace | None:
    """Parse a ``@trc`` control-record message; None when absent."""
    if message is None:
        return None
    if isinstance(message, bytes):
        message = message.decode("utf-8", "replace")
    head, _, rest = message.partition(";")
    ctx = None if head in ("", "-") else parse_traceparent(head)
    ingest = None
    for part in rest.split(";"):
        if part.startswith("ts="):
            try:
                ingest = int(part[3:])
            except ValueError:
                ingest = None
    return BlockTrace(ctx, ingest)
