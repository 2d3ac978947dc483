"""Request micro-batcher: coalesce concurrent top-N calls into batched
scans on the card (counterpart of ``oryx_tpu/serving/batcher.py``).

The same scheduler as the JAX package's:

- request threads enqueue (item-matrix handle, query or staged-row
  index, k, cosine) and block on an event;
- a dispatcher thread takes whatever is queued the moment it wakes,
  groups entries by (matrix snapshot, cosine, staged query matrix), pads
  k and the row count to power-of-two buckets and submits the group
  asynchronously (``topn.submit_top_k`` / ``submit_top_k_multi`` /
  ``submit_top_k_multi_indexed``);
- a completer thread resolves the handles in submission order and wakes
  the request threads, so batch r's results come back while the card
  works on batch r+1.

The scheduler is adaptive: an EWMA of dispatch latency sizes the inflight
depth and the batch ceiling, and while every inflight slot is taken the
dispatcher keeps absorbing arrivals in 1 ms waits so one full batch goes
out where several padded fragments would have.

Overload control as in the JAX package: the queue is bounded
(``oryx.serving.overload.max-queue``: an entry past the bound raises
:class:`BatcherOverloadedError` at once and counts
``serving.batcher.queue.rejected``, and the serving layer answers 429);
a second EWMA, of each group's worst wait from enqueue to dispatch (an
inflight slot held), is the admission controller's pressure signal
(:func:`default_batcher_signals`); and a request's reduced-probe
fraction (``serving/overload.probe_override``) rides its entry, keys its
dispatch group, and scales an IVF index's ``nprobe`` for that group.
Before a vector group's submit, an IVF index with a tiered host plane
gets the advisory ``prefetch_for_queries`` hint (a failing hint never
fails the dispatch).

Not ported yet: tenancy (the deficit-round-robin queue serves the single
default tenant, and no tenant's share of the bound is kept).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from oryx_tpu_torch.common import tracing
from oryx_tpu_torch.common.metrics import registry as _metrics
from oryx_tpu_torch.ops import topn as topn_ops
from oryx_tpu_torch.serving.overload import active_probe_fraction

log = logging.getLogger(__name__)

# Adaptive-scheduler tuning (oryx.serving.scan.* maps onto these via the
# serving layer).
LATENCY_BUDGET_MS = float(os.environ.get("ORYX_BATCHER_LATENCY_BUDGET_MS", 50.0))
EWMA_ALPHA = 0.25  # completer's dispatch-latency smoothing
MIN_ADAPTIVE_BATCH = 256  # one full scan group
MAX_ADAPTIVE_BATCH = 4096
MIN_INFLIGHT = 2  # always enough to overlap host prep with card work
MAX_INFLIGHT = 32

# Queue-wait EWMA (the admission controller's pressure signal): smoothing
# factor per dispatch, plus an idle decay so the signal fades once the
# queue goes quiet — without it a burst's last reading would pin the shed
# ladder engaged long after the overload passed.
WAIT_EWMA_ALPHA = 0.3
WAIT_DECAY_GRACE_S = 0.25
WAIT_DECAY_HALF_LIFE_S = 0.5


class BatcherClosedError(RuntimeError):
    """Raised by ``score`` when the batcher was closed before the entry
    could be enqueued; ``score_default`` retries only this."""


class BatcherOverloadedError(RuntimeError):
    """Raised by ``score`` when the bounded queue is full
    (``oryx.serving.overload.max-queue``): an immediate shed decision for
    the caller, never retried by ``score_default``."""


@dataclass
class _Entry:
    uploaded: object
    query: np.ndarray | None  # None for index-submitted entries
    k: int
    cosine: bool
    x_dev: object | None = None  # card-resident query matrix (index entries)
    row: int | None = None  # row into x_dev
    done: threading.Event = field(default_factory=threading.Event)
    idx: np.ndarray | None = None
    vals: np.ndarray | None = None
    error: BaseException | None = None
    # tracing: the request's sampled context captured at enqueue, plus the
    # wall-clock phase stamps the completer turns into spans
    trace_ctx: object | None = None
    t_enqueue: float = 0.0
    t_dispatch: float = 0.0
    t_submit: float = 0.0
    # overload control: monotonic enqueue stamp feeding the queue-wait
    # EWMA (always set, unlike the tracing stamps), plus the request's
    # reduced-probe override, snapshotted from the admission contextvar on
    # the request thread so it rides the entry to the dispatcher
    t_q: float = 0.0
    probe_fraction: float | None = None
    nprobe_applied: int | None = None


def _k_bucket(k: int) -> int:
    return max(16, 1 << (int(k) - 1).bit_length())


def _b_bucket(n: int) -> int:
    """Batch-row bucket: coalesced batches pad to power-of-two row counts
    (zero queries), the JAX package's shapes."""
    return max(8, 1 << (int(n) - 1).bit_length())


def _record_entry_spans(e: _Entry, t_done: float) -> None:
    """One request's batching lifecycle as three sibling spans under the
    request span: queue-wait, assemble (grouping + submit), scan; the
    scan carries the IVF probe count when the handle is an IVF index."""
    ctx = e.trace_ctx
    attrs = None
    if e.nprobe_applied is not None:
        attrs = {"nprobe": e.nprobe_applied, "probe_fraction": e.probe_fraction}
    else:
        resolve_nprobe = getattr(e.uploaded, "resolve_nprobe", None)
        if resolve_nprobe is not None:
            try:
                attrs = {"nprobe": int(resolve_nprobe())}
            except Exception:
                attrs = None
    tracing.record_span(
        "serving.queue-wait", ctx.child(), ctx.span_id,
        e.t_enqueue, e.t_dispatch - e.t_enqueue,
    )
    tracing.record_span(
        "serving.assemble", ctx.child(), ctx.span_id,
        e.t_dispatch, e.t_submit - e.t_dispatch,
    )
    tracing.record_span(
        "serving.scan", ctx.child(), ctx.span_id,
        e.t_submit, t_done - e.t_submit, attrs,
    )


class _FairQueue:
    """Deficit-round-robin queue over per-tenant sub-queues, serving the
    single default tenant (plain FIFO) until tenancy is ported.

    The close sentinel (``put(None)``) is a flag, not a queued item:
    ``get`` keeps draining real entries first and only yields ``None``
    once every sub-queue is empty."""

    _DEFAULT = ""  # sub-queue key for untenanted entries

    def __init__(self, quantum: float = 8.0) -> None:
        self._cv = threading.Condition()
        self._quantum = max(1.0, float(quantum))
        self._queues: dict[str, "deque[_Entry]"] = {}
        self._rr: "deque[str]" = deque()  # tenants with queued entries
        self._credit: dict[str, float] = {}
        self._size = 0
        self._sentinel = False

    def put(self, e) -> None:
        with self._cv:
            if e is None:
                self._sentinel = True
                self._cv.notify_all()
                return
            key = self._DEFAULT
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
            if not q:
                self._rr.append(key)
                self._credit[key] = self._quantum
            q.append(e)
            self._size += 1
            self._cv.notify()

    def _pop_locked(self):
        while True:
            key = self._rr[0]
            q = self._queues[key]
            if self._credit[key] >= 1.0:
                self._credit[key] -= 1.0
                e = q.popleft()
                self._size -= 1
                if not q:
                    self._rr.popleft()
                return e
            self._rr.rotate(-1)
            self._credit[key] = self._quantum

    def get(self, block: bool = True, timeout: float | None = None):
        with self._cv:
            if not block:
                if self._size:
                    return self._pop_locked()
                if self._sentinel:
                    return None
                raise queue.Empty
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._size and not self._sentinel:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise queue.Empty
                self._cv.wait(remaining)
            if self._size:
                return self._pop_locked()
            return None  # sentinel, queues drained

    def get_nowait(self):
        return self.get(block=False)

    def qsize(self) -> int:
        with self._cv:
            return self._size


class TopNBatcher:
    """Coalesces concurrent ``score`` calls into batched submits.
    Thread-safe; one instance serves any number of models (entries carry
    their own item-matrix handle)."""

    # coalesced groups past this many rows go through submit_top_k_multi:
    # ceil(n/256) scans submitted at once
    MULTI_THRESHOLD = 256

    def __init__(
        self,
        max_batch: int | None = None,
        max_inflight: int | None = None,
        max_queue: int | None = None,
    ) -> None:
        # None => adaptive: the completer resizes the knob from its EWMA
        # of dispatch latency; an explicit value pins it
        self._adaptive_batch = max_batch is None
        self._adaptive_inflight = max_inflight is None
        self.max_batch = MIN_ADAPTIVE_BATCH if max_batch is None else int(max_batch)
        self._inflight_cap = MIN_INFLIGHT + 2 if max_inflight is None else int(max_inflight)
        self._ewma_ms: float | None = None
        # queue-wait EWMA (the admission controller's primary pressure
        # signal); guarded by _flight_cv like the dispatch EWMA
        self._queue_wait_ewma_ms = 0.0
        self._last_wait_obs = time.monotonic()
        # queued entries past this raise BatcherOverloadedError; None = unbounded
        self._max_queue = None if max_queue is None else int(max_queue)
        self._queue = _FairQueue()
        self._pending: queue.Queue = queue.Queue()
        # inflight tracked under a Condition so the adaptive cap can move
        # while dispatches are blocked on it
        self._flight_cv = threading.Condition()
        self._inflight_count = 0
        self._state_lock = threading.Lock()  # serializes score-enqueue vs close
        self._closed = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="TopNBatcherDispatch", daemon=True
        )
        self._completer = threading.Thread(
            target=self._complete_loop, name="TopNBatcherComplete", daemon=True
        )
        self._dispatcher.start()
        self._completer.start()

    # -- request side --------------------------------------------------------

    def score(
        self, uploaded, query: np.ndarray, k: int, cosine: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        """(indices, scores) for one query — blocks until its batch lands.
        Fewer than ``k`` rows come back when the matrix has fewer items."""
        e = _Entry(uploaded, np.asarray(query, dtype=np.float32), int(k), bool(cosine))
        return self._enqueue(e)

    def score_indexed(
        self, uploaded, x_dev, row: int, k: int, cosine: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        """score() with the query vector already on the card: the entry
        carries only a row into ``x_dev``."""
        e = _Entry(uploaded, None, int(k), bool(cosine), x_dev=x_dev, row=int(row))
        return self._enqueue(e)

    def _enqueue(self, e: _Entry) -> tuple[np.ndarray, np.ndarray]:
        if tracing.enabled():
            ctx = tracing.current()
            if ctx is not None and ctx.sampled:
                e.trace_ctx = ctx
                e.t_enqueue = time.time()
        # the admission controller's reduced-probe override, read here on
        # the request thread that carries the contextvar
        e.probe_fraction = active_probe_fraction()
        e.t_q = time.monotonic()
        with self._state_lock:  # an entry can never land after the sentinel
            if self._closed:
                raise BatcherClosedError("batcher is closed")
            if self._max_queue is not None and self._queue.qsize() >= self._max_queue:
                # approximate bound (qsize races concurrent enqueues by a
                # few entries) — exactness doesn't matter, unboundedness does
                _metrics.counter("serving.batcher.queue.rejected").inc()
                raise BatcherOverloadedError(f"batcher queue full ({self._max_queue} entries)")
            self._queue.put(e)
            _metrics.gauge("serving.batcher.queue.depth").set(self._queue.qsize())
        e.done.wait()
        if e.error is not None:
            raise e.error
        return e.idx, e.vals

    # -- dispatcher ----------------------------------------------------------

    def _device_busy(self) -> bool:
        with self._flight_cv:
            return self._inflight_count >= self._inflight_cap

    def _take_batch(self) -> list[_Entry] | None:
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        coalesced = 0
        with self._flight_cv:
            max_batch = self.max_batch
        while len(batch) < max_batch:
            try:
                e = self._queue.get_nowait()
            except queue.Empty:
                # with every inflight slot taken this thread is about to
                # block anyway: absorb arrivals instead of dispatching a
                # dribble of padded fragments
                if not self._device_busy():
                    break
                try:
                    e = self._queue.get(timeout=0.001)
                except queue.Empty:
                    continue
                coalesced += 1
            if e is None:
                self._queue.put(None)  # keep the shutdown signal visible
                break
            batch.append(e)
        if coalesced:
            _metrics.counter("serving.batcher.coalesced").inc(coalesced)
        _metrics.gauge("serving.batcher.queue.depth").set(self._queue.qsize())
        _metrics.gauge("serving.batcher.batch_size").set(len(batch))
        return batch

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                self._pending.put(None)
                return
            # group by (matrix snapshot, cosine, query-matrix snapshot,
            # probe override): indices are only meaningful against the
            # snapshots the caller captured, vector entries never mix with
            # index entries, and a reduced-probe request must not widen a
            # full-probe neighbour's scan (or the other way round)
            groups: dict[tuple, list[_Entry]] = {}
            for e in batch:
                xk = id(e.x_dev) if e.row is not None else None
                groups.setdefault(
                    (id(e.uploaded), e.cosine, xk, e.probe_fraction), []
                ).append(e)
            for (_, cosine, _xk, _pf), entries in groups.items():
                self._submit_group(entries, cosine)

    def _acquire_slot(self) -> None:
        with self._flight_cv:
            while self._inflight_count >= self._inflight_cap:
                self._flight_cv.wait(timeout=1.0)
            self._inflight_count += 1
            _metrics.gauge("serving.batcher.inflight").set(self._inflight_count)

    def _release_slot(self, latency_s: float | None = None) -> None:
        with self._flight_cv:
            self._inflight_count -= 1
            _metrics.gauge("serving.batcher.inflight").set(self._inflight_count)
            if latency_s is not None:
                self._observe_latency(latency_s * 1000.0)
            self._flight_cv.notify()

    def _observe_latency(self, ms: float) -> None:
        """EWMA the dispatch latency and resize the adaptive knobs from it
        (caller holds ``_flight_cv``): inflight depth ~ budget / dispatch
        cost (+2 keeps host/card overlap), and the batch ceiling widens
        while dispatches stay well inside the budget."""
        self._ewma_ms = (
            ms
            if self._ewma_ms is None
            else EWMA_ALPHA * ms + (1.0 - EWMA_ALPHA) * self._ewma_ms
        )
        _metrics.gauge("serving.batcher.dispatch_ewma_ms").set(self._ewma_ms)
        if self._adaptive_inflight:
            self._inflight_cap = int(
                min(max(LATENCY_BUDGET_MS / max(self._ewma_ms, 1e-3) + 2, MIN_INFLIGHT), MAX_INFLIGHT)
            )
        if self._adaptive_batch:
            if self._ewma_ms > LATENCY_BUDGET_MS and self.max_batch > MIN_ADAPTIVE_BATCH:
                self.max_batch //= 2
            elif self._ewma_ms < LATENCY_BUDGET_MS / 2 and self.max_batch < MAX_ADAPTIVE_BATCH:
                self.max_batch *= 2
            self.max_batch = max(MIN_ADAPTIVE_BATCH, min(self.max_batch, MAX_ADAPTIVE_BATCH))

    def _group_nprobe(self, entries: list[_Entry]) -> int | None:
        """Resolve a reduced-probe override into a concrete ``nprobe`` for
        one group (its entries share one probe fraction by group key).
        None when the group runs at full quality or the handle is not an
        IVF index."""
        pf = entries[0].probe_fraction
        if pf is None:
            return None
        resolve = getattr(entries[0].uploaded, "resolve_nprobe", None)
        if resolve is None:
            return None
        try:
            nprobe = max(1, int(resolve() * pf))
        except Exception:
            return None
        for e in entries:
            e.nprobe_applied = nprobe
        return nprobe

    def _observe_queue_wait(self, entries: list[_Entry]) -> None:
        """EWMA the worst enqueue-to-dispatch wait of the group — the
        admission controller's primary pressure signal."""
        now = time.monotonic()
        wait_ms = max(now - e.t_q for e in entries) * 1000.0
        with self._flight_cv:
            self._queue_wait_ewma_ms = (
                WAIT_EWMA_ALPHA * wait_ms
                + (1.0 - WAIT_EWMA_ALPHA) * self._queue_wait_ewma_ms
            )
            self._last_wait_obs = now
            _metrics.gauge("serving.batcher.queue.wait-ewma-ms").set(
                self._queue_wait_ewma_ms
            )

    def queue_wait_ewma_ms(self) -> float:
        """The queue-wait EWMA with idle decay: while no dispatch happens
        (the queue went quiet) the signal halves every
        ``WAIT_DECAY_HALF_LIFE_S``, so the shed ladder can release though
        nothing flows to refresh the EWMA."""
        now = time.monotonic()
        with self._flight_cv:
            idle = now - self._last_wait_obs
            ewma = self._queue_wait_ewma_ms
        if idle <= WAIT_DECAY_GRACE_S:
            return ewma
        return ewma * 0.5 ** ((idle - WAIT_DECAY_GRACE_S) / WAIT_DECAY_HALF_LIFE_S)

    def _submit_group(self, entries: list[_Entry], cosine: bool) -> None:
        self._acquire_slot()
        # queue-wait ends here: the entries have a dispatcher AND an
        # inflight slot (waiting for a slot is backpressure, still queueing)
        self._observe_queue_wait(entries)
        for e in entries:
            if e.trace_ctx is not None:
                e.t_dispatch = time.time()
        try:
            nprobe = self._group_nprobe(entries)
            kk = _k_bucket(max(e.k for e in entries))
            if entries[0].row is not None:
                rows = np.asarray([e.row for e in entries], dtype=np.int32)
                pad = _b_bucket(len(rows)) - len(rows)
                if pad:  # bucketed shapes: row 0 repeats, results discarded
                    rows = np.concatenate([rows, np.zeros(pad, np.int32)])
                handle = topn_ops.submit_top_k_multi_indexed(
                    entries[0].uploaded, entries[0].x_dev, rows, kk,
                    cosine=cosine, scan_batch=self.MULTI_THRESHOLD, nprobe=nprobe,
                )
                _metrics.counter("serving.batcher.submitted.indexed").inc(len(entries))
            else:
                queries = np.stack([e.query for e in entries])
                # tiered item store: hint the cells this group will probe so
                # the store's disk->RAM promotions overlap the dispatch below
                # instead of stalling the stage-1 gather (advisory; no-op on
                # flat-plane indexes)
                prefetch = getattr(entries[0].uploaded, "prefetch_for_queries", None)
                if prefetch is not None:
                    try:
                        prefetch(queries, nprobe=nprobe, cosine=cosine)
                    except Exception:  # never let a hint fail a dispatch
                        pass
                if len(entries) > self.MULTI_THRESHOLD:
                    # multi-scan: pads to a multiple of scan_batch internally
                    handle = topn_ops.submit_top_k_multi(
                        entries[0].uploaded, queries, kk,
                        cosine=cosine, scan_batch=self.MULTI_THRESHOLD, nprobe=nprobe,
                    )
                else:
                    pad_rows = _b_bucket(len(entries)) - len(entries)
                    if pad_rows:
                        queries = np.concatenate(
                            [queries, np.zeros((pad_rows, queries.shape[1]), queries.dtype)]
                        )
                    handle = topn_ops.submit_top_k(
                        entries[0].uploaded, queries, kk, cosine=cosine, nprobe=nprobe
                    )
                _metrics.counter("serving.batcher.submitted.vector").inc(len(entries))
            for e in entries:
                if e.trace_ctx is not None:
                    e.t_submit = time.time()
            self._pending.put((handle, entries, time.perf_counter()))
        except BaseException as exc:  # deliver the failure to the waiters
            self._release_slot()
            for e in entries:
                e.error = exc
                e.done.set()

    # -- completer -----------------------------------------------------------

    def _complete_loop(self) -> None:
        while True:
            item = self._pending.get()
            if item is None:
                return
            handle, entries, t_submit = item
            latency = None
            try:
                idx, vals = handle.result()
                latency = time.perf_counter() - t_submit
                for row, e in enumerate(entries):
                    e.idx = idx[row, : e.k]
                    e.vals = vals[row, : e.k]
            except BaseException as exc:
                for e in entries:
                    e.error = exc
            finally:
                self._release_slot(latency)
                t_done = time.time()
                for e in entries:
                    if e.trace_ctx is not None:
                        _record_entry_spans(e, t_done)
                    e.done.set()

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._dispatcher.join(timeout=5)
        self._completer.join(timeout=5)


_default_lock = threading.Lock()
_default: TopNBatcher | None = None
_default_init: dict = {}
_default_refs = 0
_atexit_registered = False


def configure_scheduler(
    max_batch: int | None = None,
    max_inflight: int | None = None,
    latency_budget_ms: float | None = None,
    max_queue: int | None = None,
) -> None:
    """Pin the process-wide batcher's scheduler knobs (the serving layer
    maps ``oryx.serving.scan.*`` / ``oryx.serving.overload.max-queue``
    here at startup, before the default batcher spins up). ``None`` leaves
    a knob adaptive (for ``max_queue``: unbounded)."""
    global LATENCY_BUDGET_MS
    with _default_lock:
        _default_init["max_batch"] = max_batch
        _default_init["max_inflight"] = max_inflight
        _default_init["max_queue"] = max_queue
        if latency_budget_ms is not None:
            LATENCY_BUDGET_MS = float(latency_budget_ms)


def default_batcher_signals() -> tuple[float, int]:
    """(queue_wait_ewma_ms, queue_depth) of the live default batcher, or
    zeros when none is running — the admission controller polls this on
    its control interval, so it must stay cheap and must never create a
    batcher."""
    with _default_lock:
        b = _default
    if b is None or b._closed:
        return 0.0, 0
    return b.queue_wait_ewma_ms(), b._queue.qsize()


def get_default_batcher() -> TopNBatcher:
    """Process-wide batcher shared by all serving models, created lazily
    (and again after a close); an atexit hook closes whatever default is
    live at interpreter shutdown."""
    global _default, _atexit_registered
    with _default_lock:
        if _default is None or _default._closed:
            _default = TopNBatcher(**_default_init)
            if not _atexit_registered:
                import atexit

                atexit.register(close_default_batcher)
                _atexit_registered = True
        return _default


def score_indexed_default(
    uploaded, x_dev, row: int, k: int, cosine: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """``score_default`` for index-submitted entries."""
    for attempt in range(4):
        try:
            return get_default_batcher().score_indexed(uploaded, x_dev, row, k, cosine=cosine)
        except BatcherClosedError:
            if attempt == 3:
                raise
    raise AssertionError("unreachable")


def score_default(
    uploaded, query: np.ndarray, k: int, cosine: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """``get_default_batcher().score(...)`` retried across close races
    (only :class:`BatcherClosedError` is retried)."""
    for attempt in range(4):
        try:
            return get_default_batcher().score(uploaded, query, k, cosine=cosine)
        except BatcherClosedError:
            if attempt == 3:
                raise
    raise AssertionError("unreachable")


def retain_default_batcher() -> None:
    """Register a user of the process-wide batcher (serving-layer start)."""
    global _default_refs
    with _default_lock:
        _default_refs += 1


def release_default_batcher() -> None:
    """Drop a reference; the batcher closes when the last serving layer
    in the process releases it."""
    global _default, _default_refs
    with _default_lock:
        _default_refs = max(0, _default_refs - 1)
        if _default_refs > 0:
            return
        batcher, _default = _default, None
    if batcher is not None:
        batcher.close()


def close_default_batcher() -> None:
    """Unconditionally shut down the process-wide batcher."""
    global _default, _default_refs
    with _default_lock:
        batcher, _default = _default, None
        _default_refs = 0
    if batcher is not None:
        batcher.close()
