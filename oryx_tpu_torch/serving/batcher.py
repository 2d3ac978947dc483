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

The queue is bounded as in the JAX package
(``oryx.serving.overload.max-queue``): an entry past the bound raises
:class:`BatcherOverloadedError` at once and counts
``serving.batcher.queue.rejected``, and the serving layer answers 429.

Not ported yet: tenancy (the deficit-round-robin queue serves the single
default tenant, and no tenant's share of the bound is kept), the rest of
overload control (no admission ladder, no reduced-probe override of the
IVF tier's nprobe) and the tiered-store prefetch.
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

log = logging.getLogger(__name__)

# Adaptive-scheduler tuning (oryx.serving.scan.* maps onto these via the
# serving layer).
LATENCY_BUDGET_MS = float(os.environ.get("ORYX_BATCHER_LATENCY_BUDGET_MS", 50.0))
EWMA_ALPHA = 0.25  # completer's dispatch-latency smoothing
MIN_ADAPTIVE_BATCH = 256  # one full scan group
MAX_ADAPTIVE_BATCH = 4096
MIN_INFLIGHT = 2  # always enough to overlap host prep with card work
MAX_INFLIGHT = 32


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


def _k_bucket(k: int) -> int:
    return max(16, 1 << (int(k) - 1).bit_length())


def _b_bucket(n: int) -> int:
    """Batch-row bucket: coalesced batches pad to power-of-two row counts
    (zero queries), the JAX package's shapes."""
    return max(8, 1 << (int(n) - 1).bit_length())


def _record_entry_spans(e: _Entry, t_done: float) -> None:
    """One request's batching lifecycle as three sibling spans under the
    request span: queue-wait, assemble (grouping + submit), scan."""
    ctx = e.trace_ctx
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
        e.t_submit, t_done - e.t_submit,
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
            # group by (matrix snapshot, cosine, query-matrix snapshot):
            # indices are only meaningful against the snapshots the caller
            # captured, and vector entries never mix with index entries
            groups: dict[tuple, list[_Entry]] = {}
            for e in batch:
                xk = id(e.x_dev) if e.row is not None else None
                groups.setdefault((id(e.uploaded), e.cosine, xk), []).append(e)
            for (_, cosine, _xk), entries in groups.items():
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

    def _submit_group(self, entries: list[_Entry], cosine: bool) -> None:
        self._acquire_slot()
        for e in entries:
            if e.trace_ctx is not None:
                e.t_dispatch = time.time()
        try:
            kk = _k_bucket(max(e.k for e in entries))
            if entries[0].row is not None:
                rows = np.asarray([e.row for e in entries], dtype=np.int32)
                pad = _b_bucket(len(rows)) - len(rows)
                if pad:  # bucketed shapes: row 0 repeats, results discarded
                    rows = np.concatenate([rows, np.zeros(pad, np.int32)])
                handle = topn_ops.submit_top_k_multi_indexed(
                    entries[0].uploaded, entries[0].x_dev, rows, kk,
                    cosine=cosine, scan_batch=self.MULTI_THRESHOLD,
                )
                _metrics.counter("serving.batcher.submitted.indexed").inc(len(entries))
            else:
                queries = np.stack([e.query for e in entries])
                if len(entries) > self.MULTI_THRESHOLD:
                    # multi-scan: pads to a multiple of scan_batch internally
                    handle = topn_ops.submit_top_k_multi(
                        entries[0].uploaded, queries, kk,
                        cosine=cosine, scan_batch=self.MULTI_THRESHOLD,
                    )
                else:
                    pad_rows = _b_bucket(len(entries)) - len(entries)
                    if pad_rows:
                        queries = np.concatenate(
                            [queries, np.zeros((pad_rows, queries.shape[1]), queries.dtype)]
                        )
                    handle = topn_ops.submit_top_k(entries[0].uploaded, queries, kk, cosine=cosine)
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
