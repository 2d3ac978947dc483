"""Run-time lock instrumentation: OrderedLock and its watchdogs
(counterpart of ``oryx_tpu/common/locks.py``).

The static lock-order pass (oryx_tpu_torch/analysis/lockorder.py) proves
the *declared* nesting graph acyclic; this module checks the *executed*
one. ``instrument()`` swaps ``threading.Lock`` / ``threading.RLock`` for
thin wrappers that maintain a process-wide lock-acquisition order graph
keyed by construction site (every ``self._lock = threading.Lock()`` in a
class maps to one node, however many instances exist). On each blocking
acquire the wrapper records held-lock -> acquired-lock edges and refuses
edge insertions that would close a cycle — the AB/BA deadlock is
reported as a raised :class:`LockOrderViolation` in the acquiring
thread *before* it blocks, so tests detect the bug without hanging.

Two watchdogs ride along:

- acquire-timeout: an indefinite blocking acquire is sliced into timed
  acquires; exceeding the budget raises :class:`LockWatchdogTimeout`
  (turning a silent deadlock/hang into a test failure with a message);
- held-too-long: release() checks wall time since acquire and records a
  violation when a lock was held longer than the configured budget.

Design constraints, in order: (1) the wrappers must be perfect drop-ins
— once ``threading.Lock`` is patched, stdlib ``queue.Queue`` and
``threading.Condition`` construct them too, so the full Lock protocol
(including the ``_is_owned``/``_release_save``/``_acquire_restore``
hooks Condition probes for) is provided; (2) near-zero overhead — the
fast path is one threading.local lookup and a dict membership test per
acquire; (3) zero imports from the rest of the package —
metrics/tracing themselves allocate locks, and instrumenting the
instrumenter must not recurse.

Two things differ from the JAX package's module, both so that its
watchdog and this one can be armed in one process (the shared test
fixtures arm the JAX package's around the port's fleet tests too):

- the raw locks come from ``_thread`` (``allocate_lock``, ``RLock``),
  not from ``threading.Lock`` as it stands at import, which is the
  other watchdog's wrapper while that one is armed; ``deinstrument()``
  puts back exactly the factories ``instrument()`` replaced, so two
  watchdogs unwind in the order they were armed;
- a lock's site key is its package-qualified path
  (``oryx_tpu_torch/serving/layer.py:42``), not the last two parts of
  it: the two packages share their layout, and keys by the last two
  parts would merge their nodes into one graph and could report a
  cycle neither package has.

Locks created *before* ``instrument()`` (module singletons bound at
import) keep their raw type and stay untracked; coverage targets the
per-test object graph, which is where the lambda layers' concurrency
lives. ``deinstrument()`` restores the factories; surviving wrappers
degrade to plain delegation once inactive.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
import time

# the raw C factories, whatever threading.Lock is bound to at import
_real_lock = _thread.allocate_lock
_real_rlock = _thread.RLock

_SLICE_S = 0.1  # granularity of the sliced indefinite acquire


class LockOrderViolation(RuntimeError):
    """Acquiring this lock here would close a lock-order cycle."""


class LockWatchdogTimeout(RuntimeError):
    """A blocking acquire exceeded the watchdog budget."""


class _Config:
    __slots__ = ("strict", "acquire_timeout", "hold_warn")

    def __init__(self, strict, acquire_timeout, hold_warn):
        self.strict = strict
        self.acquire_timeout = acquire_timeout
        self.hold_warn = hold_warn


_cfg: _Config | None = None
_graph_mu = _real_lock()
_edges: dict[str, set[str]] = {}
_violations: list[str] = []
_tls = threading.local()
# (threading.Lock, threading.RLock) as instrument() found them
_replaced: tuple | None = None
_site_prefix: dict[str, str] = {}  # co_filename -> its package-qualified path


def _active() -> bool:
    return _cfg is not None


def _site_key() -> str:
    """Identify a lock by its construction site (file:line), so all
    instances of a class share one graph node."""
    frame = sys._getframe(1)
    here = __name__
    while frame is not None and frame.f_globals.get("__name__") == here:
        frame = frame.f_back
    if frame is None:  # pragma: no cover - interpreter internals
        return "<unknown>"
    fn = frame.f_code.co_filename
    short = _site_prefix.get(fn)
    if short is None:
        short = _site_prefix[fn] = _qualified_path(fn)
    return f"{short}:{frame.f_lineno}"


def _qualified_path(filename: str) -> str:
    """``pkg/sub/mod.py`` for a module of a package (every directory up to
    the top package holds an ``__init__.py``); the last two parts of the
    path for any other file."""
    if os.path.isfile(filename):
        head, name = os.path.split(os.path.abspath(filename))
        parts = [name]
        while os.path.isfile(os.path.join(head, "__init__.py")):
            head, pkg = os.path.split(head)
            parts.append(pkg)
        if len(parts) > 1:
            return "/".join(reversed(parts))
    parts = filename.replace(os.sep, "/").rsplit("/", 2)
    return "/".join(parts[-2:]) if len(parts) >= 2 else filename


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _find_path(src: str, dst: str) -> list[str] | None:
    """Path src -> ... -> dst in the order graph, or None. Caller holds
    _graph_mu."""
    seen = {src}
    trail = {src: None}
    work = [src]
    while work:
        cur = work.pop()
        if cur == dst:
            path = []
            while cur is not None:
                path.append(cur)
                cur = trail[cur]
            return path[::-1]
        for nxt in _edges.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                trail[nxt] = cur
                work.append(nxt)
    return None


def _note_acquire(key: str) -> None:
    """Record held -> key edges; detect (and in strict mode refuse) a
    cycle-closing edge before the caller blocks on the lock."""
    st = _stack()
    if not st:
        return
    boom = None
    for held_key, _t0 in st:
        if held_key == key or key in _edges.get(held_key, ()):
            continue
        with _graph_mu:
            bucket = _edges.setdefault(held_key, set())
            if key in bucket:
                continue
            path = _find_path(key, held_key)
            bucket.add(key)
            if path is not None:
                msg = (
                    f"lock-order cycle: acquiring {key} while holding "
                    f"{held_key}, but the reverse order "
                    f"{' -> '.join(path)} was already observed"
                )
                _violations.append(msg)
                boom = msg
    if boom is not None and _cfg is not None and _cfg.strict:
        raise LockOrderViolation(boom)


def _push(key: str) -> None:
    cfg = _cfg
    # the timestamp only feeds held-too-long; skip the clock read (the
    # costliest part of an uncontended acquire) when that check is off
    t0 = time.monotonic() if cfg is not None and cfg.hold_warn is not None else 0.0
    _stack().append((key, t0))


def _pop(key: str) -> None:
    st = getattr(_tls, "stack", None)
    if not st:
        return
    for i in range(len(st) - 1, -1, -1):
        if st[i][0] == key:
            _, t0 = st.pop(i)
            cfg = _cfg
            if cfg is not None and cfg.hold_warn is not None:
                held = time.monotonic() - t0
                if held > cfg.hold_warn:
                    _violations.append(
                        f"held-too-long: {key} held {held:.3f}s "
                        f"(budget {cfg.hold_warn}s)"
                    )
            return


def _acquire_sliced(raw, key: str, timeout_budget: float) -> bool:
    """Indefinite blocking acquire as timed slices so a deadlock turns
    into a diagnosable failure instead of a hung suite."""
    deadline = time.monotonic() + timeout_budget
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            msg = (
                f"acquire-timeout: {key} not acquired within "
                f"{timeout_budget}s (likely deadlock or a lock leak)"
            )
            _violations.append(msg)
            raise LockWatchdogTimeout(msg)
        if raw.acquire(True, min(_SLICE_S, remaining)):
            return True


class OrderedLock:
    """Drop-in ``threading.Lock`` tracked by the order graph."""

    __slots__ = ("_lk", "_key")

    def __init__(self, name: str | None = None):
        self._lk = _real_lock()
        self._key = name or _site_key()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _active():
            return self._lk.acquire(blocking, timeout)
        if not blocking:
            # a non-blocking attempt cannot deadlock: no edges recorded
            ok = self._lk.acquire(False)
        else:
            _note_acquire(self._key)
            cfg = _cfg
            if timeout is not None and timeout >= 0:
                ok = self._lk.acquire(True, timeout)
            elif cfg is not None and cfg.acquire_timeout is not None:
                # uncontended fast path: a try-lock avoids the sliced
                # acquire's deadline arithmetic entirely
                ok = self._lk.acquire(False) or _acquire_sliced(
                    self._lk, self._key, cfg.acquire_timeout
                )
            else:
                ok = self._lk.acquire(True)
        if ok:
            _push(self._key)
        return ok

    def release(self) -> None:
        if _active():
            _pop(self._key)
        self._lk.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition() probes for this; answering from the raw lock keeps the
    # probe out of the order graph (it is non-blocking by construction).
    def _is_owned(self) -> bool:
        if self._lk.acquire(False):
            self._lk.release()
            return False
        return True

    # stdlib modules register module-level locks with os.register_at_fork
    # (e.g. concurrent.futures.thread); without this they fail to import
    # while the watchdog is installed
    def _at_fork_reinit(self) -> None:
        self._lk = _real_lock()

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<OrderedLock {self._key} locked={self._lk.locked()}>"


class OrderedRLock:
    """Drop-in ``threading.RLock`` tracked by the order graph.

    Ownership/recursion are tracked wrapper-side so only the outermost
    acquire/release touch the graph, and so ``Condition.wait`` can fully
    release a reentrantly-held lock via ``_release_save``.
    """

    __slots__ = ("_lk", "_key", "_owner", "_count")

    def __init__(self, name: str | None = None):
        self._lk = _real_rlock()
        self._key = name or _site_key()
        self._owner = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:  # reentrant: no edges, no stack traffic
            ok = self._lk.acquire(blocking, timeout)
            if ok:
                self._count += 1
            return ok
        if not _active():
            ok = self._lk.acquire(blocking, timeout)
        elif not blocking:
            ok = self._lk.acquire(False)
        else:
            _note_acquire(self._key)
            cfg = _cfg
            if timeout is not None and timeout >= 0:
                ok = self._lk.acquire(True, timeout)
            elif cfg is not None and cfg.acquire_timeout is not None:
                ok = self._lk.acquire(False) or _acquire_sliced(
                    self._lk, self._key, cfg.acquire_timeout
                )
            else:
                ok = self._lk.acquire(True)
        if ok:
            self._owner = me
            self._count = 1
            if _active():
                _push(self._key)
        return ok

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise RuntimeError("cannot release un-acquired lock")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            if _active():
                _pop(self._key)
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # --- Condition integration -------------------------------------
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        count, owner = self._count, self._owner
        self._count = 0
        self._owner = None
        if _active():
            _pop(self._key)
        for _ in range(count):
            self._lk.release()
        return (count, owner)

    def _acquire_restore(self, state) -> None:
        count, owner = state
        if _active():
            _note_acquire(self._key)
        for _ in range(count):
            self._lk.acquire()
        self._count = count
        self._owner = owner
        if _active():
            _push(self._key)

    def _at_fork_reinit(self) -> None:
        self._lk = _real_rlock()
        self._owner = None
        self._count = 0

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<OrderedRLock {self._key} count={self._count}>"


def instrument(
    strict: bool = True,
    acquire_timeout: float | None = 30.0,
    hold_warn: float | None = None,
) -> None:
    """Activate the watchdog: new ``threading.Lock()``/``RLock()`` calls
    return tracked wrappers. ``strict`` raises on cycle-closing edges;
    otherwise they are only recorded (see :func:`violations`)."""
    global _cfg, _replaced
    _cfg = _Config(strict, acquire_timeout, hold_warn)
    if threading.Lock is not OrderedLock:
        _replaced = (threading.Lock, threading.RLock)
    threading.Lock = OrderedLock
    threading.RLock = OrderedRLock


def deinstrument() -> None:
    """Put back the factories ``instrument()`` replaced (the raw ones, or
    another watchdog's armed before this one), unless something has
    replaced this module's since. Surviving wrappers become passthrough
    (``_active()`` gates every bookkeeping path)."""
    global _cfg, _replaced
    if _replaced is not None and threading.Lock is OrderedLock:
        threading.Lock, threading.RLock = _replaced
    _replaced = None
    _cfg = None


def reset() -> None:
    """Drop the accumulated order graph and violation log."""
    with _graph_mu:
        _edges.clear()
        _violations.clear()


def violations() -> list[str]:
    """Violations recorded since the last reset (cycles, held-too-long,
    acquire-timeouts) — strict-mode raises are also recorded here."""
    with _graph_mu:
        return list(_violations)


def order_edges() -> dict[str, set[str]]:
    """Snapshot of the observed acquisition-order graph (for tests)."""
    with _graph_mu:
        return {k: set(v) for k, v in _edges.items()}


def instrumented() -> bool:
    return _active()
