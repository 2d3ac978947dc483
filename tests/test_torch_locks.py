"""The port's lock-order watchdog (``oryx_tpu_torch/common/locks.py``)
against the JAX package's (``oryx_tpu/common/locks.py``).

Each scenario of the JAX package's tests/analysis/test_locks.py (the
AB/BA cycle, RLock re-entry, ``Condition.wait``, the acquire timeout,
held-too-long) runs once under each watchdog; the exceptions raised and
the kinds of violation recorded must be equal. Then what the port does
on purpose that the JAX package does not: it takes its raw locks from
``_thread``, keys a lock by its package-qualified path, and arms on top
of the JAX package's watchdog (as the shared test fixtures plus the
port's own do) and unwinds back to the raw factories.
"""

from __future__ import annotations

import _thread
import threading
import time

import pytest

from oryx_tpu.common import locks as ref_locks
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.common import locks as port_locks

RAW_LOCK, RAW_RLOCK = threading.Lock, threading.RLock  # as imported, nothing armed
BOTH = pytest.mark.parametrize("locks", [ref_locks, port_locks], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)


@pytest.fixture()
def armed():
    """arm(locks, **kw) instruments one package's watchdog for the test,
    torn down whatever happens."""
    used = []

    def arm(locks, **kw):
        kw.setdefault("strict", True)
        kw.setdefault("acquire_timeout", 5.0)
        locks.instrument(**kw)
        used.append(locks)

    yield arm
    for locks in reversed(used):
        locks.deinstrument()
        locks.reset()
    assert threading.Lock is RAW_LOCK is _thread.allocate_lock
    assert threading.RLock is RAW_RLOCK


def _kinds(violations: list[str]) -> list[str]:
    kinds = set()
    for v in violations:
        for kind in ("lock-order cycle", "acquire-timeout", "held-too-long"):
            if v.startswith(kind):
                kinds.add(kind)
    return sorted(kinds)


def _ab_ba(locks) -> list[str]:
    a = threading.Lock()
    b = threading.Lock()  # a line of its own: a lock's node is its line
    assert isinstance(a, locks.OrderedLock)
    with a:
        with b:
            pass
    raised = []
    t0 = time.monotonic()
    try:
        with b:
            with a:  # reverse order: refused before blocking
                pass
    except locks.LockOrderViolation as e:
        raised.append(type(e).__name__)
    assert time.monotonic() - t0 < 1.0  # detected, not timed out
    assert not a.locked() and not b.locked()
    return raised


def _cross_thread_ab_ba(locks) -> list[str]:
    a = threading.Lock()
    b = threading.Lock()  # a line of its own: a lock's node is its line

    def order_ab():
        with a:
            with b:
                pass

    t = threading.Thread(target=order_ab)
    t.start()
    t.join(timeout=5)
    assert not t.is_alive()
    raised = []
    try:
        with b:
            with a:
                pass
    except locks.LockOrderViolation as e:
        raised.append(type(e).__name__)
    return raised


def _rlock_reentry(locks) -> list[str]:
    rl = threading.RLock()
    assert isinstance(rl, locks.OrderedRLock)
    with rl:
        with rl:  # reentrant: no edges, no violation
            assert rl._is_owned()
    assert not rl._is_owned()
    return []


def _condition_wait(locks) -> list[str]:
    cv = threading.Condition()  # allocates the patched RLock inside
    state = []

    def producer():
        with cv:
            state.append("ready")
            cv.notify()

    with cv:
        t = threading.Thread(target=producer)
        t.start()
        assert cv.wait_for(lambda: state, timeout=5)
    t.join(timeout=5)
    assert state == ["ready"] and not t.is_alive()
    return []


def _acquire_timeout(locks) -> list[str]:
    lk = threading.Lock()
    lk.acquire()
    raised = []
    try:

        def contender():
            try:
                lk.acquire()
            except locks.LockWatchdogTimeout as e:
                raised.append(type(e).__name__)

        t = threading.Thread(target=contender)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()
    finally:
        lk.release()
    return raised


def _held_too_long(locks) -> list[str]:
    lk = threading.Lock()
    with lk:
        time.sleep(0.05)
    return []


# scenario -> (its instrument() settings, the raised types, the violation kinds)
SCENARIOS = {
    "ab_ba_cycle": (_ab_ba, {}, ["LockOrderViolation"], ["lock-order cycle"]),
    "cross_thread_ab_ba": (_cross_thread_ab_ba, {}, ["LockOrderViolation"],
                           ["lock-order cycle"]),
    "rlock_reentry": (_rlock_reentry, {}, [], []),
    "condition_wait": (_condition_wait, {}, [], []),
    "acquire_timeout": (_acquire_timeout, {"acquire_timeout": 0.3},
                        ["LockWatchdogTimeout"], ["acquire-timeout"]),
    "held_too_long": (_held_too_long, {"hold_warn": 0.01}, [], ["held-too-long"]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_jax_packages_watchdog(armed, name):
    """The same scenario under each watchdog: the same exceptions raised
    and the same kinds of violation recorded, as the scenario expects."""
    run, settings, want_raised, want_kinds = SCENARIOS[name]
    outcomes = {}
    for locks in (ref_locks, port_locks):
        armed(locks, **settings)
        raised = run(locks)
        outcomes[locks.__name__] = (raised, _kinds(locks.violations()))
        locks.deinstrument()
        locks.reset()
    assert outcomes[port_locks.__name__] == outcomes[ref_locks.__name__], outcomes
    assert outcomes[port_locks.__name__] == (want_raised, want_kinds)


@BOTH
def test_non_blocking_acquire_records_no_edges(armed, locks):
    armed(locks)
    a = threading.Lock()
    b = threading.Lock()  # a line of its own: a lock's node is its line
    with a:
        assert b.acquire(blocking=False)
        b.release()
    with b:
        with a:  # would be a cycle if try-locks recorded edges
            pass
    assert locks.violations() == []


@BOTH
def test_non_strict_records_but_does_not_raise(armed, locks):
    armed(locks, strict=False)
    a = threading.Lock()
    b = threading.Lock()  # a line of its own: a lock's node is its line
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert _kinds(locks.violations()) == ["lock-order cycle"]
    locks.reset()
    assert locks.violations() == [] and locks.order_edges() == {}


def test_raw_locks_come_from_thread():
    assert port_locks._real_lock is _thread.allocate_lock
    assert port_locks._real_rlock is _thread.RLock
    assert not port_locks.instrumented()


def test_site_keys_are_package_qualified(armed):
    """A lock made in a package module is keyed by its path from the top
    package; one made in a file outside any package by the last two parts
    of its path, as the JAX package keys every lock."""
    from oryx_tpu.common.metrics import Counter as RefCounter
    from oryx_tpu_torch.common.metrics import Counter

    armed(port_locks)
    counter = Counter()
    assert counter._lock._key.startswith("oryx_tpu_torch/common/metrics.py:")
    # the JAX package's copy of the module, made in the same process (as
    # the fleet tests do), is a node of its own
    ref_key = RefCounter()._lock._key
    assert ref_key.startswith("oryx_tpu/common/metrics.py:")
    here = threading.Lock()
    assert here._key.startswith("tests/test_torch_locks.py:")
    assert port_locks._qualified_path("<string>") == "<string>"


def test_both_watchdogs_armed_at_once(armed):
    """The JAX package's watchdog armed first (the shared test fixture),
    the port's on top: a lock made then is the port's and is tracked by
    the port's graph only; the two unwind in order, back to the raw
    factories."""
    armed(ref_locks)
    armed(port_locks)
    a = threading.Lock()
    b = threading.Lock()  # a line of its own: a lock's node is its line
    assert isinstance(a, port_locks.OrderedLock)
    assert isinstance(a._lk, type(_thread.allocate_lock()))
    with a:
        with b:
            pass
    assert {a._key: {b._key}} == port_locks.order_edges()
    assert ref_locks.order_edges() == {}
    port_locks.deinstrument()
    assert threading.Lock is ref_locks.OrderedLock
    assert isinstance(threading.Lock(), ref_locks.OrderedLock)
    ref_locks.deinstrument()
    assert threading.Lock is _thread.allocate_lock
    assert threading.RLock is RAW_RLOCK


def test_deinstrument_leaves_a_later_watchdog_in_place(armed):
    """Torn down out of order, the port's watchdog does not put its
    factories back over the JAX package's."""
    armed(port_locks)
    armed(ref_locks)
    port_locks.deinstrument()
    assert threading.Lock is ref_locks.OrderedLock


def test_deinstrument_restores_plain_locks(armed):
    armed(port_locks)
    wrapped = threading.Lock()
    port_locks.deinstrument()
    raw = threading.Lock()
    assert not isinstance(raw, port_locks.OrderedLock)
    with wrapped:  # a surviving wrapper degrades to passthrough delegation
        assert wrapped.locked()
    assert port_locks.violations() == []


def test_wrappers_reinit_after_fork(armed):
    """``os.register_at_fork`` hooks call ``_at_fork_reinit`` on module
    locks; both wrappers take a fresh raw lock."""
    armed(port_locks)
    lk, rl = threading.Lock(), threading.RLock()
    lk.acquire()
    rl.acquire()
    lk._at_fork_reinit()
    rl._at_fork_reinit()
    assert not lk.locked() and not rl._is_owned()
    assert lk.acquire(blocking=False) and rl.acquire(blocking=False)
    lk.release()
    rl.release()
