"""Fault-injecting chaos bus: a Broker wrapper with seeded failure modes.

Streaming systems earn their recovery story by being tested against
broker flaps, dropped deliveries, duplicates, and slow consumers — and a
chaos test is only useful if it is *reproducible*. This module wraps any
inner broker behind a locator of the form

    fault+<inner locator>?drop=0.1&delay_ms=20&dup=0.01&fail_connect=2&seed=7

resolved by ``get_broker`` (oryx_tpu_torch/bus/core.py). All randomness comes
from one ``numpy`` generator seeded by ``seed`` (default 0), so the same
locator over the same traffic injects the same faults.

Fault model (delivery faults, never log corruption — the at-least-once
contract of the real brokers is preserved, which is what lets the chaos
e2e assert bit-identical convergence with a fault-free run):

- ``drop``  on produce: with this probability the produce call raises a
  transient ``ConnectionError`` *before anything is written* (a dropped
  request; the caller's RetryPolicy resends). On poll: the polled batch
  is "lost in flight" — the consumer is rewound via ``seek`` and the poll
  returns empty, so the records are redelivered later.
- ``dup``   on produce: the batch is written twice. On poll: the batch is
  delivered, then delivered once more on the next poll (redelivery).
- ``delay_ms`` — added latency on every produce and every non-empty poll.
- ``fail_connect=N`` — the first N producer()/consumer() openings raise
  ``ConnectionError`` (a broker that is slow to come up).
- programmatic outage: ``set_outage(locator, True)`` makes every
  produce/poll raise until cleared — the "broker down" lever the serving
  /readyz chaos test flips.

State (RNG stream, fault counters, outage flag) is shared per locator
across ``get_broker`` calls so a multi-layer pipeline in one process sees
one coherent fault schedule; ``reset()`` clears it (test isolation).

Port note: a copy of ``oryx_tpu/bus/faultbus.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable
from urllib.parse import parse_qsl

import numpy as np

from oryx_tpu_torch.bus.core import Broker, KeyMessage, TopicConsumer, TopicProducer, get_broker
from oryx_tpu_torch.common import metrics

__all__ = [
    "FaultBroker",
    "FaultState",
    "get_state",
    "reset",
    "schedule_phases",
    "set_levers",
    "set_outage",
]

_FAULT_KEYS = ("drop", "delay_ms", "dup", "fail_connect", "seed")

_states: dict[str, "FaultState"] = {}
_states_lock = threading.Lock()


class FaultState:
    """Shared fault schedule + counters for one fault locator."""

    def __init__(self, drop: float, delay: float, dup: float, fail_connect: int, seed: int) -> None:
        self.drop = drop
        self.delay = delay
        self.dup = dup
        self.lock = threading.Lock()
        self.rng = np.random.default_rng(seed)
        self.connects_left_to_fail = fail_connect
        self.outage = False
        # local counters mirrored into the metrics registry
        self.dropped_records = 0
        self.duplicated_records = 0
        self.injected_errors = 0
        self.rolls = 0  # fault-schedule consultations (proof chaos ran)
        # scenario scripting: timed lever phases applied lazily on the data
        # path (schedule_phases); empty = static levers from the locator
        self._phases: list[dict] = []
        self._phase_t0: float = 0.0
        self._phase_clock = time.monotonic
        self.phases_applied = 0

    # -- scenario scripting hooks -------------------------------------------

    def set_levers(
        self,
        drop: float | None = None,
        delay_ms: float | None = None,
        dup: float | None = None,
        outage: bool | None = None,
    ) -> None:
        """Reset fault levers mid-run (the scripted-scenario control
        surface; each None leaves that lever untouched)."""
        with self.lock:
            if drop is not None:
                self.drop = float(drop)
            if delay_ms is not None:
                self.delay = float(delay_ms) / 1000.0
            if dup is not None:
                self.dup = float(dup)
        if outage is not None:
            self.outage = bool(outage)

    def schedule_phases(self, phases: list[dict], clock=time.monotonic) -> None:
        """Arm a timed fault scenario: each phase is a dict with an ``at``
        offset in seconds (relative to this call) plus any of
        ``drop`` / ``delay_ms`` / ``dup`` / ``outage``. Phases are applied
        lazily as the data path consults the fault schedule, so no extra
        thread is needed and a quiet bus advances no phases. The fleet
        harness uses this to open and close a chaos window mid-run
        (tools/fleet.py scenario actions)."""
        with self.lock:
            self._phases = sorted((dict(p) for p in phases), key=lambda p: p.get("at", 0.0))
            self._phase_clock = clock
            self._phase_t0 = clock()

    def _tick(self) -> None:
        """Apply any scheduled phases that have come due."""
        if not self._phases:
            return
        due: list[dict] = []
        with self.lock:
            elapsed = self._phase_clock() - self._phase_t0
            while self._phases and self._phases[0].get("at", 0.0) <= elapsed:
                due.append(self._phases.pop(0))
        for p in due:
            self.set_levers(
                drop=p.get("drop"),
                delay_ms=p.get("delay_ms"),
                dup=p.get("dup"),
                outage=p.get("outage"),
            )
            self.phases_applied += 1
            metrics.registry.counter("bus.fault.phases-applied").inc()

    def roll(self) -> float:
        self._tick()
        with self.lock:
            self.rolls += 1
            return float(self.rng.random())

    def take_connect_failure(self) -> bool:
        with self.lock:
            if self.connects_left_to_fail > 0:
                self.connects_left_to_fail -= 1
                return True
            return False

    def check_outage(self, what: str) -> None:
        self._tick()
        if self.outage:
            self.injected_errors += 1
            metrics.registry.counter("bus.fault.injected-errors").inc()
            raise ConnectionError(f"injected broker outage ({what})")

    def maybe_delay(self) -> None:
        if self.delay > 0.0:
            time.sleep(self.delay)


def _split_locator(locator: str) -> tuple[str, dict[str, str], str]:
    """fault+inner?query -> (inner locator, fault params, canonical key).

    Query keys that are not fault params stay on the inner locator (so
    ``fault+tcp://h:p?connect_timeout=5&drop=0.1`` forwards the timeout).
    """
    if not locator.startswith("fault+"):
        raise ValueError(f"not a fault locator: {locator!r}")
    bare, _, query = locator[len("fault+") :].partition("?")
    params: dict[str, str] = {}
    passthrough: list[str] = []
    for k, v in parse_qsl(query, keep_blank_values=True):
        if k in _FAULT_KEYS:
            params[k] = v
        else:
            passthrough.append(f"{k}={v}")
    inner = bare + ("?" + "&".join(passthrough) if passthrough else "")
    # the canonical key identifies one fault schedule: the inner endpoint
    # plus the fault params; inner-only tuning knobs (e.g. a netbus
    # connect_timeout) don't fork the shared RNG/outage state
    canon = bare + "?" + "&".join(f"{k}={params[k]}" for k in _FAULT_KEYS if k in params)
    return inner, params, canon


def get_state(locator: str) -> "FaultState":
    """The shared FaultState for a fault locator (creates it if needed)."""
    _, params, canon = _split_locator(locator)
    with _states_lock:
        state = _states.get(canon)
        if state is None:
            state = FaultState(
                drop=float(params.get("drop", 0.0)),
                delay=float(params.get("delay_ms", 0.0)) / 1000.0,
                dup=float(params.get("dup", 0.0)),
                fail_connect=int(params.get("fail_connect", 0)),
                seed=int(params.get("seed", 0)),
            )
            _states[canon] = state
    return state


def set_outage(locator: str, down: bool) -> None:
    """Flip the injected-outage lever for a fault locator."""
    get_state(locator).outage = down


def set_levers(locator: str, **levers) -> None:
    """Reset fault levers (drop / delay_ms / dup / outage) for a locator
    mid-run — the programmatic scenario control surface."""
    get_state(locator).set_levers(**levers)


def schedule_phases(locator: str, phases: list[dict], clock=time.monotonic) -> None:
    """Arm a timed chaos scenario on a locator (see
    FaultState.schedule_phases for the phase dict format)."""
    get_state(locator).schedule_phases(phases, clock=clock)


def reset() -> None:
    """Forget all fault state (test isolation; conftest calls this)."""
    with _states_lock:
        _states.clear()


class FaultBroker(Broker):
    """Broker decorator injecting the faults described in the locator."""

    def __init__(self, inner: Broker, state: FaultState) -> None:
        self._inner = inner
        self._state = state

    @classmethod
    def from_locator(cls, locator: str) -> "FaultBroker":
        inner_loc, _, _ = _split_locator(locator)
        return cls(get_broker(inner_loc), get_state(locator))

    # -- admin ops pass through untouched (chaos targets the data path) ------

    def create_topic(self, topic: str, partitions: int = 1, config: dict | None = None) -> None:
        self._inner.create_topic(topic, partitions, config)

    def topic_exists(self, topic: str) -> bool:
        return self._inner.topic_exists(topic)

    def delete_topic(self, topic: str) -> None:
        self._inner.delete_topic(topic)

    def get_offsets(self, group: str, topic: str) -> dict[int, int]:
        return self._inner.get_offsets(group, topic)

    def set_offsets(self, group: str, topic: str, offsets: dict[int, int]) -> None:
        self._inner.set_offsets(group, topic, offsets)

    def latest_offsets(self, topic: str) -> dict[int, int]:
        return self._inner.latest_offsets(topic)

    # -- faulted data path ---------------------------------------------------

    def producer(self, topic: str) -> TopicProducer:
        if self._state.take_connect_failure():
            metrics.registry.counter("bus.fault.connect-failures").inc()
            raise ConnectionError("injected connect failure (producer)")
        return _FaultProducer(self._inner.producer(topic), self._state)

    def consumer(
        self, topic: str, group: str | None = None, from_beginning: bool = False,
        partitions: list[int] | None = None,
    ) -> TopicConsumer:
        if self._state.take_connect_failure():
            metrics.registry.counter("bus.fault.connect-failures").inc()
            raise ConnectionError("injected connect failure (consumer)")
        return _FaultConsumer(
            self._inner.consumer(topic, group, from_beginning, partitions), self._state
        )


class _FaultProducer(TopicProducer):
    def __init__(self, inner: TopicProducer, state: FaultState) -> None:
        self._inner = inner
        self._state = state

    @property
    def update_broker(self) -> str:
        return self._inner.update_broker

    @property
    def topic(self) -> str:
        return self._inner.topic

    def send(self, key: str | None, message: str) -> None:
        self.send_many([(key, message)])

    def send_many(self, records: Iterable[tuple[str | None, str]]) -> int:
        state = self._state
        state.check_outage("produce")
        records = list(records)
        if not records:
            return 0
        r = state.roll()
        if r < state.drop:
            # a dropped request: nothing reached the broker, caller retries
            state.injected_errors += 1
            metrics.registry.counter("bus.fault.injected-errors").inc()
            raise ConnectionError("injected transient produce failure")
        state.maybe_delay()
        n = self._inner.send_many(records)
        if state.dup > 0.0 and r < state.drop + state.dup:
            self._inner.send_many(records)
            state.duplicated_records += len(records)
            metrics.registry.counter("bus.fault.duplicated").inc(len(records))
        return n

    def send_interactions(self, users, items, values, **kwargs) -> int:
        """Typed columnar produce (block-framed transports): the same
        drop/delay/dup levers as send_many, rolled once per call — a
        dropped request never reaches the ring, a dup re-sends the whole
        column set."""
        send = getattr(self._inner, "send_interactions", None)
        if send is None:
            raise NotImplementedError(
                f"{type(self._inner).__name__} does not support send_interactions"
            )
        state = self._state
        state.check_outage("produce")
        n = len(values)
        if n == 0:
            return 0
        r = state.roll()
        if r < state.drop:
            state.injected_errors += 1
            metrics.registry.counter("bus.fault.injected-errors").inc()
            raise ConnectionError("injected transient produce failure")
        state.maybe_delay()
        sent = send(users, items, values, **kwargs)
        if state.dup > 0.0 and r < state.drop + state.dup:
            send(users, items, values, **kwargs)
            state.duplicated_records += n
            metrics.registry.counter("bus.fault.duplicated").inc(n)
        return sent

    def close(self) -> None:
        self._inner.close()


class _FaultConsumer(TopicConsumer):
    def __init__(self, inner: TopicConsumer, state: FaultState) -> None:
        self._inner = inner
        self._state = state
        self._redeliver_block = None
        self._redeliver_records: list[KeyMessage] | None = None

    def _fault_fetch(self, fetch, rewind_positions, size_of, stash_dup):
        """Shared drop/dup/delay logic for poll and poll_block. Returns the
        fetched batch, or None/empty when it was "lost in flight"."""
        state = self._state
        state.check_outage("poll")
        batch = fetch()
        if batch is None or (size_of(batch) == 0):
            return batch
        state.maybe_delay()
        r = state.roll()
        if r < state.drop:
            # lost delivery: rewind so the records come again later
            self._inner.seek(rewind_positions)
            state.dropped_records += size_of(batch)
            metrics.registry.counter("bus.fault.dropped").inc(size_of(batch))
            return None
        if state.dup > 0.0 and r < state.drop + state.dup:
            stash_dup(batch)
            state.duplicated_records += size_of(batch)
            metrics.registry.counter("bus.fault.duplicated").inc(size_of(batch))
        return batch

    def poll(self, max_records: int = 1000, timeout: float = 0.1) -> list[KeyMessage]:
        if self._redeliver_records is not None:
            out, self._redeliver_records = self._redeliver_records, None
            return out
        pre = self._inner.positions()

        def stash(batch):
            self._redeliver_records = list(batch)

        got = self._fault_fetch(
            lambda: self._inner.poll(max_records, timeout), pre, len, stash
        )
        return got or []

    def poll_block(self, max_records: int = 1000, timeout: float = 0.1):
        if self._redeliver_block is not None:
            out, self._redeliver_block = self._redeliver_block, None
            return out
        pre = self._inner.positions()

        def stash(batch):
            # block-framed transports hand out zero-copy views whose
            # lifetime ends at the next poll; a stashed duplicate must
            # outlive that, so copy it out of the transport buffer
            if hasattr(batch, "materialize"):
                batch = batch.materialize()
            self._redeliver_block = batch

        return self._fault_fetch(
            lambda: self._inner.poll_block(max_records, timeout), pre, len, stash
        )

    def pin(self) -> None:
        """Guard-freeze passthrough for block-framed transports (no-op on
        brokers without a guard)."""
        inner_pin = getattr(self._inner, "pin", None)
        if inner_pin is not None:
            inner_pin()

    def release(self) -> None:
        inner_release = getattr(self._inner, "release", None)
        if inner_release is not None:
            inner_release()

    def positions(self) -> dict[int, int]:
        return self._inner.positions()

    def seek(self, positions: dict[int, int]) -> None:
        self._inner.seek(positions)

    def commit(self) -> None:
        self._state.check_outage("commit")
        self._inner.commit()

    def close(self) -> None:
        self._inner.close()

    def closed(self) -> bool:
        return self._inner.closed()
