"""In-process broker: the embedded test/single-process bus.

Analogue of the reference's embedded LocalKafkaBroker + LocalZKServer test
assets (framework/kafka-util/src/test, SURVEY.md §2.2) promoted to a
first-class implementation: topics with partitioned append-only in-memory
logs, blocking poll via condition variables, and per-group offset storage.

Port note: a copy of ``oryx_tpu/bus/inproc.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import threading

from oryx_tpu_torch.bus.core import (
    Broker,
    KeyMessage,
    TopicConsumer,
    TopicProducer,
    partition_for,
    resolve_partitions,
)


class _Topic:
    def __init__(self, name: str, partitions: int) -> None:
        self.name = name
        self.partitions: list[list[KeyMessage]] = [[] for _ in range(partitions)]


class InProcessBroker(Broker):
    _registry: dict[str, "InProcessBroker"] = {}
    _registry_lock = threading.Lock()

    @classmethod
    def named(cls, name: str) -> "InProcessBroker":
        with cls._registry_lock:
            if name not in cls._registry:
                cls._registry[name] = InProcessBroker(name)
            return cls._registry[name]

    @classmethod
    def reset_all(cls) -> None:
        """Drop all named brokers (test isolation)."""
        with cls._registry_lock:
            cls._registry.clear()

    def __init__(self, name: str) -> None:
        self.name = name
        self._cond = threading.Condition()
        self._topics: dict[str, _Topic] = {}
        self._offsets: dict[tuple[str, str], dict[int, int]] = {}

    # -- admin --------------------------------------------------------------

    def create_topic(self, topic: str, partitions: int = 1, config: dict | None = None) -> None:
        with self._cond:
            if topic not in self._topics:
                self._topics[topic] = _Topic(topic, max(1, partitions))

    def topic_exists(self, topic: str) -> bool:
        with self._cond:
            return topic in self._topics

    def delete_topic(self, topic: str) -> None:
        with self._cond:
            self._topics.pop(topic, None)
            for key in [k for k in self._offsets if k[1] == topic]:
                del self._offsets[key]
            self._cond.notify_all()

    # -- offsets ------------------------------------------------------------

    def get_offsets(self, group: str, topic: str) -> dict[int, int]:
        with self._cond:
            return dict(self._offsets.get((group, topic), {}))

    def set_offsets(self, group: str, topic: str, offsets: dict[int, int]) -> None:
        with self._cond:
            self._offsets.setdefault((group, topic), {}).update(offsets)

    def latest_offsets(self, topic: str) -> dict[int, int]:
        with self._cond:
            t = self._topics.get(topic)
            if t is None:
                return {}
            return {i: len(log) for i, log in enumerate(t.partitions)}

    # -- produce/consume ----------------------------------------------------

    def _get_or_create(self, topic: str) -> _Topic:
        """Caller must hold self._cond."""
        t = self._topics.get(topic)
        if t is None:
            t = _Topic(topic, 1)
            self._topics[topic] = t
        return t

    def _append(self, topic: str, key: str | None, message: str) -> None:
        with self._cond:
            t = self._get_or_create(topic)
            p = partition_for(key, len(t.partitions))
            t.partitions[p].append(KeyMessage(key, message))
            self._cond.notify_all()

    def _append_many(self, topic: str, records) -> int:
        """Batch append under one lock acquisition + one wakeup."""
        with self._cond:
            t = self._get_or_create(topic)
            nparts = len(t.partitions)
            n = 0
            for key, message in records:
                t.partitions[partition_for(key, nparts)].append(KeyMessage(key, message))
                n += 1
            self._cond.notify_all()
            return n

    def producer(self, topic: str) -> TopicProducer:
        return _InProcProducer(self, topic)

    def consumer(
        self, topic: str, group: str | None = None, from_beginning: bool = False,
        partitions: list[int] | None = None,
    ) -> TopicConsumer:
        return _InProcConsumer(self, topic, group, from_beginning, partitions)


class _InProcProducer(TopicProducer):
    def __init__(self, broker: InProcessBroker, topic: str) -> None:
        self._broker = broker
        self._topic = topic

    @property
    def update_broker(self) -> str:
        return f"inproc://{self._broker.name}"

    @property
    def topic(self) -> str:
        return self._topic

    def send(self, key: str | None, message: str) -> None:
        self._broker._append(self._topic, key, message)

    def send_many(self, records) -> int:
        return self._broker._append_many(self._topic, records)

    def close(self) -> None:
        pass


class _InProcConsumer(TopicConsumer):
    def __init__(
        self, broker: InProcessBroker, topic: str, group: str | None,
        from_beginning: bool, partitions: list[int] | None = None,
    ) -> None:
        self._broker = broker
        self._topic = topic
        self._group = group
        self._closed = False
        # None = dynamic assignment: follow the topic as it grows partitions
        self._assigned = partitions is not None
        with broker._cond:
            t = broker._topics.get(topic)
            nparts = len(t.partitions) if t else 1
            parts = resolve_partitions(nparts, partitions)
            stored = broker._offsets.get((group, topic)) if group else None
            if stored:
                self._pos = {i: stored.get(i, 0) for i in parts}
            elif from_beginning:
                self._pos = {i: 0 for i in parts}
            else:
                self._pos = {i: (len(t.partitions[i]) if t else 0) for i in parts}
        from oryx_tpu_torch.common import ledger

        ledger.register("consumer", self, live=lambda c: not c.closed())

    def poll(self, max_records: int = 1000, timeout: float = 0.1) -> list[KeyMessage]:
        out: list[KeyMessage] = []
        with self._broker._cond:
            deadline = None
            while True:
                if self._closed:
                    return out
                t = self._broker._topics.get(self._topic)
                if t is not None:
                    if not self._assigned:
                        # topic may have grown partitions since construction
                        for i in range(len(t.partitions)):
                            self._pos.setdefault(i, 0)
                    for i, log in enumerate(t.partitions):
                        if i not in self._pos:
                            continue
                        start = self._pos[i]
                        take = log[start : start + (max_records - len(out))]
                        if take:
                            out.extend(take)
                            self._pos[i] = start + len(take)
                        if len(out) >= max_records:
                            return out
                if out:
                    return out
                import time

                if deadline is None:
                    deadline = time.monotonic() + timeout
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return out
                self._broker._cond.wait(remaining)

    def positions(self) -> dict[int, int]:
        return dict(self._pos)

    def seek(self, positions: dict[int, int]) -> None:
        with self._broker._cond:
            for i, off in positions.items():
                self._pos[int(i)] = int(off)

    def commit(self) -> None:
        if self._group:
            self._broker.set_offsets(self._group, self._topic, self._pos)

    def close(self) -> None:
        with self._broker._cond:
            self._closed = True
            self._broker._cond.notify_all()

    def closed(self) -> bool:
        return self._closed
