"""Bus abstractions and the broker registry/factory.

API surface mirrors the reference's messaging SPI (framework/oryx-api:
KeyMessage.java, TopicProducer.java) and admin utils (framework/kafka-util/
src/main/java/com/cloudera/oryx/kafka/util/KafkaUtils.java:42-190).

Port note: a copy of ``oryx_tpu/bus/core.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``; ``get_broker`` serves ``inproc://`` and
``file:`` buses (the others raise).
"""

from __future__ import annotations

import abc
import hashlib
from dataclasses import dataclass
from typing import Iterable, Iterator


@dataclass(frozen=True)
class KeyMessage:
    """A key/message pair (KeyMessage/KeyMessageImpl analogue)."""

    key: str | None
    message: str


class TopicProducer(abc.ABC):
    """Wraps access to one topic of a broker (TopicProducer.java)."""

    @property
    @abc.abstractmethod
    def update_broker(self) -> str: ...

    @property
    @abc.abstractmethod
    def topic(self) -> str: ...

    @abc.abstractmethod
    def send(self, key: str | None, message: str) -> None: ...

    def send_many(self, records: "Iterable[tuple[str | None, str]]") -> int:
        """Publish a batch of (key, message) pairs; returns the count sent.

        The batched analogue of the reference producer's async buffering
        (TopicProducerImpl.java:194-202 — linger 1s / batch 100 / gzip):
        brokers override this to amortize per-message costs (one lock +
        one buffered write per batch on the file bus) instead of paying
        them per record. The default just loops `send`.
        """
        n = 0
        for key, message in records:
            self.send(key, message)
            n += 1
        return n

    def send_message(self, message: str) -> None:
        self.send(None, message)

    @abc.abstractmethod
    def close(self) -> None: ...

    def __enter__(self) -> "TopicProducer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TopicConsumer(abc.ABC):
    """Iterates KeyMessage records from a topic.

    `poll(max_records, timeout)` returns possibly-empty batches;
    iteration blocks until `close()` (like a Kafka consumer stream).
    """

    @abc.abstractmethod
    def poll(self, max_records: int = 1000, timeout: float = 0.1) -> list[KeyMessage]: ...

    def poll_block(self, max_records: int = 1000, timeout: float = 0.1):
        """Columnar poll: one RecordBlock of byte-string arrays (None when
        nothing arrived). High-rate consumers (the speed layer at 100K+
        events/s) use this to skip per-record object construction; brokers
        override it to skip per-record decoding entirely.

        Trace control records (the reserved "@trc" key a traced producer
        prepends to its batch) are stripped here and surfaced as
        ``block.trace``; they still occupy a topic offset on both sides,
        so seek/commit arithmetic is untouched."""
        from oryx_tpu_torch.common.records import RecordBlock
        from oryx_tpu_torch.common.tracing import TRACE_KEY

        records = self.poll(max_records, timeout)
        if not records:
            return None
        trace = None
        if any(r.key == TRACE_KEY for r in records):
            kept = []
            for r in records:
                if r.key == TRACE_KEY:
                    trace = r.message
                else:
                    kept.append(r)
            records = kept
            if not records:
                return None
        block = RecordBlock.from_key_messages(records)
        block.trace = trace
        return block

    @abc.abstractmethod
    def positions(self) -> dict[int, int]:
        """Current partition -> next-offset map."""

    def seek(self, positions: dict[int, int]) -> None:
        """Move the read position of the given partitions (absolute
        offsets). The redelivery primitive: the fault bus rewinds a
        consumer to simulate a dropped delivery, and the net-bus client
        restores a reopened consumer after a reconnect. Optional —
        brokers that cannot seek raise."""
        raise NotImplementedError(f"{type(self).__name__} does not support seek")

    @abc.abstractmethod
    def commit(self) -> None:
        """Persist current positions to the group offset ledger."""

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def closed(self) -> bool: ...

    def __iter__(self) -> Iterator[KeyMessage]:
        while not self.closed():
            for rec in self.poll(timeout=0.2):
                yield rec

    def __enter__(self) -> "TopicConsumer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Broker(abc.ABC):
    """Topic admin + producer/consumer factory for one bus locator."""

    @abc.abstractmethod
    def create_topic(self, topic: str, partitions: int = 1, config: dict | None = None) -> None: ...

    @abc.abstractmethod
    def topic_exists(self, topic: str) -> bool: ...

    @abc.abstractmethod
    def delete_topic(self, topic: str) -> None: ...

    @abc.abstractmethod
    def producer(self, topic: str) -> TopicProducer: ...

    @abc.abstractmethod
    def consumer(
        self,
        topic: str,
        group: str | None = None,
        from_beginning: bool = False,
        partitions: list[int] | None = None,
    ) -> TopicConsumer:
        """A consumer. With `group` set and offsets stored, resumes from the
        stored offsets; `from_beginning=True` starts at offset 0 (the
        update-topic replay path, SpeedLayer.java:107-121); otherwise starts
        at the topic end (latest). `partitions` restricts the consumer to
        that subset of the topic's partitions (manual assignment, the
        sharded-pipeline primitive): positions()/commit() then cover ONLY
        the owned partitions, so concurrent owners of disjoint subsets
        never clobber each other's ledger entries (set_offsets merges
        per-partition). None = all partitions (group-free Kafka-style
        assignment of everything). Brokers that cannot restrict raise."""

    @abc.abstractmethod
    def get_offsets(self, group: str, topic: str) -> dict[int, int]: ...

    @abc.abstractmethod
    def set_offsets(self, group: str, topic: str, offsets: dict[int, int]) -> None: ...

    @abc.abstractmethod
    def latest_offsets(self, topic: str) -> dict[int, int]: ...


def resolve_partitions(nparts: int, partitions: list[int] | None) -> list[int]:
    """Normalize a consumer's partition-subset request against the topic's
    partition count: None = everything; otherwise a sorted, deduped subset
    that must be non-empty and in range (a silent clamp would quietly
    un-own data)."""
    if partitions is None:
        return list(range(nparts))
    parts = sorted({int(p) for p in partitions})
    if not parts:
        raise ValueError("partitions must be non-empty (or None for all)")
    if parts[0] < 0 or parts[-1] >= nparts:
        raise ValueError(
            f"partitions {parts} out of range for a {nparts}-partition topic"
        )
    return parts


def partition_for(key: str | None, num_partitions: int) -> int:
    if num_partitions <= 1:
        return 0
    if key is None:
        return 0
    h = hashlib.md5(key.encode("utf-8")).digest()
    return int.from_bytes(h[:4], "big") % num_partitions


# ---------------------------------------------------------------------------
# Broker factory
# ---------------------------------------------------------------------------


def get_broker(locator: str) -> Broker:
    """Resolve a bus locator to a Broker.

    inproc://<name> — process-local named broker (tests, single-process runs)
    file:/<dir> or file://<dir> or a bare path — file-backed broker
        (oryx_tpu_torch.bus.filebus; the same on-disk format as the JAX
        package's, so the two packages share a bus directory)

    The shm, tcp, kafka and fault buses of ``oryx_tpu.bus`` are not ported
    yet; their locators raise."""
    if locator.startswith("inproc://"):
        from oryx_tpu_torch.bus.inproc import InProcessBroker

        return InProcessBroker.named(locator[len("inproc://") :])
    if locator.startswith(("fault+", "tcp://", "kafka://", "shm:")):
        raise NotImplementedError(
            f"bus locator {locator!r} is not yet ported to oryx_tpu_torch "
            "(inproc:// and file: are)"
        )
    from oryx_tpu_torch.bus.filebus import FileBroker

    if locator.startswith("file:"):
        path = locator[len("file:") :]
        while path.startswith("//"):
            path = path[1:]
        return FileBroker(path)
    return FileBroker(locator)  # bare filesystem path


# -- KafkaUtils-style module-level admin helpers ----------------------------


def maybe_create_topic(locator: str, topic: str, partitions: int = 1, config: dict | None = None) -> None:
    get_broker(locator).create_topic(topic, partitions, config)


def topic_config_from(cfg, which: str) -> dict | None:
    """Per-topic broker settings from an oryx config block
    (`oryx.<which>-topic.*`): retention + segment sizing for brokers that
    support them (the file bus), max-size recorded for operators."""
    out = {}
    for key, conf_key in (
        ("max-size", f"oryx.{which}-topic.message.max-size"),
        ("retention-hours", f"oryx.{which}-topic.retention-hours"),
        ("segment-bytes", f"oryx.{which}-topic.segment-bytes"),
    ):
        v = cfg.get(conf_key, None)
        if v is not None:
            out[key] = v
    return out or None


def topic_exists(locator: str, topic: str) -> bool:
    return get_broker(locator).topic_exists(topic)


def delete_topic(locator: str, topic: str) -> None:
    broker = get_broker(locator)
    if broker.topic_exists(topic):
        broker.delete_topic(topic)


def get_offsets(locator: str, group: str, topic: str) -> dict[int, int]:
    return get_broker(locator).get_offsets(group, topic)


def set_offsets(locator: str, group: str, topic: str, offsets: dict[int, int]) -> None:
    get_broker(locator).set_offsets(group, topic, offsets)
