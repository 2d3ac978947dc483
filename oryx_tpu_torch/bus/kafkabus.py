"""Apache Kafka adapter behind the Broker SPI (optional extra).

The reference's transport (framework/kafka-util/src/main/java/com/
cloudera/oryx/kafka/util/KafkaUtils.java:57-152: topic admin via
AdminClient, offsets via consumer-group commits) mapped onto the
kafka-python client API. Imported lazily and only when a ``kafka://``
locator is used — the library is NOT bundled; environments without it
keep the file/tcp buses.

Semantics parity notes:
- keys/messages are UTF-8 strings on the wire (KeyMessage contract);
  a None key publishes a null Kafka key.
- consumer groups: ``group=None`` consumers get a throwaway group id and
  never commit; ``from_beginning=True`` maps to auto_offset_reset=
  "earliest" with no stored offsets (the update-topic replay path).
- get/set_offsets use the group-coordinator offset storage like
  KafkaUtils.setOffsets/fillInLatestOffsets.

Integration tests live behind the ``kafka`` pytest marker and need a
reachable broker (ORYX_KAFKA_BOOTSTRAP env var).

Requires kafka-python >= 1.4 (KafkaAdminClient); offset commit/read
adapts at runtime to both the pre-2.1 2-arg OffsetAndMetadata / raw-int
``committed()`` API and the 2.1+ 3-arg / struct-returning one.

Port note: a copy of ``oryx_tpu/bus/kafkabus.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import logging
import uuid
from typing import Iterable

from oryx_tpu_torch.bus.core import Broker, KeyMessage, TopicConsumer, TopicProducer

log = logging.getLogger(__name__)


def _require_kafka():
    try:
        import kafka  # noqa: F401 - availability probe

        return kafka
    except ImportError as e:  # pragma: no cover - exercised without the lib
        raise RuntimeError(
            "kafka:// locators need the kafka-python package; install it or "
            "use a file:/tcp: bus locator"
        ) from e


class _KafkaProducer(TopicProducer):
    def __init__(self, broker: "KafkaBroker", topic: str) -> None:
        kafka = _require_kafka()
        self._broker = broker
        self._topic = topic
        self._producer = kafka.KafkaProducer(
            bootstrap_servers=broker.bootstrap.split(","),
            linger_ms=1000,  # TopicProducerImpl.java:194-202 batching
            batch_size=1 << 16,
            compression_type="gzip",
            max_request_size=1 << 26,
        )

    @property
    def update_broker(self) -> str:
        return self._broker.locator()

    @property
    def topic(self) -> str:
        return self._topic

    def send(self, key: str | None, message: str) -> None:
        self._producer.send(
            self._topic,
            key=key.encode("utf-8") if key is not None else None,
            value=message.encode("utf-8"),
        )

    def send_many(self, records: Iterable[tuple[str | None, str]]) -> int:
        n = 0
        for key, message in records:
            self.send(key, message)
            n += 1
        self._producer.flush()
        return n

    def close(self) -> None:
        self._producer.flush()
        self._producer.close()


class _KafkaConsumer(TopicConsumer):
    def __init__(
        self,
        broker: "KafkaBroker",
        topic: str,
        group: str | None,
        from_beginning: bool,
    ) -> None:
        kafka = _require_kafka()
        self._topic = topic
        self._group = group
        self._closed = False
        self._consumer = kafka.KafkaConsumer(
            topic,
            bootstrap_servers=broker.bootstrap.split(","),
            group_id=group or f"oryx-anon-{uuid.uuid4().hex[:12]}",
            enable_auto_commit=False,
            auto_offset_reset="earliest" if from_beginning else "latest",
            consumer_timeout_ms=1 << 30,
        )
        if from_beginning and group is None:
            # replay-from-zero regardless of any stored position
            self._consumer.poll(timeout_ms=0)
            self._consumer.seek_to_beginning()

    def poll(self, max_records: int = 1000, timeout: float = 0.1) -> list[KeyMessage]:
        batches = self._consumer.poll(
            timeout_ms=int(timeout * 1000), max_records=max_records
        )
        out: list[KeyMessage] = []
        for recs in batches.values():
            for r in recs:
                key = r.key.decode("utf-8", "replace") if r.key is not None else None
                out.append(KeyMessage(key, r.value.decode("utf-8", "replace")))
        return out

    def positions(self) -> dict[int, int]:
        out = {}
        for tp in self._consumer.assignment():
            try:
                out[tp.partition] = self._consumer.position(tp)
            except Exception:  # noqa: BLE001 - unassigned mid-rebalance
                continue
        return out

    def commit(self) -> None:
        if self._group:
            self._consumer.commit()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._consumer.close()

    def closed(self) -> bool:
        return self._closed


class KafkaBroker(Broker):
    """Broker SPI over an Apache Kafka cluster (kafka://host:port[,...])."""

    def __init__(self, bootstrap: str) -> None:
        _require_kafka()
        self.bootstrap = bootstrap

    def locator(self) -> str:
        return f"kafka://{self.bootstrap}"

    def _admin(self):
        from kafka.admin import KafkaAdminClient

        return KafkaAdminClient(bootstrap_servers=self.bootstrap.split(","))

    def create_topic(self, topic: str, partitions: int = 1, config: dict | None = None) -> None:
        from kafka.admin import NewTopic
        from kafka.errors import TopicAlreadyExistsError

        topic_config = {}
        if config:
            if config.get("retention-hours") is not None:
                topic_config["retention.ms"] = str(
                    int(float(config["retention-hours"]) * 3600 * 1000)
                )
            if config.get("segment-bytes") is not None:
                topic_config["segment.bytes"] = str(int(config["segment-bytes"]))
            if config.get("max-size") is not None:
                topic_config["max.message.bytes"] = str(int(config["max-size"]))
        admin = self._admin()
        try:
            admin.create_topics(
                [
                    NewTopic(
                        name=topic,
                        num_partitions=max(1, partitions),
                        replication_factor=1,
                        topic_configs=topic_config,
                    )
                ]
            )
        except TopicAlreadyExistsError:
            pass
        finally:
            admin.close()

    def topic_exists(self, topic: str) -> bool:
        admin = self._admin()
        try:
            return topic in admin.list_topics()
        finally:
            admin.close()

    def delete_topic(self, topic: str) -> None:
        admin = self._admin()
        try:
            admin.delete_topics([topic])
        finally:
            admin.close()

    def producer(self, topic: str) -> TopicProducer:
        return _KafkaProducer(self, topic)

    def consumer(
        self, topic: str, group: str | None = None, from_beginning: bool = False,
        partitions: list[int] | None = None,
    ) -> TopicConsumer:
        if partitions is not None:
            raise ValueError(
                "kafka:// consumers do not support manual partition assignment"
            )
        return _KafkaConsumer(self, topic, group, from_beginning)

    def _offset_consumer(self, group: str):
        import kafka

        return kafka.KafkaConsumer(
            bootstrap_servers=self.bootstrap.split(","),
            group_id=group,
            enable_auto_commit=False,
        )

    def get_offsets(self, group: str, topic: str) -> dict[int, int]:
        import kafka
        from kafka.structs import TopicPartition

        c = self._offset_consumer(group)
        try:
            parts = c.partitions_for_topic(topic) or set()
            out = {}
            for p in sorted(parts):
                committed = c.committed(TopicPartition(topic, p))
                if committed is not None:
                    # kafka-python < 2.0 returns the raw offset int; newer
                    # versions return an OffsetAndMetadata struct
                    out[p] = int(getattr(committed, "offset", committed))
            return out
        finally:
            c.close()

    def set_offsets(self, group: str, topic: str, offsets: dict[int, int]) -> None:
        from kafka.structs import OffsetAndMetadata, TopicPartition

        def _oam(offset: int):
            # OffsetAndMetadata grew a leader_epoch field (3 args) in
            # kafka-python 2.1; build 3-arg first, fall back to the 2-arg
            # (offset, metadata) form of 1.4-2.0
            try:
                return OffsetAndMetadata(offset, None, -1)
            except TypeError:
                return OffsetAndMetadata(offset, None)

        c = self._offset_consumer(group)
        try:
            c.commit(
                {
                    TopicPartition(topic, int(p)): _oam(int(o))
                    for p, o in offsets.items()
                }
            )
        finally:
            c.close()

    def latest_offsets(self, topic: str) -> dict[int, int]:
        import kafka
        from kafka.structs import TopicPartition

        c = kafka.KafkaConsumer(bootstrap_servers=self.bootstrap.split(","))
        try:
            parts = sorted(c.partitions_for_topic(topic) or set())
            tps = [TopicPartition(topic, p) for p in parts]
            ends = c.end_offsets(tps)
            return {tp.partition: int(off) for tp, off in ends.items()}
        finally:
            c.close()
