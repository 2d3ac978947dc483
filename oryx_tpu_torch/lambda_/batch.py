"""Batch layer runtime.

Rebuild of BatchLayer + BatchUpdateFunction + SaveToHDFSFunction +
UpdateOffsetsFn + DeleteOldDataFn (framework/oryx-lambda/.../batch/,
SURVEY.md §2.4, call stack §3.1). Per generation interval:

1. drain the input topic into a micro-batch,
2. read all surviving past data from the data dir,
3. invoke the configured BatchLayerUpdate (which trains on past+new and
   publishes MODEL/MODEL-REF + UP messages),
4. append the micro-batch to the data dir,
5. commit input offsets to the offset ledger (at-least-once),
6. GC data/models past their max age.

Step 3 runs before step 4 so the update sees `new_data` and `past_data`
disjoint, matching the reference's foreachRDD registration order
(BatchLayer.java:103-122).

Port note: a copy of ``oryx_tpu/lambda_/batch.py`` with its imports pointed
at ``oryx_tpu_torch``, but for two repairs. The drain runs to the input
topic's end as of the generation's start, where the JAX package's ends at
the first empty poll, which on a ``fault+`` bus is also a poll lost in
flight (so each generation there trains on a random prefix of its input).
A generation that fails before step 4 seeks the consumer back to where it
started, where the JAX package's keeps its place, so the failed
generation's records are neither saved nor trained on until the process
restarts from its last commit. The update class must be one of the port's (a
name under ``oryx_tpu`` is refused), and the layer trains on the card:
it raises at construction without CUDA unless the caller chose the CPU
(``oryx_tpu_torch.device.set_device("cpu")``). With
``oryx.batch.compute.profile-dir`` each generation writes a
``torch.profiler`` Chrome trace there (``common/profiling.py``).
"""

from __future__ import annotations

import logging
import threading
import time

from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common import metrics, profiling
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.crashpoints import crashpoint
from oryx_tpu_torch.common.lang import check_port_module, load_instance_of
from oryx_tpu_torch.device import default_device
from oryx_tpu_torch.lambda_ import data as data_store
from oryx_tpu_torch.lambda_.base import DRAIN_EMPTY_POLLS, AbstractLayer, behind

log = logging.getLogger(__name__)


class BatchLayer(AbstractLayer):
    def __init__(self, config: Config) -> None:
        super().__init__(config, "batch")
        self.update_class = config.get_string("oryx.batch.update-class")
        self.data_dir = config.get_string("oryx.batch.storage.data-dir")
        self.model_dir = config.get_string("oryx.batch.storage.model-dir")
        self.max_data_age_hours = config.get_int("oryx.batch.storage.max-age-data-hours")
        self.storage_format = config.get_string("oryx.batch.storage.format")
        if self.storage_format not in ("npz", "jsonl"):
            raise ValueError(
                f"oryx.batch.storage.format must be npz or jsonl, got {self.storage_format!r}"
            )
        self.max_model_age_hours = (
            config.get_optional_int("oryx.batch.storage.max-age-model-hours") or -1
        )
        check_port_module(self.update_class, "oryx.batch.update-class")
        default_device()  # the port trains on the card: fail now, not per generation
        self._update = load_instance_of(self.update_class, config)
        # guards _consumer/_generation_count: the supervised generation
        # thread lazily attaches the consumer and bumps the counter while
        # close()/generation_count read them from the caller's thread
        # (oryxlint lockset ORX102)
        self._state_lock = threading.Lock()
        self._consumer = None
        self._thread = None
        self._generation_count = 0

    # -- public lifecycle ---------------------------------------------------

    def prepare(self) -> None:
        """Create topics and attach the input consumer without starting the
        background loop; from this point input is observed. Useful when
        driving generations explicitly (tests, one-shot CLI runs)."""
        self.init_topics()
        self.maybe_start_ui()
        with self._state_lock:
            if self._consumer is None:
                self._consumer = self.make_input_consumer()

    def start(self) -> None:
        self.prepare()
        # supervised: a failed generation restarts the loop with backoff
        # under oryx.batch.retry.*; max-attempts consecutive failures and
        # the layer reports unhealthy (docs/resilience.md)
        self._thread = self.supervise(
            "BatchLayer", self._one_interval, loop=True, metrics_prefix="batch.loop"
        )
        log.info("BatchLayer started: interval=%ss update=%s", self.generation_interval_sec, self.update_class)

    def close(self) -> None:
        super().close()
        with self._state_lock:
            consumer = self._consumer
        if consumer is not None:
            consumer.close()
        self.join_or_report_leak(self._thread)

    @property
    def generation_count(self) -> int:
        with self._state_lock:
            return self._generation_count

    # -- generation loop ----------------------------------------------------


    def _one_interval(self) -> None:
        """One supervised generation interval (wait, then generation)."""
        self._stop_event.wait(self.generation_interval_sec)
        if not self.is_stopped():
            self.run_one_generation()

    def run_one_generation(self, timestamp_ms: int | None = None) -> None:
        """One full generation; callable directly for deterministic tests."""
        with metrics.timed(metrics.registry.histogram("batch.generation.seconds")):
            try:
                with profiling.maybe_trace(
                    profiling.profile_dir_from_config(self.config, "batch"),
                    "batch-generation",
                ):
                    self._run_one_generation(timestamp_ms)
            except Exception:
                metrics.registry.counter("batch.generations.failed").inc()
                raise
        metrics.registry.counter("batch.generations").inc()

    def _drain_and_update(self, consumer, timestamp_ms: int, phase) -> list[KeyMessage]:
        """Steps 1-3: drain, read past data, run the update. Returns the
        new data."""
        # 1. drain the input topic up to its end as of now (base.behind)
        new_data: list[KeyMessage] = []
        with phase("drain"):
            end = self.input_end()
            empty = 0
            while True:
                batch = consumer.poll(max_records=10_000, timeout=0.05)
                if batch:
                    new_data.extend(batch)
                    empty = 0
                    continue
                empty += 1
                if empty >= DRAIN_EMPTY_POLLS or not behind(consumer.positions(), end):
                    break

        # 2. past data as a lazy columnar view — blocks stream from storage
        # during the update itself (one stored micro-batch in memory at a
        # time), so the phase metric covers only discovery
        with phase("read-past"):
            past_data = data_store.FileRecords(self.data_dir)

        # 3. user update, with a producer for the update topic
        ub = self.update_broker()
        producer = ub.producer(self.update_topic) if ub is not None else None
        try:
            with phase("update"):
                self._update.run_update(
                    timestamp_ms, new_data, past_data, self.model_dir, producer
                )
        finally:
            if producer is not None:
                producer.close()
        return new_data

    def _run_one_generation(self, timestamp_ms: int | None = None) -> None:
        with self._state_lock:
            if self._consumer is None:
                self._consumer = self.make_input_consumer()
            consumer = self._consumer
        timestamp_ms = int(time.time() * 1000) if timestamp_ms is None else timestamp_ms

        def phase(name):
            return metrics.timed(
                metrics.registry.histogram(f"batch.phase.{name}.seconds")
            )

        # a generation that fails before its micro-batch is saved puts the
        # consumer back where it started, so the next one drains the same
        # records (the JAX package's moves on: they are lost to it until
        # the process restarts from the last commit)
        start = dict(consumer.positions())
        try:
            new_data = self._drain_and_update(consumer, timestamp_ms, phase)
        except BaseException:
            consumer.seek(start)
            raise

        # 4. persist the micro-batch
        crashpoint("batch.save.pre")
        with phase("save"):
            data_store.save_micro_batch(
                self.data_dir, timestamp_ms, new_data, fmt=self.storage_format
            )

        # 5. commit offsets (UpdateOffsetsFn.java:57-65)
        crashpoint("batch.commit.pre")
        if self.id:
            consumer.commit()

        # 6. age-based GC
        with phase("gc"):
            data_store.delete_old_data(self.data_dir, self.max_data_age_hours)
            data_store.delete_old_models(self.model_dir, self.max_model_age_hours)

        with self._state_lock:
            self._generation_count += 1
