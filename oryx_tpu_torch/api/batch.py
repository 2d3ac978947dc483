"""Batch layer SPI.

Rebuild of framework/oryx-api/src/main/java/com/cloudera/oryx/api/batch/
BatchLayerUpdate.java:38-59 — the entire batch contract is one method.

Port note: a copy of ``oryx_tpu/api/batch.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import abc
from typing import Iterable

from oryx_tpu_torch.bus.core import KeyMessage, TopicProducer


class BatchLayerUpdate(abc.ABC):
    """Implementations specify what is done with current and historical data
    to update a model. Constructed with the app Config when the constructor
    accepts one (ClassUtils-style instantiation)."""

    @abc.abstractmethod
    def run_update(
        self,
        timestamp_ms: int,
        new_data: Iterable[KeyMessage],
        past_data: Iterable[KeyMessage],
        model_dir: str,
        model_update_topic: TopicProducer | None,
    ) -> None:
        """Run one batch-model update: `new_data` is the input that arrived
        in this generation interval, `past_data` is all surviving earlier
        input re-read from the data dir (empty iterable if none), and models
        / updates are published to `model_update_topic` (None when the
        update topic is disabled).

        Mirrors BatchLayerUpdate.runUpdate(sparkContext, timestamp, newData,
        pastData, modelDirString, modelUpdateTopic); there is no Spark
        context — implementations run PyTorch programs directly.
        """
