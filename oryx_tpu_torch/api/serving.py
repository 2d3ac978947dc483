"""Serving layer SPI.

Rebuild of framework/oryx-api .../serving/ServingModelManager.java:35-75,
ServingModel.java, AbstractServingModelManager.java:39-53 and the
HasCSV marker used for text/csv content negotiation.

Port note: a copy of ``oryx_tpu/api/serving.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import abc
from typing import Iterator

from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common.config import Config


class ServingModel(abc.ABC):
    @abc.abstractmethod
    def get_fraction_loaded(self) -> float:
        """Approximate fraction (0..1) of the model loaded so far."""


class HasCSV(abc.ABC):
    """Objects that can render themselves as a CSV line (HasCSV.java)."""

    @abc.abstractmethod
    def to_csv(self) -> str: ...


class ServingModelManager(abc.ABC):
    """Consumes models/updates from the update topic and serves the current
    model to REST resources."""

    @abc.abstractmethod
    def consume(self, update_iterator: Iterator[KeyMessage]) -> None:
        """Blocking loop reading (MODEL|MODEL-REF|UP) messages; runs on a
        daemon thread started by the serving runtime
        (ModelManagerListener.java:134-145)."""

    def consume_blocks(self, block_iterator) -> None:
        """Columnar form of consume (iterator of RecordBlocks). Default
        adapts to the per-record consume(); managers with heavy replay
        traffic (ALS factor publishes are one UP per vector) override it
        to parse whole blocks vectorized."""
        self.consume(
            km for block in block_iterator for km in block.iter_key_messages()
        )

    @abc.abstractmethod
    def get_config(self) -> Config: ...

    @abc.abstractmethod
    def get_model(self) -> object | None: ...

    @abc.abstractmethod
    def is_read_only(self) -> bool: ...

    def close(self) -> None:
        """Release resources (idempotent)."""


class AbstractServingModelManager(ServingModelManager):
    """Convenience base: holds config, answers read-only from
    oryx.serving.api.read-only (AbstractServingModelManager.java:39-53)."""

    def __init__(self, config: Config) -> None:
        self._config = config
        self._read_only = config.get_bool("oryx.serving.api.read-only")

    def get_config(self) -> Config:
        return self._config

    def is_read_only(self) -> bool:
        return self._read_only
