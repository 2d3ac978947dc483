"""Speed layer SPI.

Rebuild of framework/oryx-api .../speed/SpeedModelManager.java:37-66 and
SpeedModel.java.

Port note: a copy of ``oryx_tpu/api/speed.py`` (JAX-free), with its
imports pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import abc
from typing import Iterable, Iterator

from oryx_tpu_torch.bus.core import KeyMessage


class SpeedModel(abc.ABC):
    """In-memory speed model with incremental-load accounting."""

    @abc.abstractmethod
    def get_fraction_loaded(self) -> float:
        """Approximate fraction (0..1) of the model loaded so far."""


class SpeedModelManager(abc.ABC):
    """Consumes models/updates from the update topic and produces deltas
    from new input micro-batches."""

    @abc.abstractmethod
    def consume(self, update_iterator: Iterator[KeyMessage]) -> None:
        """Blocking loop reading (MODEL|MODEL-REF|UP) messages and updating
        in-memory model state; runs on a dedicated thread
        (SpeedLayer.java:107-131)."""

    def consume_blocks(self, block_iterator) -> None:
        """Columnar form of consume: an iterator of RecordBlocks. The
        default adapts to the per-record consume(); managers on the hot
        self-consume path (ALS at 100K+ deltas/s) override this to parse
        whole blocks vectorized."""
        self.consume(
            km for block in block_iterator for km in block.iter_key_messages()
        )

    @abc.abstractmethod
    def build_updates(self, new_data: Iterable[KeyMessage]) -> Iterable[str]:
        """Given one micro-batch of input, return serialized model updates;
        each is published to the update topic with key "UP"
        (SpeedLayerUpdate.java:52-64)."""

    def close(self) -> None:
        """Release resources (idempotent)."""
