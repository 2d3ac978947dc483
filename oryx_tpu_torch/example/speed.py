"""Example speed model manager (reference: app/example/.../speed/
ExampleSpeedModelManager.java).

Port note: a copy of ``oryx_tpu/example/speed.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import json
import threading
from typing import Iterable, Iterator

from oryx_tpu_torch.api.speed import SpeedModelManager
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.example.batch import count_distinct_other_words


class ExampleSpeedModelManager(SpeedModelManager):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def consume(self, update_iterator: Iterator[KeyMessage]) -> None:
        for km in update_iterator:
            if km.key == "MODEL":
                model = json.loads(km.message)
                with self._lock:
                    for stale in set(self._counts) - set(model):
                        del self._counts[stale]
                    self._counts.update(model)
            elif km.key == "UP":
                pass  # this manager's own updates; nothing to do
            else:
                raise ValueError(f"unknown key {km.key}")

    def build_updates(self, new_data: Iterable[KeyMessage]) -> Iterable[str]:
        out = []
        for word, count in count_distinct_other_words(new_data).items():
            with self._lock:
                new_count = self._counts.get(word, 0) + count
                self._counts[word] = new_count
            out.append(f"{word},{new_count}")
        return out
