"""Example batch update (reference: app/example/.../batch/
ExampleBatchLayerUpdate.java:28-56).

Port note: a copy of ``oryx_tpu/example/batch.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import json
from typing import Iterable

from oryx_tpu_torch.api.batch import BatchLayerUpdate
from oryx_tpu_torch.bus.core import KeyMessage, TopicProducer


def count_distinct_other_words(data: Iterable[KeyMessage]) -> dict[str, int]:
    """For each word, the number of distinct other words it has ever
    co-occurred with on a line (countDistinctOtherWords semantics)."""
    pairs: set[tuple[str, str]] = set()
    for rec in data:
        tokens = set(rec.message.split(" "))
        for a in tokens:
            for b in tokens:
                if a != b:
                    pairs.add((a, b))
    counts: dict[str, int] = {}
    for a, _ in pairs:
        counts[a] = counts.get(a, 0) + 1
    return counts


class ExampleBatchLayerUpdate(BatchLayerUpdate):
    def run_update(
        self,
        timestamp_ms: int,
        new_data: Iterable[KeyMessage],
        past_data: Iterable[KeyMessage],
        model_dir: str,
        model_update_topic: TopicProducer | None,
    ) -> None:
        all_data = list(new_data) + list(past_data)
        model = count_distinct_other_words(all_data)
        if model_update_topic is not None:
            model_update_topic.send("MODEL", json.dumps(model))
