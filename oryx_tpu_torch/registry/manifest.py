"""Per-generation manifest: the lineage record written at promotion.

One ``manifest.json`` lives next to each generation's ``model.pmml``.
It is the registry's source of truth for what a generation is (parent,
hyperparams, eval metric, record counts, wall time, content hash) and
what happened to it (published vs gated). The file is written atomically
(``common/storage`` temp+rename semantics) so a reader never observes a
half-written manifest, and the PMML document itself carries the
generation / parent ids as Extensions so an inline MODEL message is
self-describing on the update topic.

Port note: a copy of ``oryx_tpu/registry/manifest.py`` (JAX-free),
with its imports pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import asdict, dataclass, field

MANIFEST_FILE_NAME = "manifest.json"

# PMML Extension names stamped on every promoted model, so MODEL messages
# (inline PMML) carry their generation identity on the wire
GENERATION_EXTENSION = "generation"
PARENT_EXTENSION = "parent-generation"

STATUS_PUBLISHED = "published"
STATUS_GATED = "gated"

# online-experiment lifecycle of a published generation
# (oryx.ml.gate.online, docs/experiments.md)
ONLINE_PENDING = "pending"  # serving as challenger, accumulating evidence
ONLINE_PROMOTED = "promoted"  # online gate moved the CHAMPION pointer here
ONLINE_REFUSED = "refused"  # online gate dropped it from routing


@dataclass
class GenerationManifest:
    """Everything the registry records about one generation."""

    generation_id: str
    parent_id: str | None = None
    status: str = STATUS_PUBLISHED
    hyperparams: list = field(default_factory=list)
    eval_metric: float | None = None
    # name of the metric's scale; always higher-is-better per the MLUpdate
    # evaluate contract, apps may negate (RMSE) or not (AUC/accuracy)
    train_count: int | None = None
    test_count: int | None = None
    wall_time_sec: float | None = None
    content_hash: str | None = None
    created_at_ms: int | None = None
    gate_reason: str | None = None
    # online-gate lineage: null for generations promoted offline,
    # pending/promoted/refused for evidence-gated ones, plus the
    # decision evidence the gate acted on
    online_status: str | None = None
    online_reason: str | None = None
    online_samples: dict | None = None
    online_lift: float | None = None
    online_confidence: float | None = None

    def to_json(self) -> str:
        d = asdict(self)
        # NaN is not JSON; an unevaluated sole candidate records null
        if d["eval_metric"] is not None and math.isnan(d["eval_metric"]):
            d["eval_metric"] = None
        return json.dumps(d, indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "GenerationManifest":
        d = json.loads(text)
        known = {f for f in GenerationManifest.__dataclass_fields__}
        return GenerationManifest(**{k: v for k, v in d.items() if k in known})

    @property
    def published(self) -> bool:
        return self.status == STATUS_PUBLISHED


def content_hash_of(data: bytes) -> str:
    """sha256 of the model document — the manifest's integrity anchor."""
    return "sha256:" + hashlib.sha256(data).hexdigest()
