"""Model registry (counterpart of ``oryx_tpu/registry``): per-generation
manifests, the CHAMPION pointer and retention GC (``store``), the
champion/challenger gate (``gate``) and serving-side generation tracking
with duplicate-MODEL suppression (``tracking``). The serving layer's
``/model/generations`` and ``/model/rollback/<generation>`` read and move
them; ``testing`` holds the probe app (a scripted-metric update and a
generation-aware serving manager).
"""

from oryx_tpu_torch.registry.gate import ChampionGate, GateDecision
from oryx_tpu_torch.registry.manifest import (
    GENERATION_EXTENSION,
    MANIFEST_FILE_NAME,
    PARENT_EXTENSION,
    GenerationManifest,
)
from oryx_tpu_torch.registry.store import CHAMPION_FILE_NAME, RegistryStore, publish_generation

__all__ = [
    "CHAMPION_FILE_NAME",
    "ChampionGate",
    "GENERATION_EXTENSION",
    "GateDecision",
    "GenerationManifest",
    "MANIFEST_FILE_NAME",
    "PARENT_EXTENSION",
    "RegistryStore",
    "publish_generation",
]
