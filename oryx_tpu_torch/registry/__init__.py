"""Model registry (counterpart of ``oryx_tpu/registry``): per-generation
manifests, the CHAMPION pointer and retention GC (``store``), and the
champion/challenger gate (``gate``). Serving-side generation tracking
and rollback are not ported yet.
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
