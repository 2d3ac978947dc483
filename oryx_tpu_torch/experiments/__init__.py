"""Online experiment observability (docs/experiments.md).

Champion/challenger traffic splitting, interleaved online evaluation of
served recommendations against subsequent interaction events, and the
evidence feed for the online promotion gate (``oryx.ml.gate.online``).

The package is stdlib-only and import-light on purpose: the serving
request path touches it on every request while an experiment is active,
and the tracker imports it at module load.

Port note: a copy of ``oryx_tpu/experiments/__init__.py`` (JAX-free),
with its imports pointed at ``oryx_tpu_torch``.
"""

from oryx_tpu_torch.experiments.routing import (
    ARM_CHALLENGER,
    ARM_CHAMPION,
    ARM_HEADER,
    ABConfig,
    ArmRouter,
    bucket_of,
    requested_generation,
    serve_generation,
)
from oryx_tpu_torch.experiments.evaluator import ArmStats, ExperimentEvaluator
from oryx_tpu_torch.experiments.coordinator import ExperimentCoordinator

__all__ = [
    "ABConfig",
    "ARM_CHALLENGER",
    "ARM_CHAMPION",
    "ARM_HEADER",
    "ArmRouter",
    "ArmStats",
    "ExperimentCoordinator",
    "ExperimentEvaluator",
    "bucket_of",
    "requested_generation",
    "serve_generation",
]
