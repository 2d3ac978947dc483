"""ALS speed layer (counterpart of ``oryx_tpu/app/als/speed.py``): not
ported yet.

The JAX package folds new interactions into the user and item factors
with ``ops/als.fold_in_batch`` and its fold-in sessions, which come to
the port with ALS training. Until then a speed config that names this
manager is refused at construction rather than started without one.
"""

from __future__ import annotations

from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch.common.config import Config


class ALSSpeedModelManager:
    def __init__(self, config: Config) -> None:
        raise NotYetPortedError(
            "the ALS speed layer (ALSSpeedModelManager) is not yet ported to oryx_tpu_torch"
        )
