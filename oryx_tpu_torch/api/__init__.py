"""User-facing SPI (counterpart of ``oryx_tpu/api``): the batch, speed
(``api/speed.py``) and serving interfaces apps implement.
"""

from oryx_tpu_torch.api.batch import BatchLayerUpdate  # noqa: F401

from oryx_tpu_torch.api.serving import (  # noqa: F401
    AbstractServingModelManager,
    ServingModel,
    ServingModelManager,
)
