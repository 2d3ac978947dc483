"""User-facing SPI (counterpart of ``oryx_tpu/api``): the serving
interface apps implement. The batch and speed interfaces are not ported
yet.
"""

from oryx_tpu_torch.api.serving import (  # noqa: F401
    AbstractServingModelManager,
    ServingModel,
    ServingModelManager,
)
