"""Serving-layer runtime (counterpart of ``oryx_tpu/serving``): embedded
HTTP server, request micro-batcher and model-manager lifecycle.
"""

from oryx_tpu_torch.serving.web import (  # noqa: F401
    OryxServingException,
    Request,
    Response,
    ServingContext,
    resource,
)
from oryx_tpu_torch.serving.layer import ServingLayer  # noqa: F401
