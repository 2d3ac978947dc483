"""Example serving model manager + endpoints (reference: app/example/...
/serving/{ExampleServingModelManager,ExampleServingModel,Add,Distinct}
.java).

Port note: a copy of ``oryx_tpu/example/serving.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import json
import threading
from typing import Iterator

from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.serving.web import OryxServingException, Request, Response, ServingContext, resource


class ExampleServingModel(ServingModel):
    def __init__(self, counts: dict[str, int]) -> None:
        self._counts = counts

    def get_fraction_loaded(self) -> float:
        return 1.0

    def get_words(self) -> dict[str, int]:
        return self._counts


class ExampleServingModelManager(AbstractServingModelManager):
    def __init__(self, config) -> None:
        super().__init__(config)
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._have_model = False

    def consume(self, update_iterator: Iterator[KeyMessage]) -> None:
        for km in update_iterator:
            if km.key == "MODEL":
                model = json.loads(km.message)
                with self._lock:
                    for stale in set(self._counts) - set(model):
                        del self._counts[stale]
                    self._counts.update(model)
                    self._have_model = True
            elif km.key == "UP":
                word, count = km.message.split(",", 1)
                with self._lock:
                    self._counts[word] = int(count)
                    self._have_model = True
            else:
                raise ValueError(f"unknown key {km.key}")

    def get_model(self) -> ExampleServingModel | None:
        with self._lock:
            if not self._have_model:
                return None
            return ExampleServingModel(dict(self._counts))


@resource("GET", "/distinct")
def distinct(ctx: ServingContext, req: Request):
    model = ctx.model_manager.get_model() if ctx.model_manager else None
    if model is None:
        raise OryxServingException(503, "model not yet available")
    return model.get_words()


@resource("POST", "/add")
def add(ctx: ServingContext, req: Request) -> Response:
    if ctx.model_manager is not None and ctx.model_manager.is_read_only():
        raise OryxServingException(403, "read-only")
    if ctx.input_producer is None:
        raise OryxServingException(503, "no input topic configured")
    for line in req.text().splitlines():
        if line.strip():
            ctx.input_producer.send(None, line.strip())
    return Response(204)
