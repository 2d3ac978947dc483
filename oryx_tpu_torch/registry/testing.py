"""A PMML-aware probe ServingModelManager for registry tests.

The example app's manager speaks JSON word counts; registry e2e tests
need a manager that resolves MODEL / MODEL-REF messages exactly the way
the real apps do (app_pmml.read_pmml_from_update_message) and then lets
the test ask *which* generation it is serving — including through its
own ``/probe/model`` resource, so HTTP-level assertions exercise the full
router + manager + tracker stack. Configure with

    oryx.serving.model-manager-class =
        "oryx_tpu_torch.registry.testing.PMMLProbeServingModelManager"
    oryx.serving.application-resources = ["oryx_tpu_torch.registry.testing"]

Lives in the package (not tests/) because model-manager-class must be an
importable module path.

Port note: a copy of ``oryx_tpu/registry/testing.py`` (JAX-free), with
its imports pointed at ``oryx_tpu_torch``. It is the tenancy ``probe``
app, and the one generation-aware manager, in both packages.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Iterator

from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common import pmml as pmml_io
from oryx_tpu_torch.experiments import routing as experiments_routing
from oryx_tpu_torch.ml.update import MLUpdate
from oryx_tpu_torch.serving.web import OryxServingException, Request, Response, ServingContext, resource


class ScriptedMetricUpdate(MLUpdate):
    """An MLUpdate whose eval metric is scripted by config
    (``oryx.test.scripted-metric``) — the knob registry e2e tests turn to
    push one generation past the champion gate and throw the next into it.
    The train/test split is overridden to a deterministic half/half so
    ``evaluate`` always runs (NaN metrics pass the gate by design)."""

    def __init__(self, config) -> None:
        super().__init__(config)
        self.scripted_metric = config.get_float("oryx.test.scripted-metric")

    def build_model(self, train_data, hyper_parameters, candidate_path):
        root = pmml_io.build_skeleton_pmml()
        pmml_io.sub(
            root,
            "Extension",
            {"name": "scripted-metric", "value": str(self.scripted_metric)},
        )
        return root

    def evaluate(self, model, model_parent_path, test_data, train_data):
        return self.scripted_metric

    def split_new_data_to_train_test(self, new_data):
        half = max(1, len(new_data) // 2)
        return new_data[:half], new_data[half:]


class PMMLProbeModel(ServingModel):
    def __init__(self, generation_id: str | None, extensions: dict[str, str]) -> None:
        self.generation_id = generation_id
        self.extensions = extensions

    def get_fraction_loaded(self) -> float:
        return 1.0


class PMMLProbeServingModelManager(AbstractServingModelManager):
    """Swaps in whatever PMML generation arrives; counts swaps so dedupe
    tests can assert a duplicate MODEL never re-triggered one.

    Generation-aware: recent generations are retained by id, and
    ``get_model`` honors the per-request override the experiment router
    sets (oryx_tpu_torch/experiments/routing.py), so a challenger-arm request
    is really answered by the challenger generation's model while the
    champion stays live for everyone else."""

    _RETAIN_GENERATIONS = 4

    def __init__(self, config) -> None:
        super().__init__(config)
        self._lock = threading.Lock()
        self._model: PMMLProbeModel | None = None
        self._by_generation: dict[str, PMMLProbeModel] = {}
        self.model_swaps = 0
        self.challenger_loads = 0

    def consume(self, update_iterator: Iterator[KeyMessage]) -> None:
        from oryx_tpu_torch.app import pmml as app_pmml
        from oryx_tpu_torch.common import pmml as pmml_io
        from oryx_tpu_torch.registry.manifest import GENERATION_EXTENSION

        for km in update_iterator:
            if km.key not in ("MODEL", "MODEL-REF"):
                continue
            pmml = app_pmml.read_pmml_from_update_message(km.key, km.message)
            if pmml is None:
                continue
            extensions = {
                e.get("name"): e.get("value")
                for e in pmml_io.findall(pmml, "Extension")
                if e.get("name")
            }
            model = PMMLProbeModel(extensions.get(GENERATION_EXTENSION), extensions)
            challenger = experiments_routing.consuming_challenger()
            with self._lock:
                if model.generation_id is not None:
                    self._by_generation[model.generation_id] = model
                    while len(self._by_generation) > self._RETAIN_GENERATIONS:
                        self._by_generation.pop(next(iter(self._by_generation)))
                if (
                    model.generation_id is not None
                    and model.generation_id == challenger
                ):
                    # an online-gate challenger: loaded and servable via
                    # the per-request override, but the live default stays
                    # the champion until the gate promotes it
                    self.challenger_loads += 1
                else:
                    self._model = model
                    self.model_swaps += 1

    def get_model(self) -> PMMLProbeModel | None:
        requested = experiments_routing.requested_generation()
        with self._lock:
            if requested is not None:
                retained = self._by_generation.get(requested)
                if retained is not None:
                    return retained
            return self._model


@resource("GET", "/probe/model")
def probe_model(ctx: ServingContext, req: Request) -> Response:
    model = ctx.model_manager.get_model() if ctx.model_manager else None
    if model is None:
        raise OryxServingException(503, "model not yet available")
    body = {"generation_id": model.generation_id, "extensions": model.extensions}
    return Response(200, body, content_type="application/json")


@resource("GET", "/probe/recommend/{userID}")
def probe_recommend(ctx: ServingContext, req: Request) -> Response:
    """A /recommend-shaped traffic target for the open-loop fleet harness
    (tools/fleet.py): per-user path (so the generator's power-law user
    skew exercises real routing) answering with the generation that
    served it — the response-level evidence a rotation happened under
    load with zero failures."""
    model = ctx.model_manager.get_model() if ctx.model_manager else None
    if model is None:
        raise OryxServingException(503, "model not yet available")
    # test-only overlay knob: scripted per-request service time, so the
    # overload/autoscale fleet tests can saturate a replica at a known
    # rate (Little's law) deterministically on a single-core host
    work_ms = ctx.config.get_optional_float("oryx.test.probe-work-ms") if ctx.config else None
    if work_ms:
        time.sleep(work_ms / 1000.0)
    user = req.params["userID"]
    body = {
        "user": user,
        "generation_id": model.generation_id,
        # deterministic per-(generation, user) ranked item list: stable
        # across replicas and runs, different across generations — the
        # recommendation surface the experiment evaluator joins
        # interaction events against (docs/experiments.md)
        "items": probe_items(model.generation_id, user),
    }
    return Response(200, body, content_type="application/json")


def probe_items(generation_id: str | None, user: str, n: int = 3) -> list[str]:
    """The ranked items /probe/recommend serves for (generation, user) —
    exported so scripted feedback (loadgen) and tests can recompute the
    exact list without parsing responses."""
    seed = int.from_bytes(
        hashlib.blake2b(
            f"{generation_id}:{user}".encode("utf-8"), digest_size=4
        ).digest(),
        "big",
    )
    return [f"i{(seed + k) % 1000}" for k in range(n)]
