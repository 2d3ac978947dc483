"""Multi-tenant lambda: the tenant as a first-class identity.

The Java reference runs exactly one BatchLayerUpdate / SpeedModelManager /
ServingModelManager triple per process (PAPER.md); this package removes
that limit. A *tenant* is one packaged app (ALS, k-means, RDF, or the
test probe app) with its own input/update topics, registry lineage, SLO
and fair-share weight, declared under ``oryx.tenancy.tenants.<id>`` in
HOCON. The pieces:

- :mod:`oryx_tpu_torch.tenancy.spec` — ``TenantSpec`` / ``TenantRegistry``
  parsing plus :func:`tenant_config`, the namespacing overlay that turns
  the base config into one tenant's private view (topics, data/model
  dirs, app classes);
- :mod:`oryx_tpu_torch.tenancy.context` — the request-thread ContextVar that
  carries the resolved tenant from HTTP dispatch into the batcher and
  shed counters (the same pattern as the overload probe override);
- :mod:`oryx_tpu_torch.tenancy.mux` — the serving-side model-manager facade
  multiplexing per-tenant managers behind the single
  ``ctx.model_manager`` the resources already use;
- :mod:`oryx_tpu_torch.tenancy.pipelines` — N tenants' batch/speed layers in
  one process, each with its own MLUpdate lineage and crash/repair
  invariants.

Fairness (docs/multi-tenancy.md): the adaptive batcher services
per-tenant queues deficit-round-robin by ``weight``, and the admission
controller keeps a per-tenant shed ladder, so a hot tenant sheds itself
before it can starve its neighbours.

Port note: a copy of ``oryx_tpu/tenancy/__init__.py`` (JAX-free), with
its imports pointed at ``oryx_tpu_torch``; the apps a tenant runs are the
port's, on the card.
"""

from oryx_tpu_torch.tenancy.context import (
    TENANT_HEADER,
    TENANT_PATH_PREFIX,
    current_tenant,
    split_tenant_path,
    tenant_scope,
)
from oryx_tpu_torch.tenancy.spec import (
    APP_WIRING,
    TenantSpec,
    TenantRegistry,
    namespaced,
    tenant_config,
)

__all__ = [
    "APP_WIRING",
    "TENANT_HEADER",
    "TENANT_PATH_PREFIX",
    "TenantRegistry",
    "TenantSpec",
    "current_tenant",
    "namespaced",
    "split_tenant_path",
    "tenant_config",
    "tenant_scope",
]
