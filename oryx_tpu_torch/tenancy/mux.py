"""Serving-side tenant multiplexing.

One serving replica hosts every tenant's model behind the single
``ServingContext`` the resource handlers already know: the mux objects
below implement the same ``get_model()`` / ``send()`` surfaces as a
plain model manager / input producer, but resolve the *current* tenant
(``tenancy.context``) on every call. Handlers stay tenant-blind — the
HTTP layer scopes the tenant over the dispatch, and the mux picks the
right tenant's manager, tracker, or topic underneath them.

Port note: a copy of ``oryx_tpu/tenancy/mux.py`` (JAX-free), with its
imports pointed at ``oryx_tpu_torch``, plus ``TenantInputMux.send_many``:
the port's bulk routes (``/add``, ``/ingest``, ``/train``) send a
request's lines in one ``send_many`` (``app/serving_common.send_inputs``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from oryx_tpu_torch.tenancy.context import current_tenant
from oryx_tpu_torch.tenancy.spec import TenantSpec


@dataclass
class TenantRuntime:
    """One tenant's live serving-side state on this replica."""

    spec: TenantSpec
    config: Any  # the tenant's namespaced view (tenancy.spec.tenant_config)
    manager: Any  # the tenant's serving model manager
    health: Any  # per-tenant ServingHealth (staleness / live generation)
    tracker: Any  # per-tenant GenerationTracker
    store: Any = None  # per-tenant RegistryStore (None without a model dir)
    consumer: Any = None  # per-tenant update-topic consumer
    thread: Any = None  # the SupervisedThread driving consume_blocks
    producer: Any = None  # per-tenant input-topic producer (ingest path)
    extras: dict = field(default_factory=dict)


class TenantServingMux:
    """Model-manager facade multiplexing per-tenant managers.

    Exposes the subset of the model-manager surface the serving layer and
    the resource handlers touch (``get_model``, ``consume_blocks`` is per
    tenant and never called on the mux, ``close``), resolving the tenant
    from the request-scoped ContextVar. With no tenant in scope the
    registry's default tenant answers, so untenanted legacy clients keep
    working on a tenant-enabled fleet.
    """

    def __init__(
        self,
        runtimes: dict[str, TenantRuntime],
        default_tenant: str | None = None,
    ) -> None:
        self._runtimes = dict(runtimes)
        self._default = default_tenant

    # -- resolution --

    def _resolve(self) -> TenantRuntime | None:
        tid = current_tenant() or self._default
        return self._runtimes.get(tid) if tid else None

    def runtime(self, tenant_id: str) -> TenantRuntime | None:
        return self._runtimes.get(tenant_id)

    def runtimes(self) -> dict[str, TenantRuntime]:
        return dict(self._runtimes)

    def ids(self) -> list[str]:
        return list(self._runtimes)

    # -- model-manager surface --

    def get_model(self):
        rt = self._resolve()
        return rt.manager.get_model() if rt is not None else None

    def tenant_models(self) -> dict[str, Any]:
        """tenant id -> current model (None while loading) — readiness."""
        return {tid: rt.manager.get_model() for tid, rt in self._runtimes.items()}

    def live_generations(self) -> dict[str, str | None]:
        """tenant id -> live generation, the fleet-skew input."""
        return {
            tid: rt.health.live_generation for tid, rt in self._runtimes.items()
        }

    def close(self) -> None:
        for rt in self._runtimes.values():
            manager_close = getattr(rt.manager, "close", None)
            if manager_close is not None:
                manager_close()

    def __getattr__(self, name: str):
        """Manager-specific surface (``is_read_only``, app-specific
        helpers) forwards to the CURRENT tenant's manager — resolved at
        attribute access, which happens on the request thread inside the
        dispatch's tenant scope."""
        if name.startswith("_"):
            raise AttributeError(name)
        rt = self._resolve()
        if rt is None:
            raise AttributeError(
                f"{name!r}: no tenant in scope and no default tenant"
            )
        return getattr(rt.manager, name)


class TenantInputMux:
    """Input-producer facade: ``send()`` routes to the current tenant's
    input topic, so the app ingest endpoints stay tenant-blind too."""

    def __init__(
        self,
        producers: dict[str, Any],
        default_tenant: str | None = None,
    ) -> None:
        self._producers = dict(producers)
        self._default = default_tenant

    def _producer(self):
        tid = current_tenant() or self._default
        producer = self._producers.get(tid) if tid else None
        if producer is None:
            raise RuntimeError(
                f"no input topic for tenant {tid!r}"
                if tid
                else "no tenant in scope for ingest"
            )
        return producer

    def send(self, key, value) -> None:
        self._producer().send(key, value)

    def send_many(self, pairs) -> None:
        self._producer().send_many(pairs)

    def close(self) -> None:
        for producer in self._producers.values():
            producer.close()
