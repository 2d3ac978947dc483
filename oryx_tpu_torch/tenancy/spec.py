"""TenantSpec / TenantRegistry: parsing and namespacing.

Tenants are declared in HOCON under ``oryx.tenancy.tenants.<id>``::

    oryx.tenancy = {
      enabled = true
      tenants = {
        movies  = { app = als,    weight = 2 }
        sensors = { app = kmeans, weight = 1, slo = { p99-ms = 250 } }
        churn   = { app = rdf }
      }
    }

Everything else about a tenant is derived by namespacing the base
config: topics become ``<base>.<tenant>``, the batch data/model dirs and
the restage cache gain a ``/<tenant>`` component, and the app type picks
the update/speed/serving classes from :data:`APP_WIRING`. Explicit
``input-topic`` / ``update-topic`` / ``registry-root`` keys on the
tenant block override the derived values — that is how two deployments
share a bus without colliding, or how a tenant is pointed at a
pre-existing registry.

:func:`tenant_config` is the single namespacing authority: the batch and
speed pipelines, the serving layer's per-tenant consumers, the fleet
harness, and the CLI all derive a tenant's private view of the world
through it, so the mapping can never skew between layers.

Port note: a copy of ``oryx_tpu/tenancy/spec.py`` (JAX-free), with its
imports pointed at ``oryx_tpu_torch`` and :data:`APP_WIRING` naming the
port's app classes. A tenant block whose class override names the JAX
package is refused (``common.lang.check_port_module``). The SLO
contract stays on the spec as parsed fields; ``slo_spec()``, which
builds the load generator's ``SLOSpec``, waits for the port's load
generator.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.lang import check_port_module

# App type -> the class triple + resource modules a tenant of that type
# wires in. "probe" is the deterministic test app (scripted-metric PMML
# models + /probe endpoints) the fleet harness serves.
APP_WIRING: dict[str, dict] = {
    "als": {
        "update-class": "oryx_tpu_torch.app.als.update.ALSUpdate",
        "speed-manager": "oryx_tpu_torch.app.als.speed.ALSSpeedModelManager",
        "serving-manager": "oryx_tpu_torch.app.als.serving_model.ALSServingModelManager",
        "resources": ["oryx_tpu_torch.app.als.endpoints"],
    },
    "kmeans": {
        "update-class": "oryx_tpu_torch.app.kmeans.update.KMeansUpdate",
        "speed-manager": "oryx_tpu_torch.app.kmeans.speed.KMeansSpeedModelManager",
        "serving-manager": "oryx_tpu_torch.app.kmeans.serving.KMeansServingModelManager",
        "resources": ["oryx_tpu_torch.app.kmeans.serving"],
    },
    "rdf": {
        "update-class": "oryx_tpu_torch.app.rdf.update.RDFUpdate",
        "speed-manager": "oryx_tpu_torch.app.rdf.speed.RDFSpeedModelManager",
        "serving-manager": "oryx_tpu_torch.app.rdf.serving.RDFServingModelManager",
        "resources": ["oryx_tpu_torch.app.rdf.serving"],
    },
    "probe": {
        "update-class": None,
        "speed-manager": None,
        "serving-manager": "oryx_tpu_torch.registry.testing.PMMLProbeServingModelManager",
        "resources": ["oryx_tpu_torch.registry.testing"],
    },
}


def namespaced(base: str, tenant_id: str) -> str:
    """The per-tenant twin of a shared name: ``OryxUpdate`` ->
    ``OryxUpdate.movies``. Used for topics; registry roots use path
    joins instead."""
    return f"{base}.{tenant_id}"


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's declared identity (``oryx.tenancy.tenants.<id>``)."""

    tenant_id: str
    app: str
    weight: float = 1.0
    quota_qps: float | None = None
    # SLO contract the open-loop harness grades this tenant against
    slo_p99_ms: float = 500.0
    slo_error_rate: float = 0.0
    slo_min_full_quality: float | None = None
    # explicit overrides; None = derive by namespacing the base config
    input_topic: str | None = None
    update_topic: str | None = None
    registry_root: str | None = None
    overrides: dict = field(default_factory=dict, compare=False)
    # free-form config overlay applied last in tenant_config: the tenant's
    # ``config { oryx.input-schema { ... } }`` block — how tenants with
    # different schemas / hyperparams share one base config
    config_overlay: dict = field(default_factory=dict, compare=False)

    def __post_init__(self) -> None:
        if not self.tenant_id or "/" in self.tenant_id or "." in self.tenant_id:
            # ids become path components, topic suffixes and metric label
            # segments — separators would corrupt all three namespaces
            raise ValueError(f"invalid tenant id {self.tenant_id!r}")
        if self.app not in APP_WIRING:
            raise ValueError(
                f"tenant {self.tenant_id!r}: unknown app {self.app!r} "
                f"(known: {', '.join(sorted(APP_WIRING))})"
            )
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.tenant_id!r}: weight must be > 0, got {self.weight}"
            )

    @classmethod
    def from_config(cls, tenant_id: str, block: Config) -> "TenantSpec":
        slo = block.get("slo", None) or {}
        overrides = {
            k: block.get(k, None)
            for k in ("update-class", "speed-manager", "serving-manager")
            if block.get(k, None)
        }
        for k, name in overrides.items():
            check_port_module(name, f"oryx.tenancy.tenants.{tenant_id}.{k}")
        return cls(
            tenant_id=tenant_id,
            app=block.get("app", "probe"),
            weight=float(block.get("weight", 1.0)),
            quota_qps=_opt_float(block.get("quota-qps", None)),
            slo_p99_ms=float(slo.get("p99-ms", 500.0)),
            slo_error_rate=float(slo.get("error-rate", 0.0)),
            slo_min_full_quality=_opt_float(slo.get("min-full-quality", None)),
            input_topic=block.get("input-topic", None),
            update_topic=block.get("update-topic", None),
            registry_root=block.get("registry-root", None),
            overrides=overrides,
            config_overlay=block.get("config", None) or {},
        )

    def wiring(self, key: str) -> str | None:
        """The class/module wiring for this tenant, override-aware."""
        return self.overrides.get(key) or APP_WIRING[self.app][key]

    def resource_modules(self) -> list[str]:
        return list(APP_WIRING[self.app]["resources"])


def _opt_float(v) -> float | None:
    return None if v is None else float(v)


class TenantRegistry:
    """The parsed ``oryx.tenancy`` block: ordered tenant specs + knobs."""

    def __init__(
        self,
        specs: dict[str, TenantSpec],
        default_tenant: str | None = None,
        fair_share: bool = True,
        quantum: float = 8.0,
    ) -> None:
        self.specs = dict(specs)
        if default_tenant is not None and default_tenant not in self.specs:
            raise ValueError(
                f"oryx.tenancy.default-tenant {default_tenant!r} is not a "
                f"declared tenant"
            )
        self.default_tenant = default_tenant
        self.fair_share = fair_share
        self.quantum = quantum

    @classmethod
    def from_config(cls, config: Config) -> "TenantRegistry | None":
        """The registry, or None when tenancy is disabled/undeclared."""
        if not (config.get("oryx.tenancy.enabled", None) or False):
            return None
        tenants = config.get("oryx.tenancy.tenants", None) or {}
        specs = {
            tid: TenantSpec.from_config(
                tid, config.get_config(f"oryx.tenancy.tenants.{tid}")
            )
            for tid in sorted(tenants)
        }
        if not specs:
            return None
        fair = config.get("oryx.tenancy.fair-share", None) or {}
        return cls(
            specs,
            default_tenant=config.get("oryx.tenancy.default-tenant", None),
            fair_share=bool(fair.get("enabled", True)),
            quantum=float(fair.get("quantum", 8.0)),
        )

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs.values())

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self.specs

    def ids(self) -> list[str]:
        return list(self.specs)

    def get(self, tenant_id: str) -> TenantSpec | None:
        return self.specs.get(tenant_id)

    def require(self, tenant_id: str) -> TenantSpec:
        spec = self.specs.get(tenant_id)
        if spec is None:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        return spec

    def weights(self) -> dict[str, float]:
        return {tid: s.weight for tid, s in self.specs.items()}

    def resource_modules(self) -> list[str]:
        """Union of every tenant's app resource modules, declaration
        order, deduplicated — one serving router hosts all tenants."""
        seen: list[str] = []
        for spec in self.specs.values():
            for mod in spec.resource_modules():
                if mod not in seen:
                    seen.append(mod)
        return seen


def tenant_config(base: Config, spec: TenantSpec) -> Config:
    """One tenant's private view of the base config.

    Namespaces the shared identities — input/update topic names, batch
    data/model dirs, the serving restage cache, ``oryx.id`` (and with it
    the consumer-group / offset-ledger identity) — and wires the
    tenant's app classes in. Brokers, compute knobs, SLO budgets and
    everything else inherit from the base unless the tenant block
    overrode them.
    """
    tid = spec.tenant_id
    base_id = base.get("oryx.id", None)
    overlay: dict = {
        "oryx": {
            "id": f"{base_id}-{tid}" if base_id else tid,
            "input-topic": {
                "message": {
                    "topic": spec.input_topic
                    or namespaced(
                        base.get_string("oryx.input-topic.message.topic"), tid
                    )
                }
            },
            "batch": {
                "storage": {
                    "data-dir": _subdir(
                        base.get_string("oryx.batch.storage.data-dir"), tid
                    ),
                    "model-dir": spec.registry_root
                    or _subdir(
                        base.get_string("oryx.batch.storage.model-dir"), tid
                    ),
                },
            },
        }
    }
    update_topic = base.get("oryx.update-topic.message.topic", None)
    if spec.update_topic or update_topic:
        overlay["oryx"]["update-topic"] = {
            "message": {"topic": spec.update_topic or namespaced(update_topic, tid)}
        }
    update_class = spec.wiring("update-class")
    if update_class:
        overlay["oryx"]["batch"]["update-class"] = update_class
    speed_manager = spec.wiring("speed-manager")
    if speed_manager:
        overlay["oryx"]["speed"] = {"model-manager-class": speed_manager}
    serving_manager = spec.wiring("serving-manager")
    if serving_manager:
        overlay["oryx"]["serving"] = {
            "model-manager-class": serving_manager,
            "application-resources": spec.resource_modules(),
        }
    restage_dir = base.get("oryx.serving.restage-dir", None)
    if restage_dir:
        overlay["oryx"].setdefault("serving", {})["restage-dir"] = _subdir(
            restage_dir, tid
        )
    cfg = base.with_overlay(overlay)
    if spec.config_overlay:
        # tenant-declared config block wins over everything derived: this
        # is how tenants with different input schemas or hyperparameters
        # coexist on one base config
        cfg = cfg.with_overlay(spec.config_overlay)
    return cfg


def _subdir(path: str, tenant_id: str) -> str:
    return f"{path.rstrip('/')}/{tenant_id}"
