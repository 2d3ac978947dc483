"""N tenants' batch/speed pipelines in one process.

The classic deployment runs one ``BatchLayer`` (or ``SpeedLayer``) per
process; :class:`TenantPipelines` runs one per *tenant* instead, each
constructed from the tenant's namespaced view of the shared config
(:func:`oryx_tpu_torch.tenancy.spec.tenant_config`) — private input/update
topics, private data/model dirs, the tenant's own update class — so
every tenant keeps its own MLUpdate lineage, generation numbering,
offset-ledger identity and crash/repair invariants while sharing the
process, the bus brokers and the accelerator.

Per-tenant progress is visible as ``batch.generations.tenant.<tenant>``
and ``speed.updates.tenant.<tenant>`` counters, and each layer object is
registered on the resource ledger under its tenant id.

Port note: a copy of ``oryx_tpu/tenancy/pipelines.py``, with its imports
pointed at ``oryx_tpu_torch``: each tenant's layer is the port's, so the
tenants train on the card (ALS's solves, k-means's Lloyd sweep kernel,
the forest's histograms) one after another in :meth:`run_round`.
"""

from __future__ import annotations

import logging

from oryx_tpu_torch.common import ledger, metrics
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.tenancy.spec import TenantRegistry, TenantSpec, tenant_config

log = logging.getLogger(__name__)


class TenantPipelines:
    """Per-tenant batch and/or speed layers over one shared base config.

    ``kind`` selects which layer each tenant runs ("batch" or "speed");
    tenants whose app declares no update/speed class (the probe app) are
    skipped — they are serving-only tenants. Layers are built lazily in
    :meth:`start` so a config error in one tenant surfaces before any
    other tenant's layer spun up threads.
    """

    def __init__(self, base: Config, tenants: TenantRegistry, kind: str) -> None:
        if kind not in ("batch", "speed"):
            raise ValueError(f"kind must be 'batch' or 'speed', got {kind!r}")
        self.base = base
        self.tenants = tenants
        self.kind = kind
        self.layers: dict[str, object] = {}
        self._closed = False

    # -- lifecycle --

    def _wired(self, spec: TenantSpec) -> bool:
        key = "update-class" if self.kind == "batch" else "speed-manager"
        return spec.wiring(key) is not None

    def start(self) -> None:
        for spec in self.tenants:
            if not self._wired(spec):
                log.info(
                    "tenant %s: app %r has no %s pipeline; skipping",
                    spec.tenant_id,
                    spec.app,
                    self.kind,
                )
                continue
            tcfg = tenant_config(self.base, spec)
            layer = self._build(tcfg)
            self.layers[spec.tenant_id] = layer
            ledger.register(f"tenant-{self.kind}", layer, live=_layer_live)
        for tid, layer in self.layers.items():
            if self.kind == "batch":
                layer.prepare()
            else:
                layer.prepare_input()
            log.info("tenant %s: %s layer ready", tid, self.kind)

    def _build(self, tcfg: Config):
        if self.kind == "batch":
            from oryx_tpu_torch.lambda_.batch import BatchLayer

            return BatchLayer(tcfg)
        from oryx_tpu_torch.lambda_.speed import SpeedLayer

        return SpeedLayer(tcfg)

    # -- driving --

    def run_round(self) -> dict[str, int]:
        """One unit of work per tenant, round-robin: a batch generation
        (``run_one_generation``) or a speed micro-batch
        (``run_one_batch``). Returns tenant id -> work count this round
        (generations are always 1; a speed round reports records
        consumed). A tenant's failure propagates — the caller decides
        whether to retry or fail the round; other tenants' state is
        untouched because nothing is shared below the broker."""
        done: dict[str, int] = {}
        for tid, layer in self.layers.items():
            if self.kind == "batch":
                layer.run_one_generation()
                done[tid] = 1
                metrics.registry.counter(
                    f"batch.generations.tenant.{tid}"
                ).inc()
            else:
                n = layer.run_one_batch()
                done[tid] = n
                if n:
                    metrics.registry.counter(
                        f"speed.updates.tenant.{tid}"
                    ).inc()
        return done

    def generation_counts(self) -> dict[str, int]:
        """tenant id -> generations (batch) or micro-batches (speed)."""
        attr = "generation_count" if self.kind == "batch" else "batch_count"
        return {tid: getattr(l, attr) for tid, l in self.layers.items()}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        errors = []
        for tid, layer in self.layers.items():
            try:
                layer.close()
            except Exception as e:  # close every tenant before raising
                errors.append((tid, e))
        if errors:
            tid, e = errors[0]
            raise RuntimeError(f"closing tenant {tid} {self.kind} layer") from e

    def __enter__(self) -> "TenantPipelines":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _layer_live(layer) -> bool:
    return not getattr(layer, "_closed", False)
