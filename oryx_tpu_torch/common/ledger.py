"""Runtime resource ledger: live-resource accounting via weakrefs.

The dynamic half of the static lifecycle pass (oryx_tpu_torch/analysis/
lifecycle.py, ORX501-ORX506): every long-lived resource the framework
acquires — supervised threads, bus consumers, shm rings, device-resident
fold-in sessions — registers itself here at construction. The ledger
holds only weak references, so registration never extends a lifetime;
a resource leaves the ledger either when it is garbage-collected or
when its liveness probe reports it released (closed flag set, thread
finished).

Consumers of the ledger:

- ``/metrics``: :func:`refresh` publishes ``resources.<kind>.live``
  gauges into the process metrics registry, so operators can watch a
  replica's thread/consumer/ring population stay flat across weeks of
  rotations — the production-facing leak alarm.
- tests: the autouse ``_resource_ledger`` fixture (tests/conftest.py)
  snapshots the ledger around every chaos/fleet/pipeline test and
  asserts the suite's teardown released everything it acquired — the
  dynamic oracle that validates the static pass, exactly as the
  lock-order watchdog validates ORX201.

Registration is on by default and costs one weakref + one dict insert
per resource acquisition (never on a per-event path); set
``ORYX_RESOURCE_LEDGER=0`` to compile it out at import time.

Probes take the object and return True while the resource is still
held (``live(obj) -> bool``). They must not capture the object in a
closure — the ledger passes the dereferenced weakref — or the ledger
itself would keep the resource alive. A resource registered without a
probe counts as live for as long as it is strongly referenced; that is
the right semantic for GC-released resources like fold-in sessions.

Port note: a copy of ``oryx_tpu/common/ledger.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Callable

__all__ = ["ResourceLedger", "enabled", "ledger", "register"]


def enabled() -> bool:
    return os.environ.get("ORYX_RESOURCE_LEDGER", "1") != "0"


class ResourceLedger:
    """Weakref ledger of acquired-but-not-yet-released resources."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0
        # id -> (kind, weakref, probe|None)
        self._entries: dict[int, tuple[str, weakref.ref, Callable | None]] = {}

    def register(self, kind: str, obj, live: Callable | None = None) -> None:
        """Track ``obj`` under ``kind``. ``live(obj)`` (optional) reports
        whether the resource is still held; without it the resource is
        live while strongly referenced."""
        with self._lock:
            key = self._next
            self._next += 1
            try:
                ref = weakref.ref(obj, lambda _r, k=key: self._drop(k))
            except TypeError:
                return  # objects without weakref support are not tracked
            self._entries[key] = (kind, ref, live)

    def _drop(self, key: int) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def counts(self) -> dict[str, int]:
        """Live resources per kind. Entries whose probe reports released
        are pruned as a side effect, so repeated calls stay cheap."""
        with self._lock:
            entries = list(self._entries.items())
        out: dict[str, int] = {}
        dead: list[int] = []
        for key, (kind, ref, live) in entries:
            obj = ref()
            if obj is None:
                dead.append(key)
                continue
            try:
                if live is not None and not live(obj):
                    dead.append(key)
                    continue
            except Exception:
                dead.append(key)  # probe raised: the object is torn down
                continue
            out[kind] = out.get(kind, 0) + 1
        if dead:
            with self._lock:
                for key in dead:
                    self._entries.pop(key, None)
        return out

    def live(self, kind: str | None = None) -> int:
        c = self.counts()
        return sum(c.values()) if kind is None else c.get(kind, 0)

    def snapshot(self) -> dict[str, int]:
        return self.counts()

    def refresh(self) -> dict[str, int]:
        """Publish ``resources.<kind>.live`` gauges into the process
        metrics registry (and zero gauges for kinds that emptied since
        the last refresh). Returns the counts."""
        from oryx_tpu_torch.common import metrics

        counts = self.counts()
        known = getattr(self, "_gauge_kinds", set())
        for kind in known - set(counts):
            metrics.registry.gauge(f"resources.{kind}.live").set(0)
        for kind, n in counts.items():
            metrics.registry.gauge(f"resources.{kind}.live").set(n)
        self._gauge_kinds = known | set(counts)
        return counts


ledger = ResourceLedger()
"""Process-global ledger (each layer is its own process)."""


def register(kind: str, obj, live: Callable | None = None) -> None:
    """Module-level convenience: no-op when ORYX_RESOURCE_LEDGER=0."""
    if enabled():
        ledger.register(kind, obj, live)
