"""The port's lock-order watchdog around the port's marked tests.

``test_torch_fleet.py`` and ``test_torch_loadgen.py`` import
``_port_lock_watchdog`` by name, which makes it an autouse fixture of
theirs; the shared conftest arms only the JAX package's watchdog."""

from __future__ import annotations

import os

import pytest

from oryx_tpu_torch.common import locks as port_locks

# the markers and acquire budget the shared conftest gives the JAX package's
# watchdog, so that both watchdogs hold a case to the same settings
MARKERS = frozenset({"chaos", "fleet", "pipeline"})
ACQUIRE_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def _port_lock_watchdog(request):
    """The port's lock-order watchdog (oryx_tpu_torch/common/locks.py)
    around each fleet, chaos or pipeline case. The shared conftest arms the
    JAX package's around the same cases first: the port's arms on top, so
    the locks a case makes are the port's, tracked in the port's graph
    under package-qualified keys. A cycle raises in the acquiring thread;
    the case fails on any violation. ORYX_LOCK_WATCHDOG=0 turns both off."""
    if not (MARKERS & {m.name for m in request.node.iter_markers()}) or (
        os.environ.get("ORYX_LOCK_WATCHDOG", "1") == "0"
    ):
        yield
        return
    port_locks.instrument(strict=True, acquire_timeout=ACQUIRE_TIMEOUT_S)
    try:
        yield
        found = port_locks.violations()
    finally:
        port_locks.deinstrument()
        port_locks.reset()
    assert not found, f"the port's lock watchdog recorded violations: {found}"
