"""The port's kill-point sweep at the serving layer's crashpoints (the
MODEL-REF restage into the local cache): at each site a worker process
dies by SIGKILL, a second one recovers in the same directory, and the
at-least-once audit finds nothing lost
(tests/chaos/test_crash_sweep.py's case, through
``oryx_tpu_torch/tools/crash_sweep.py``). Then the JAX package's sweep
and the port's at ``serving.restage.pre-commit``, held equal."""

from __future__ import annotations

from pathlib import Path

import pytest

from oryx_tpu_torch.common import crashpoints
from torch_crash_sweep import (  # noqa: F401  (_port_on_cpu: autouse)
    PARITY_SITES,
    _port_on_cpu,
    assert_parity,
    assert_site_recovers,
)
from torch_lock_watchdog import _port_lock_watchdog  # noqa: F401  (autouse)

pytestmark = pytest.mark.chaos


@pytest.mark.parametrize("site", crashpoints.sites("serving"))
def test_kill_at_site_recovers(site: str, tmp_path: Path) -> None:
    assert_site_recovers(site, tmp_path)


def test_sweep_equals_the_jax_packages(tmp_path: Path) -> None:
    assert_parity(PARITY_SITES["serving"], tmp_path)
