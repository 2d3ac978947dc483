"""Shared by ``tests/test_torch_crash_sweep_*.py``: the port's kill-point
sweep (``oryx_tpu_torch/tools/crash_sweep.py``) on the CPU, one file per
catalog layer, and its parity with the JAX package's sweep
(``tools/crash_sweep.py``) at chip_smoke.py's crash-sweep sites.

Each file imports ``_port_on_cpu`` by name, which makes it an autouse
fixture of that file: the harness reads the port's device, so its
workers run with ``--device cpu``."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.registry.store import RegistryStore as PortRegistryStore
from oryx_tpu_torch.tools import crash_sweep as port_sweep

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import crash_sweep as ref_sweep  # noqa: E402  (the JAX package's sweep; tools/ is not a package)

# chip_smoke.py's CRASH_SWEEP_SITES, by catalog layer: the sites where the
# two packages' sweeps are held equal
PARITY_SITES = {
    "bus": "bus.file.roll.mid",
    "storage": "storage.commit.post",
    "registry": "registry.publish.post",
    "batch": "batch.commit.pre",
    "speed": "speed.commit.post",
    "serving": "serving.restage.pre-commit",
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)


def assert_site_recovers(site: str, tmp_path: Path) -> None:
    """The port's sweep at one site: killed, recovered, audited clean
    (tests/chaos/test_crash_sweep.py's case)."""
    res = port_sweep.sweep_site(site, tmp_path / "wd")
    assert res.ok, (
        f"kill-point {site}: kill_exit={res.kill_exit} "
        f"recovered={res.recovered} violations={res.violations} "
        f"error={res.error}"
    )
    assert res.recovery_seconds > 0.0


def _outcome(sweep_module, store_class, site: str, workdir: Path) -> dict:
    res = sweep_module.sweep_site(site, workdir)
    store = store_class(str(workdir / "model"))
    return {
        "ok": res.ok,
        "kill_exit": res.kill_exit,
        "error": res.error,
        "violations": res.violations,
        "acks": (workdir / "acks.log").read_text().splitlines(),
        "generations": store.list_generations(),
        "champion": store.champion_id(),
    }


def assert_parity(site: str, tmp_path: Path) -> None:
    """The JAX package's sweep and the port's at one site, on fresh
    workdirs: the same verdict and kill exit, acks.log equal line for
    line, the same generations and champion."""
    from oryx_tpu.registry.store import RegistryStore

    ref = _outcome(ref_sweep, RegistryStore, site, tmp_path / "oryx_tpu")
    port = _outcome(port_sweep, PortRegistryStore, site, tmp_path / "oryx_tpu_torch")
    assert ref["ok"], ref
    assert port["ok"], port
    assert port["kill_exit"] == ref["kill_exit"]
    # no known departure shows here: the port's speed micro-batch drains
    # to the topic's end where the reference's stops at an empty poll,
    # but the speed ack ("speed:<n>:<sent>") counts the wordcount
    # manager's updates, and the worker's one-token lines give it none
    assert port["acks"] == ref["acks"]
    assert port["generations"] == ref["generations"]
    assert port["champion"] == ref["champion"]
