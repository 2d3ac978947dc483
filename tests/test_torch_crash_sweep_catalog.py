"""The port's kill-point catalog and crashpoint primitive, and the sweep's
harness around its workers: the catalog equal to the JAX package's and
to the port's own ``crashpoint("…")`` calls, the primitive's unit tests
(tests/chaos/test_crashpoints.py's) over both packages' modules, the
harness's device rule and report, and one worker pass in an interpreter
where importing jax or the JAX package fails."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from oryx_tpu.common import crashpoints as ref_crashpoints
from oryx_tpu_torch.common import crashpoints as port_crashpoints
from oryx_tpu_torch.tools import crash_sweep as port_sweep
from torch_crash_sweep import PARITY_SITES, _port_on_cpu  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
LAYERS = {"bus", "storage", "registry", "batch", "speed", "serving"}

pytestmark = pytest.mark.chaos


# -- the catalog --------------------------------------------------------------


def test_catalog_equals_the_jax_packages() -> None:
    assert port_crashpoints.CATALOG == ref_crashpoints.CATALOG
    assert list(port_crashpoints.CATALOG) == list(ref_crashpoints.CATALOG)
    for layer in LAYERS:
        assert port_crashpoints.sites(layer) == ref_crashpoints.sites(layer), layer
    assert port_crashpoints.KILL_EXIT_CODE == ref_crashpoints.KILL_EXIT_CODE
    assert port_crashpoints.ENV_VAR == ref_crashpoints.ENV_VAR


def test_catalog_matches_instrumented_sites() -> None:
    """Every crashpoint() call site under oryx_tpu_torch/ is declared in
    the port's CATALOG and vice versa: the sweep exercises exactly what
    the port marks, with no orphans on either side."""
    pattern = re.compile(r"""crashpoint\(\s*["']([a-z0-9_.-]+)["']\s*\)""")
    in_code: set[str] = set()
    for path in (ROOT / "oryx_tpu_torch").rglob("*.py"):
        in_code.update(pattern.findall(path.read_text()))
    declared = set(port_crashpoints.CATALOG)
    assert in_code == declared, (
        f"catalog drift: instrumented-but-undeclared={sorted(in_code - declared)} "
        f"declared-but-uninstrumented={sorted(declared - in_code)}"
    )


def test_catalog_entries_are_well_formed() -> None:
    for site, (layer, what) in port_crashpoints.CATALOG.items():
        assert re.fullmatch(r"[a-z0-9_]+(\.[a-z0-9_-]+)+", site), site
        assert layer in LAYERS, (site, layer)
        assert what.strip(), site
    assert port_crashpoints.sites() == sorted(port_crashpoints.CATALOG)
    assert set(port_crashpoints.sites("bus")) == {
        s for s, (lyr, _) in port_crashpoints.CATALOG.items() if lyr == "bus"
    }


def test_chip_smoke_sweeps_one_parity_site_of_each_layer() -> None:
    import chip_smoke

    assert chip_smoke.CRASH_SWEEP_SITES == tuple(PARITY_SITES.values())
    assert set(PARITY_SITES) == LAYERS
    for layer, site in PARITY_SITES.items():
        assert port_crashpoints.CATALOG[site][0] == layer, site


# -- the primitive, over both packages' modules --------------------------------


@pytest.fixture(params=[ref_crashpoints, port_crashpoints], ids=["oryx_tpu", "oryx_tpu_torch"])
def crashpoints(request):
    module = request.param
    module.reset()
    yield module
    module.reset()


def test_disarmed_is_a_noop(crashpoints) -> None:
    assert crashpoints.armed_site() is None
    for site in crashpoints.CATALOG:
        crashpoints.crashpoint(site)  # must not raise, must not count
        assert crashpoints.hits(site) == 0


def test_raise_action_fires_on_nth_visit(crashpoints) -> None:
    crashpoints.arm("storage.commit.pre", nth=3, action="raise")
    crashpoints.crashpoint("storage.commit.pre")
    crashpoints.crashpoint("storage.commit.pre")
    with pytest.raises(crashpoints.CrashPointReached) as exc:
        crashpoints.crashpoint("storage.commit.pre")
    assert exc.value.site == "storage.commit.pre"
    assert crashpoints.hits("storage.commit.pre") == 3


def test_only_the_armed_site_counts(crashpoints) -> None:
    crashpoints.arm("bus.file.append.pre", action="raise")
    crashpoints.crashpoint("bus.file.append.post")
    crashpoints.crashpoint("storage.commit.pre")
    assert crashpoints.hits("bus.file.append.post") == 0
    with pytest.raises(crashpoints.CrashPointReached):
        crashpoints.crashpoint("bus.file.append.pre")


def test_crashpoint_reached_is_not_an_exception_subclass(crashpoints) -> None:
    # `except Exception` recovery paths must never swallow a simulated
    # death, or the drill would test the wrong recovery code
    assert not issubclass(crashpoints.CrashPointReached, Exception)
    assert issubclass(crashpoints.CrashPointReached, BaseException)


def test_arm_rejects_unknown_action(crashpoints) -> None:
    with pytest.raises(ValueError):
        crashpoints.arm("storage.commit.pre", action="explode")


def test_arm_from_env_parses_site_and_nth(crashpoints) -> None:
    site = crashpoints.arm_from_env({"ORYX_CRASHPOINT": "speed.commit.pre:4"})
    assert site == "speed.commit.pre"
    assert crashpoints.armed_site() == "speed.commit.pre"
    crashpoints.reset()
    assert crashpoints.arm_from_env({}) is None
    assert crashpoints.armed_site() is None
    with pytest.raises(ValueError):
        crashpoints.arm_from_env({"ORYX_CRASHPOINT": ":3"})


def test_reset_disarms_and_clears_counts(crashpoints) -> None:
    crashpoints.arm("ml.promote.mid", nth=99, action="raise")
    crashpoints.crashpoint("ml.promote.mid")
    assert crashpoints.hits("ml.promote.mid") == 1
    crashpoints.reset()
    assert crashpoints.armed_site() is None
    assert crashpoints.hits("ml.promote.mid") == 0


# -- the harness --------------------------------------------------------------


def test_sweep_raises_without_cuda_before_any_worker(monkeypatch, tmp_path) -> None:
    """Without CUDA and without --device cpu the harness stops with the
    port's "no CUDA device" error before it starts a worker: it never
    runs on the CPU unasked."""
    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_sweep.subprocess, "run", lambda *a, **kw: started.append(a))
    port_sweep.port_device.set_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        port_sweep.main(["--site", "storage.commit.pre", "--base-dir", str(tmp_path)])
    assert started == []
    assert not (tmp_path / "storage_commit_pre").exists()


@pytest.mark.parametrize("writes_bytecode", [True, False])
def test_workers_share_a_bytecode_cache_only_where_none_is_written(
    monkeypatch, tmp_path, writes_bytecode
) -> None:
    """Where the harness's process writes no bytecode (the card's host
    sets PYTHONDONTWRITEBYTECODE=1), its workers share a bytecode cache
    beside their workdirs; elsewhere they keep the interpreter's own."""
    calls = []
    monkeypatch.setattr(port_sweep.sys, "dont_write_bytecode", not writes_bytecode)
    monkeypatch.delenv("PYTHONPYCACHEPREFIX", raising=False)
    if not writes_bytecode:
        monkeypatch.setenv("PYTHONDONTWRITEBYTECODE", "1")
    monkeypatch.setattr(port_sweep.subprocess, "run", lambda cmd, **kw: calls.append((cmd, kw)))
    port_sweep._run_worker(tmp_path / "wd", site="storage.commit.pre")
    ((cmd, kw),) = calls
    assert cmd[-4:] == ["--worker", str(tmp_path / "wd"), "--device", "cpu"]
    assert kw["env"]["ORYX_CRASHPOINT"] == "storage.commit.pre:1"
    if writes_bytecode:
        assert "PYTHONPYCACHEPREFIX" not in kw["env"]
    else:
        assert kw["env"]["PYTHONPYCACHEPREFIX"] == str(tmp_path / ".pycache")
        assert "PYTHONDONTWRITEBYTECODE" not in kw["env"]


def test_main_reports_one_site_on_the_cpu(tmp_path, capsys) -> None:
    rc = port_sweep.main(["--site", "storage.commit.pre", "--base-dir", str(tmp_path),
                          "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0, report
    assert (report["sites"], report["passed"], report["failed"]) == (1, 1, [])
    (result,) = report["results"]
    assert result["site"] == "storage.commit.pre" and result["kill_exit"] == -9
    assert result["recovered"] and result["violations"] == []
    # the killed run died inside its nonce's commit, before its first ack:
    # the recovery's pass is run 1, whole
    acks = (tmp_path / "storage_commit_pre" / "acks.log").read_text().splitlines()
    assert acks[0] == "nonce:1" and acks[-1] == "staged:100001"


# One worker pass in a fresh interpreter where importing jax or any
# oryx_tpu module (other than oryx_tpu_torch) fails, then the audit.
_ISOLATED = textwrap.dedent(
    r"""
    import importlib.abc, sys

    sys.modules["jax"] = None

    class _RefuseJaxPackage(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "oryx_tpu" or name.startswith("oryx_tpu."):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, _RefuseJaxPackage())

    from oryx_tpu_torch.tools import crash_sweep

    workdir = sys.argv[1]
    assert crash_sweep.main(["--worker", workdir, "--device", "cpu"]) == 0
    assert crash_sweep.check_invariants(workdir) == []
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "oryx_tpu"
                    or m.startswith("oryx_tpu."))
    assert leaked == ["jax"], leaked  # only the None placeholder
    print("ISOLATED-OK")
    """
)


def test_worker_runs_without_jax_or_the_jax_package(tmp_path) -> None:
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATED, str(tmp_path / "wd")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "ISOLATED-OK" in out.stdout
    acks = (tmp_path / "wd" / "acks.log").read_text().splitlines()
    assert acks[0] == "nonce:1" and acks[-1] == "staged:100001", acks
