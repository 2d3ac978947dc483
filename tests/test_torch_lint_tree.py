"""The port's oryxlint gate over its own tree: ``oryx_tpu_torch/`` must
be clean under every registered pass modulo the port's checked-in
baseline (oryx_tpu_torch/analysis/baseline.txt), no baseline entry may
have gone stale, and every entry says why it was accepted. The CLI's
``lint`` runs the same gate."""

from __future__ import annotations

import contextlib
import io
import subprocess
import sys
from pathlib import Path

import pytest

from oryx_tpu_torch import cli
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.analysis import DEFAULT_BASELINE, all_passes, core, load_baseline, run_passes

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)


def test_all_passes_registered():
    assert set(all_passes()) == {
        "lockset", "lockorder", "lifecycle", "durability", "torchhot",
        "config-keys", "registry", "deploy", "metrics",
    }


def test_the_gate_walks_the_port_alone():
    assert core.REPO_ROOT == ROOT
    assert core.DEFAULT_TARGETS == (ROOT / "oryx_tpu_torch",)
    assert DEFAULT_BASELINE == ROOT / "oryx_tpu_torch" / "analysis" / "baseline.txt"


def test_tree_is_clean():
    res = run_passes()
    rendered = "\n".join(f.render() for f in res.findings)
    assert not res.findings, f"oryxlint found new problems:\n{rendered}"
    assert not res.stale_baseline, (
        "baseline entries no longer fire — prune oryx_tpu_torch/analysis/"
        f"baseline.txt: {sorted(res.stale_baseline)}"
    )


def test_every_baseline_entry_says_why():
    lines = DEFAULT_BASELINE.read_text(encoding="utf-8").splitlines()
    entries = [ln for ln in lines if ln.strip() and not ln.startswith("#")]
    assert entries and len(entries) == len(load_baseline(DEFAULT_BASELINE))
    for ln in entries:
        key, _, why = ln.partition("#")
        assert key.strip().split(":")[1].startswith("oryx_tpu_torch/"), ln
        assert len(why.strip()) > 20, f"no reason given: {ln}"


def test_repaired_findings_are_not_baselined():
    """The serving layer's start() guard and the batcher's queue_depth
    gauge were repaired, not accepted."""
    keys = load_baseline(DEFAULT_BASELINE)
    assert not [k for k in keys if ":ORX505:" in k or "queue_depth" in k]


def _cli(argv) -> tuple[int, list[str]]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def test_cli_lint_runs_the_gate():
    assert "lint" in cli.COMMANDS
    assert cli.COMMANDS.index("lint") == cli.COMMANDS.index("experiments") + 1
    rc, lines = _cli(["lint"])
    assert rc == 0, lines
    assert lines[-1].startswith("oryxlint: clean (") and lines[-1].endswith(" baselined)")


def test_cli_lint_select():
    rc, lines = _cli(["lint", "--select", "lockorder,torchhot"])
    assert rc == 0 and lines[-1].startswith("oryxlint: clean ("), lines


def test_cli_lint_exits_1_on_a_finding(monkeypatch, tmp_path):
    bad = tmp_path / "hot.py"
    bad.write_text("import torch\n\n\ndef f(fn):\n    return torch.compile(fn)\n")
    monkeypatch.setattr(core, "DEFAULT_TARGETS", (bad,))
    rc, lines = _cli(["lint", "--select", "torchhot"])
    assert rc == 1
    assert any(" ORX303 [torchhot] " in ln for ln in lines)
    assert lines[-1] == "oryxlint: 1 finding(s) (0 baselined)"


def test_analysis_module_lists_its_passes():
    out = subprocess.run(
        [sys.executable, "-m", "oryx_tpu_torch.analysis", "--list-passes"],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 0, out.stderr
    listed = [ln.split()[0] for ln in out.stdout.splitlines() if ln.strip()]
    assert listed == sorted(all_passes())
    assert "jaxhot" not in listed
