"""The port's oryxlint (``oryx_tpu_torch/analysis``) against the JAX
package's (``oryx_tpu/analysis``), on the CPU.

- Parity: the lockset, lockorder, lifecycle and durability passes are
  the JAX package's rule for rule. Each runs under both packages over
  every seeded fixture of tests/analysis/fixtures/ (read, never
  edited) and over the port's tree; the findings' (code, symbol, line,
  message) must be equal.
- Seeded fixtures, written inline into tmp_path, for what the port has
  of its own or checks against its own surfaces: ``torchhot`` (one
  finding per rule, and a clean file), the config-keys, deploy,
  metrics and registry passes, and the runner (baseline round trip,
  stale-entry scoping, ``--update-baseline``, ``--select`` /
  ``--ignore``, parse errors), as tests/analysis/test_passes.py holds
  the JAX package's. A deliberately unknown key is built at run time:
  the JAX package's own config-keys pass scans tests/ too.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import pytest

from oryx_tpu.analysis import core as ref_core
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.analysis import core, load_baseline, main, run_passes, write_baseline
from oryx_tpu_torch.analysis import configkeys, deploymanifests, metricscatalog
from oryx_tpu_torch.analysis import registryhygiene

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "analysis" / "fixtures"
PARITY_PASSES = ("lockset", "lockorder", "lifecycle", "durability")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)


def _rows(res) -> list[tuple]:
    return sorted((f.code, f.symbol, f.line, f.message) for f in res.findings)


# -- parity with the JAX package's passes ------------------------------------------


@pytest.mark.parametrize("pass_id", PARITY_PASSES)
@pytest.mark.parametrize("fixture", sorted(p.name for p in FIXTURES.glob("*.py")))
def test_pass_matches_the_jax_package_on_its_fixtures(tmp_path, fixture, pass_id):
    dst = tmp_path / fixture
    shutil.copyfile(FIXTURES / fixture, dst)
    ref = ref_core.run_passes([dst], select={pass_id}, baseline=None)
    port = run_passes([dst], select={pass_id}, baseline=None)
    assert _rows(port) == _rows(ref)


# what each pass finds in the port's tree before the baseline
TREE_FINDINGS = {"lockset": 1, "lockorder": 0, "lifecycle": 0, "durability": 8}


@pytest.mark.parametrize("pass_id", PARITY_PASSES)
def test_pass_matches_the_jax_package_on_the_ports_tree(pass_id):
    ref = ref_core.run_passes([ROOT / "oryx_tpu_torch"], select={pass_id}, baseline=None)
    port = run_passes(select={pass_id}, baseline=None)
    assert _rows(port) == _rows(ref)
    assert len(port.findings) == TREE_FINDINGS[pass_id], _rows(port)


# -- torchhot ---------------------------------------------------------------------

TORCH_BAD = '''
import ctypes

import torch

from oryx_tpu_torch.native import get_library
from oryx_tpu_torch.ops import _build


def load_each(names):
    libs = []
    for n in names:
        libs.append(_build.load(n))
    return libs


def poll_native(rounds):
    while rounds:
        get_library()
        rounds -= 1


def compile_per_call(fn):
    return torch.compile(fn)


def open_per_call(path):
    return ctypes.CDLL(path)


def pull_each(xs):
    total = 0.0
    for x in xs:
        total += x.sum().item()
    return total


def best_scores(q, y, steps):
    acc = 0.0
    for _ in range(steps):
        s = torch.matmul(q, y)
        best = s.max()
        acc += float(best)
    return acc


class Timer:
    def wait_all(self, events):
        for ev in events:
            ev.synchronize()
'''

TORCH_CLEAN = '''
import ctypes
import functools

import numpy as np
import torch

from oryx_tpu_torch.ops import _build

_LIBS: dict = {}
_handle = None


@functools.lru_cache(maxsize=None)
def compiled(fn):
    return torch.compile(fn)


def load_lib(path):
    lib = _LIBS.get(path)
    if lib is None:
        lib = _LIBS[path] = ctypes.CDLL(path)
    return lib


def scan_handle():
    global _handle
    if _handle is None:
        _handle = ctypes.CDLL("libscan.so")
    return _handle


class Scanner:
    def __init__(self):
        self.lib = _build.load("topn")

    def run(self, q, y, steps):
        s = torch.matmul(q, y)
        out = []
        for _ in range(steps):
            out.append(s)
        firsts = [float(v) for v in s]  # a comprehension is not a hot loop
        return out, firsts, s.cpu().numpy()  # one pull, after the loop


def host_total(rows):
    total = 0
    for r in rows:
        total += int(r)  # not a tensor this function made
    return total


def host_columns(block):
    return [np.asarray(c) for c in block]
'''


def _write(tmp_path, name, text) -> Path:
    path = tmp_path / name
    path.write_text(text, encoding="utf-8")
    return path


def test_torchhot_flags_each_rule(tmp_path):
    found = run_passes([_write(tmp_path, "hot.py", TORCH_BAD)], select={"torchhot"},
                       baseline=None).findings
    got = sorted((f.code, f.symbol) for f in found)
    assert got == [
        ("ORX301", "load_each"),
        ("ORX301", "poll_native"),
        ("ORX302", "Timer.wait_all:synchronize"),
        ("ORX302", "best_scores:best"),
        ("ORX302", "pull_each:item"),
        ("ORX303", "compile_per_call"),
        ("ORX303", "open_per_call"),
    ]
    assert all(f.pass_id == "torchhot" for f in found)


def test_torchhot_accepts_the_caching_idioms(tmp_path):
    found = run_passes([_write(tmp_path, "clean.py", TORCH_CLEAN)], select={"torchhot"},
                       baseline=None).findings
    assert found == []


def test_torchhot_counts_a_call_to_a_memoized_loader_as_cached(tmp_path):
    """``_build.load`` keeps its libraries in a module dict: scanned
    together with it, a call from an uncached function is the caching
    idiom; scanned alone, the pass cannot see that and flags it."""
    caller = _write(tmp_path, "caller.py",
                    "from oryx_tpu_torch.ops import _build\n\n\n"
                    "def kernels():\n    return _build.load('topn')\n")
    alone = run_passes([caller], select={"torchhot"}, baseline=None).findings
    assert [(f.code, f.symbol) for f in alone] == [("ORX303", "kernels")]
    build = ROOT / "oryx_tpu_torch" / "ops" / "_build.py"
    together = run_passes([caller, build], select={"torchhot"}, baseline=None).findings
    assert together == []


def test_torchhot_is_quiet_on_the_jax_packages_fixtures(tmp_path):
    """The JAX package's seeded jit bugs are not torch hazards, and its
    clean fixture stays clean."""
    for name in ("jaxbad.py", "clean.py"):
        dst = tmp_path / name
        shutil.copyfile(FIXTURES / name, dst)
        assert run_passes([dst], select={"torchhot"}, baseline=None).findings == []


# -- config keys, deploy, metrics, registry --------------------------------------


def test_config_keys_reject_an_unknown_key(tmp_path):
    assert "probe-fraction" in configkeys.known_keys("oryx.serving.scan.ann")
    typo = "oryx.serving.scan.ann." + "probe-fractoin"  # built here: tests/ is scanned too
    bad = _write(tmp_path, "overlay.conf",
                 "oryx.serving.scan.ann.enabled = true\n" + typo + " = 0.02\n")
    rc, problems, _ = configkeys.run_lint([bad])
    assert rc == 1 and len(problems) == 1 and "probe-fractoin" in problems[0]
    res = run_passes([bad], select={"config-keys"}, baseline=None)
    assert [(f.code, f.symbol) for f in res.findings] == [("ORX401", "probe-fractoin")]


def test_config_keys_accept_the_ports_knobs(tmp_path):
    good = _write(tmp_path, "overlay.conf",
                  "oryx.serving.scan.ann.cells = 1000\n"
                  "oryx.bus.shm.ring-mb = 128\n"
                  "oryx.speed.pipeline.queue-depth = 4\n")
    rc, problems, _ = configkeys.run_lint([good])
    assert rc == 0, problems


def test_deploy_rejects_a_bad_manifest(tmp_path):
    bad = _write(tmp_path, "bad.yaml",
                 'args: ["serv' + 'nig", "--conf", "/etc/oryx/oryx.conf"]\n'
                 "httpGet: {path: /red" + "dy, port: 8080}\n"
                 "# reads oryx.serving.api.pr" + "ot at startup\n")
    rc, problems, _ = deploymanifests.run_lint([bad])
    assert rc == 1 and len(problems) == 3
    joined = "\n".join(problems)
    assert "not an oryx_tpu_torch CLI command" in joined
    assert "probe path" in joined
    assert "not declared in reference.conf" in joined


def test_deploy_accepts_the_ports_commands(tmp_path):
    good = _write(tmp_path, "good.yaml",
                  'args: ["serving", "--conf", "/etc/oryx/oryx.conf"]\n'
                  'command: ["lint"]\n'
                  "httpGet: {path: /readyz, port: 8080}\n"
                  "# tune oryx.serving.api.port per environment\n")
    rc, problems, _ = deploymanifests.run_lint([good])
    assert rc == 0, problems
    assert "lint" in deploymanifests.cli_commands()


def test_metrics_reads_the_ports_names():
    code_metrics, code_spans = metricscatalog.code_names()
    assert "serving.batcher.queue_depth" in code_metrics  # repaired: set beside queue.depth
    assert "serving.freshness.seconds" in code_metrics
    assert "serving.scan" in code_spans
    assert all("analysis" not in p.parts for p in code_metrics.values())


def test_metrics_flag_both_directions():
    """Without the baseline the catalog check finds exactly the port's two
    counters that no catalog names; a name only the code has is flagged."""
    rc, problems, _ = metricscatalog.run_lint()
    assert rc == 1
    assert sorted(p.split("'")[1] for p in problems) == [
        "serving.batcher.submitted.indexed", "serving.batcher.submitted.vector"]

    def with_phantom():
        names, spans = metricscatalog.code_names()
        names["phantom.metric.nobody-documented"] = metricscatalog.DOC
        return names, spans

    _, problems, _ = metricscatalog.run_lint(with_phantom)
    assert any("phantom.metric.nobody-documented" in p for p in problems)


def test_registry_fallback_catches_real_problems(tmp_path):
    bad = _write(tmp_path, "bad.py", "import os\nfrom json import *\ndef f(x=[]):\n    return x\n")
    kinds = "\n".join(registryhygiene._fallback_lint_file(bad))
    assert "wildcard import" in kinds
    assert "mutable default argument" in kinds
    assert "unused import 'os'" in kinds
    broken = _write(tmp_path, "broken.py", "def f(:\n")
    assert "syntax error" in registryhygiene._fallback_lint_file(broken)[0]
    assert registryhygiene.DEFAULT_TARGET == ROOT / "oryx_tpu_torch" / "registry"
    rc, problems, _ = registryhygiene.run_lint()
    assert rc == 0, problems


# -- the runner -------------------------------------------------------------------


def test_fixtures_dir_is_never_scanned():
    assert core.iter_py_files([FIXTURES]) == []


def test_baseline_round_trip(tmp_path):
    src = _write(tmp_path, "hot.py", TORCH_BAD)
    first = run_passes([src], select={"torchhot"}, baseline=None)
    assert first.findings
    bl = tmp_path / "baseline.txt"
    write_baseline(bl, first.findings)
    assert load_baseline(bl) == {f.key() for f in first.findings}
    assert "python -m oryx_tpu_torch.analysis --update-baseline" in bl.read_text()

    second = run_passes([src], select={"torchhot"}, baseline=bl)
    assert second.findings == [] and second.rc == 0
    assert len(second.suppressed) == len(first.findings)

    bl.write_text(bl.read_text() + "torchhot:gone.py:ORX302:ghost:item  # fixed\n")
    third = run_passes([src], select={"torchhot"}, baseline=bl)
    assert third.stale_baseline == {"torchhot:gone.py:ORX302:ghost:item"}


def test_stale_is_scoped_to_what_the_run_judged(tmp_path):
    src = _write(tmp_path, "hot.py", TORCH_BAD)
    bl = _write(tmp_path, "baseline.txt",
                # a pass that will not run, and a repo file outside the scan
                "durability:oryx_tpu_torch/ops/_build.py:ORX601:build  # kept\n"
                "torchhot:oryx_tpu_torch/ops/als.py:ORX302:mean_auc:cpu  # kept\n")
    res = run_passes([src], select={"torchhot"}, baseline=bl)
    assert res.stale_baseline == set()


def test_update_baseline_merges_instead_of_clobbering(tmp_path, capsys):
    src = _write(tmp_path, "hot.py", TORCH_BAD)
    kept = "durability:oryx_tpu_torch/ops/_build.py:ORX601:build  # why: a build cache\n"
    bl = _write(tmp_path, "baseline.txt", kept)
    rc = main(["--select", "torchhot", "--baseline", str(bl), "--update-baseline", str(src)])
    assert rc == 0
    text = bl.read_text()
    assert kept.strip() in text
    assert any(":ORX303:" in ln for ln in text.splitlines())
    again = run_passes([src], select={"torchhot"}, baseline=bl)
    assert again.findings == [] and again.rc == 0
    assert "baseline rewritten" in capsys.readouterr().out


def test_select_and_ignore_scope_passes(tmp_path):
    src = _write(tmp_path, "hot.py", TORCH_BAD)
    assert run_passes([src], select={"lockset"}, baseline=None).findings == []
    skipped = run_passes([src], ignore={"torchhot"}, baseline=None)
    assert all(f.pass_id != "torchhot" for f in skipped.findings)


def test_main_exits_1_on_a_finding_and_0_when_clean(tmp_path, capsys):
    src = _write(tmp_path, "hot.py", TORCH_BAD)
    assert main(["--select", "torchhot", "--no-baseline", str(src)]) == 1
    assert "finding(s)" in capsys.readouterr().out
    clean = _write(tmp_path, "clean.py", TORCH_CLEAN)
    assert main(["--select", "torchhot", "--no-baseline", str(clean)]) == 0
    assert "oryxlint: clean" in capsys.readouterr().out
    assert main(["--select", "torchhot", "--no-baseline", "--json", str(src)]) == 1
    assert '"rc": 1' in capsys.readouterr().out


def test_parse_error_is_a_finding(tmp_path):
    bad = _write(tmp_path, "broken.py", "def oops(:\n")
    res = run_passes([bad], select={"torchhot"}, baseline=None)
    assert [f.code for f in res.findings] == ["ORX000"]
