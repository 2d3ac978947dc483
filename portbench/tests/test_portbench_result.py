"""The result line, and the check that a run loaded nothing of JAX."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from portbench import harness, run
from portbench.tests.conftest import tiny_cell

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def test_result_line_keys_and_the_check_comes_last():
    line = harness.result_line(True, 3, 0, {"m": {"value": 1.0, "unit": "s"}},
                               {"platform": "gpu"}, {"gap": {"value": 0.1, "limit": 1.0}},
                               {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == [*REQUIRED, "breakdown", "check"]


@pytest.mark.parametrize("modules, found", [
    ({"oryx_tpu_torch": 1, "oryx_tpu_torch.ops": 1, "jaxtyping": 1, "flaxen": 1}, []),
    ({"jax": 1, "jax.numpy": 1}, ["jax", "jax.numpy"]),
    ({"oryx_tpu.ops.als": 1, "jaxlib.xla": 1, "flax": 1}, ["flax", "jaxlib.xla", "oryx_tpu.ops.als"]),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert harness.forbidden_loaded(modules) == found


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", object())
    cell = tiny_cell("als-ml25m-train")
    assert run.report(cell, {"numbers": {}}, False, device_kind="cpu") == 1
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


@pytest.mark.parametrize("trace", [0, 1])
def test_a_training_run_prints_the_contracts_last_line(on_cpu, capsys, trace):
    from portbench.drivers import als_train

    cell = tiny_cell("als-ml25m-train")
    out = als_train.run(cell, 2**31 + 5, 0.5, bool(trace), time.time(), device="cpu")
    assert run.report(cell, out, bool(trace), device_kind="cpu") == 0
    captured = capsys.readouterr()
    last = json.loads(captured.out.strip().splitlines()[-1])
    assert all(k in last for k in REQUIRED) and list(last)[-1] == "check"
    assert last["correct"] is True
    assert set(last["check"]) == set(cell.limits)
    assert captured.err.strip().splitlines()[-len(cell.limits):] == harness.check_lines(
        last["check"])
    if trace:
        assert {"train_mfu", "pack_s"} <= set(last["metrics"])
        assert {"busy_s", "window_s"} <= set(last["device"])
    else:
        assert set(last["metrics"]) == {"train_ratings_per_s", "setup_s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_serving_run_prints_the_contracts_last_line(on_cpu, capsys, trace):
    from portbench.drivers import als_serve

    cell = tiny_cell("als-lb5m-closed3")
    out = als_serve.run(cell, 2**31 + 6, 1.0, bool(trace), time.time(), device="cpu")
    assert run.report(cell, out, bool(trace), device_kind="cpu") == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"] is True and last["attempted"] > 0 and last["failed"] >= 0
    if trace:
        assert {"request_self_ms", "queue_wait_ms", "serve_mfu"} <= set(last["metrics"])
    else:
        assert set(last["metrics"]) == {"recommend_rps", "setup_s"}
        assert last["metrics"]["recommend_rps"]["value"] > 0


def test_runs_of_both_drivers_load_nothing_of_jax():
    script = (
        "import sys, time\n"
        "from oryx_tpu_torch.device import set_device\n"
        "set_device('cpu')\n"
        "from portbench import harness\n"
        "from portbench.drivers import als_train, als_serve\n"
        "from portbench.tests.conftest import tiny_cell\n"
        "als_train.run(tiny_cell('als-ml25m-train'), 1, 0.2, True, time.time(), device='cpu')\n"
        "als_serve.run(tiny_cell('als-lb5m-closed3'), 2, 0.5, True, time.time(), device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=harness.ROOT.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops, bad = out.stdout.strip().splitlines()[-2:]
    assert "oryx_tpu_torch" in tops and "torch" in tops
    assert bad == "[]"
