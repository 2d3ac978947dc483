"""The control: the program with its own lower-precision path switched on
(bfloat16 Gramian operands for training, a bfloat16 item plane for
serving), at the cell's own size, has to come out not correct. On the
card only; each case prints the numbers it read."""

from __future__ import annotations

import importlib
import time

import pytest

from portbench import harness, run

CONTROLS = {
    "als-ml25m-train": ({"oryx.batch.compute.matmul-dtype": "bfloat16"}, 1.0),
    "als-lb5m-closed3": ({"oryx.als.serving.score-dtype": "bfloat16"}, 3.0),
}
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_the_lower_precision_control_is_not_correct(card, capsys, name, seed):
    cell = harness.load_cell(name)
    cell.traffic["warmup_s"] = 1.0  # warming the request path moves no answer
    overrides, seconds = CONTROLS[name]
    driver = importlib.import_module(f"portbench.drivers.{cell.kind}")
    out = driver.run(cell, seed, seconds, False, time.time(), overrides=overrides)
    assert run.report(cell, out, False) == 0
    captured = capsys.readouterr()
    with capsys.disabled():
        print(f"\ncontrol {name} seed {seed}: {out['numbers']}")
    assert '"correct": false' in captured.out.splitlines()[-1]
