"""A run with the timed path broken underneath comes out not correct: the
harness past its look for a card, at a size the CPU runs, with one fault
of each kind the cell can have planted in the program."""

from __future__ import annotations

import time

import numpy as np
import pytest

from portbench import run
from portbench.tests.conftest import tiny_cell


def _stuck(monkeypatch):
    """Every half-sweep hands back the side's factors as they were."""
    import torch

    from oryx_tpu_torch.ops import als

    held = {}

    def sweep(other, out_shape, *args, **kwargs):
        return held.setdefault(out_shape, torch.zeros((out_shape, other.shape[1])))

    monkeypatch.setattr(als, "_sweep_buckets", sweep)


def _half_left_out(monkeypatch):
    """Packing sees the first half of the ratings only."""
    from oryx_tpu_torch.ops import als

    orig = als.build_neighbor_buckets

    def pack(row_idx, col_idx, values, num_rows, *args, **kwargs):
        n = len(row_idx) // 2
        return orig(row_idx[:n], col_idx[:n], values[:n], num_rows, *args, **kwargs)

    monkeypatch.setattr(als, "build_neighbor_buckets", pack)


def _altered_solution(monkeypatch):
    """Each solved piece's first row comes out 5% long."""
    from oryx_tpu_torch.ops import als

    orig = als._solve

    def solve(a, b):
        x = orig(a, b)
        x[0] *= 1.05
        return x

    monkeypatch.setattr(als, "_solve", solve)


@pytest.mark.parametrize("fault", [_stuck, _half_left_out, _altered_solution])
def test_training_faults_come_out_not_correct(on_cpu, monkeypatch, capsys, fault):
    from portbench.drivers import als_train

    cell = tiny_cell("als-ml25m-train")
    fault(monkeypatch)
    out = als_train.run(cell, 2**31 + 11, 0.2, False, time.time(), device="cpu")
    run.report(cell, out, False, device_kind="cpu")
    assert '"correct": false' in capsys.readouterr().out.splitlines()[-1]


def _no_answer(monkeypatch):
    """The scan's selection hands back nothing."""
    from oryx_tpu_torch.app.als.serving_model import ALSServingModel

    monkeypatch.setattr(ALSServingModel, "_select_loop", staticmethod(lambda *a: []))


def _half_the_catalog(monkeypatch):
    """The scan's candidates lose every odd item row."""
    from oryx_tpu_torch.app.als.serving_model import ALSServingModel

    orig = ALSServingModel._select_loop

    def select(ids, num_candidates, score_fn, *args):
        def even(k):
            idx, scores = score_fn(2 * k)
            keep = (np.asarray(idx) % 2) == 0
            return np.asarray(idx)[keep][:k], np.asarray(scores)[keep][:k]

        return orig(ids, num_candidates, even, *args)

    monkeypatch.setattr(ALSServingModel, "_select_loop", staticmethod(select))


def _altered_score(monkeypatch):
    """Each answer's best score comes out 1% high."""
    from oryx_tpu_torch.app.als.serving_model import ALSServingModel

    orig = ALSServingModel.top_n_for_user

    def top(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        return [(out[0][0], out[0][1] * 1.01), *out[1:]] if out else out

    monkeypatch.setattr(ALSServingModel, "top_n_for_user", top)


@pytest.mark.parametrize("fault", [_no_answer, _half_the_catalog, _altered_score])
def test_serving_faults_come_out_not_correct(on_cpu, monkeypatch, capsys, fault):
    from portbench.drivers import als_serve

    cell = tiny_cell("als-lb5m-closed3")
    fault(monkeypatch)
    out = als_serve.run(cell, 2**31 + 12, 0.5, False, time.time(), device="cpu")
    run.report(cell, out, False, device_kind="cpu")
    assert '"correct": false' in capsys.readouterr().out.splitlines()[-1]
