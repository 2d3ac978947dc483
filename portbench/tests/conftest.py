"""Shared fixtures of the benchmark's tests. Tests that need a CUDA card
carry the ``card`` marker and take the ``card`` fixture, which skips them
where there is none; run them on the card with

    python3 -m pytest portbench/tests -m card -s
"""

from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def on_cpu():
    """The port's entry points on the CPU for the test, its brokers reset."""
    from oryx_tpu_torch.bus.inproc import InProcessBroker
    from oryx_tpu_torch.device import set_device

    set_device("cpu")
    InProcessBroker.reset_all()
    yield "cpu"
    InProcessBroker.reset_all()
    set_device(None)


def tiny_cell(name: str):
    """The cell ``name`` at a size the CPU runs in seconds: the same code,
    fewer rows and narrower factors."""
    from portbench import harness

    cell = harness.load_cell(name)
    if cell.kind == "als_train":
        cell.config.update(users=1500, items=400, ratings=15000)
        cell.config["oryx"]["oryx.als.hyperparams.features"] = 16
    else:
        cell.config.update(users=2000, items=10000, features=32)
        cell.traffic.update(warmup_s=0.5, compare_sample=64)
    return cell
