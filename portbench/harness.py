"""What every cell shares: finding a cell, its configuration and its traffic
by name, finding the per-layer metric readers, the check that the window
loaded nothing of JAX, and the result line.

A cell is ``workloads/<cell>.json`` (its configuration, its traffic, the
chips it needs, why it exists, and the limits of its comparison). A
configuration is ``configs/<config>.json``; a traffic mix is
``traffic/mixes/<traffic>.json``, whose ``kind`` names the driver
``drivers/<kind>.py`` that runs it. A per-layer metric is
``metrics/<metric>.py``, with ``UNIT`` and ``read(artefacts)``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "oryx_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _read(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    """The cell ``name`` with its configuration and traffic mix, read from
    their files; FileNotFoundError for a name that has no file."""
    spec = _read(ROOT / "workloads" / f"{name}.json")
    return Cell(
        name=spec["name"],
        config=_read(ROOT / "configs" / f"{spec['config']}.json"),
        traffic=_read(ROOT / "traffic" / "mixes" / f"{spec['traffic']}.json"),
        chips=int(spec["chips"]),
        limits=spec["limits"],
    )


def cell_names() -> list[str]:
    return sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))


def metric_readers() -> dict:
    """Every reader under ``metrics/``, by metric name (its file's name)."""
    readers = {}
    for path in sorted((ROOT / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        readers[path.stem] = module
    return readers


def read_metrics(artefacts: dict) -> dict:
    """{name: {"value", "unit"}} of every reader that found something to
    read in ``artefacts``; a reader that found nothing is left out."""
    out = {}
    for name, reader in metric_readers().items():
        value = reader.read(artefacts)
        if value is not None:
            out[name] = {"value": float(value), "unit": reader.UNIT}
    return out


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of FORBIDDEN_MODULES, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def overlay(settings: dict) -> str:
    """The port's config overlay (HOCON) of dotted keys and JSON values."""
    return "\n".join(f"{k} = {json.dumps(v)}" for k, v in settings.items())


def derived_seed(seed: int, *tags: int) -> int:
    """A 32-bit seed of its own for each use of the run's seed."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(1)[0])


def note(what: str, since: float) -> float:
    """One line on standard error: ``what`` took the seconds since
    ``since`` (a ``time.perf_counter()``); returns the clock now."""
    now = time.perf_counter()
    print(f"portbench: {what} {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def check_lines(check: dict) -> list[str]:
    """One line per number compared: its name, value and limit."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in check.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                check: dict, breakdown: dict | None = None) -> str:
    """The contract's last line; the compared numbers come last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = check
    return json.dumps(out)
