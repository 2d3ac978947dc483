"""Scripted scenarios: what happens to the fleet WHILE traffic flows.

A scenario file (JSON; format documented in docs/traffic-harness.md)
declares the arrival process, the user skew, the SLO, and a timeline of
actions the harness executes mid-run — publish a new model generation,
roll back to an old one, open and close a chaos window on the update
bus, drain-restart a replica. The generator holds its offered rate
throughout; the SLO verdict at the end says whether the fleet absorbed
the timeline without letting users notice.

Example:

    {
      "duration_s": 10,
      "template": "/probe/recommend/u%d",
      "arrivals": {"process": "poisson", "rate": 150, "seed": 7},
      "skew": {"users": 1000000, "exponent": 1.1,
               "hot_count": 16, "hot_weight": 0.2, "seed": 7},
      "slo": {"p99_ms": 500, "error_rate": 0.0, "window_s": 5},
      "actions": [
        {"at": 2.0, "do": "publish", "metric": 0.95},
        {"at": 3.0, "do": "chaos", "drop": 0.2, "delay_ms": 5, "dup": 0.2},
        {"at": 5.0, "do": "chaos", "drop": 0, "delay_ms": 0, "dup": 0},
        {"at": 6.5, "do": "rollback", "generation": "first"}
      ]
    }

Action verbs are resolved by the harness (oryx_tpu_torch/tools/fleet.py
registers publish / rollback / chaos / restart); this module owns parsing
and the timed execution thread, so tests can script scenarios against
fakes.

Port note: a copy of ``oryx_tpu/loadgen/scenario.py`` (JAX-free), with its imports pointed
at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from oryx_tpu_torch.loadgen.arrivals import DiurnalRampProcess, PoissonProcess
from oryx_tpu_torch.loadgen.skew import PowerLawUsers
from oryx_tpu_torch.loadgen.slo import SLOSpec

__all__ = ["Action", "Scenario", "ScenarioRunner"]


@dataclass
class Action:
    at: float
    do: str
    args: dict[str, Any] = field(default_factory=dict)


@dataclass
class Scenario:
    duration_s: float = 10.0
    template: str = "/probe/recommend/u%d"
    arrivals_spec: dict[str, Any] = field(default_factory=lambda: {"process": "poisson", "rate": 100.0})
    skew_spec: dict[str, Any] = field(default_factory=lambda: {"users": 1_000_000})
    slo: SLOSpec = field(default_factory=SLOSpec)
    actions: list[Action] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Scenario":
        actions = [
            Action(
                at=float(a["at"]),
                do=str(a["do"]),
                args={k: v for k, v in a.items() if k not in ("at", "do")},
            )
            for a in d.get("actions", [])
        ]
        actions.sort(key=lambda a: a.at)
        slo = SLOSpec(**d.get("slo", {}))
        return cls(
            duration_s=float(d.get("duration_s", 10.0)),
            template=str(d.get("template", "/probe/recommend/u%d")),
            arrivals_spec=dict(d.get("arrivals", {"process": "poisson", "rate": 100.0})),
            skew_spec=dict(d.get("skew", {"users": 1_000_000})),
            slo=slo,
            actions=actions,
        )

    @classmethod
    def from_file(cls, path: str) -> "Scenario":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def build_arrivals(self):
        spec = dict(self.arrivals_spec)
        process = spec.pop("process", "poisson")
        if process == "poisson":
            return PoissonProcess(rate=float(spec.get("rate", 100.0)), seed=int(spec.get("seed", 0)))
        if process == "diurnal":
            return DiurnalRampProcess(
                base_rate=float(spec.get("base_rate", 50.0)),
                peak_rate=float(spec.get("peak_rate", 200.0)),
                period_s=float(spec.get("period_s", self.duration_s)),
                seed=int(spec.get("seed", 0)),
                phase=float(spec.get("phase", 0.0)),
            )
        raise ValueError(f"unknown arrival process {process!r}")

    def build_skew(self) -> PowerLawUsers:
        spec = self.skew_spec
        return PowerLawUsers(
            n_users=int(spec.get("users", 1_000_000)),
            exponent=float(spec.get("exponent", 1.1)),
            hot_count=int(spec.get("hot_count", 0)),
            hot_weight=float(spec.get("hot_weight", 0.0)),
            seed=int(spec.get("seed", 0)),
        )


class ScenarioRunner(threading.Thread):
    """Executes a scenario's action timeline on its own thread while the
    engine generates load on the caller's. Handlers is a verb -> callable
    mapping; each callable receives the action's args as kwargs. Handler
    exceptions are recorded, never raised into the timer thread — the
    run's verdict surfaces them."""

    def __init__(
        self,
        actions: list[Action],
        handlers: dict[str, Callable[..., Any]],
        clock=time.monotonic,
    ) -> None:
        super().__init__(name="ScenarioRunner", daemon=True)
        self._actions = sorted(actions, key=lambda a: a.at)
        self._handlers = handlers
        self._clock = clock
        # NB: not `_stop` — threading.Thread uses that name internally
        self._halt = threading.Event()
        self.executed: list[Action] = []
        self.errors: list[tuple[Action, Exception]] = []

    def run(self) -> None:
        t0 = self._clock()
        for action in self._actions:
            delay = action.at - (self._clock() - t0)
            if delay > 0 and self._halt.wait(delay):
                return
            handler = self._handlers.get(action.do)
            if handler is None:
                self.errors.append(
                    (action, ValueError(f"no handler for action {action.do!r}"))
                )
                continue
            try:
                handler(**action.args)
                self.executed.append(action)
            except Exception as e:  # noqa: BLE001 - surfaced in verdict
                self.errors.append((action, e))

    def stop(self) -> None:
        self._halt.set()
