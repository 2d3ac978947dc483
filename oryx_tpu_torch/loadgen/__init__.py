"""Open-loop production traffic generation for the serving tier.

Every number the repo produced before this package came from
*closed-loop* clients: each worker waits for its response before sending
the next request, so the offered rate collapses to whatever the server
sustains and queueing delay is structurally invisible (the
coordinated-omission trap). Production traffic does not wait. This
package generates traffic the way users do — arrivals fire on their own
clock regardless of outstanding responses — so saturation shows up as
queueing delay and shed load in the numbers instead of silently lowering
the measured rate.

- ``arrivals``  — Poisson and diurnal-ramp (non-homogeneous Poisson)
  arrival processes, seeded and deterministic.
- ``skew``      — power-law + hot-key user-id skew over millions of
  simulated users, without materializing a distribution table.
- ``engine``    — the open-loop engine: schedules arrivals, routes to N
  replica targets by readiness, bounds in-flight concurrency while
  *accounting* for queueing (latency is measured from the scheduled
  arrival, not from socket connect), and classifies failures by kind.
- ``slo``       — SLO specs and per-replica / fleet-wide burn-rate
  verdicts over the engine's records and replica /metrics.

The multi-replica fleet harness that composes these against real
ServingLayer replicas is ``oryx_tpu_torch/tools/fleet.py``; the scenario
file format and burn-rate definitions are documented in
docs/traffic-harness.md.

Port note: a copy of ``oryx_tpu/loadgen/`` (JAX-free), with its imports pointed
at ``oryx_tpu_torch``.
"""

from oryx_tpu_torch.loadgen.arrivals import DiurnalRampProcess, PoissonProcess
from oryx_tpu_torch.loadgen.engine import LoadResult, OpenLoopEngine, Target
from oryx_tpu_torch.loadgen.feedback import ScriptedFeedback
from oryx_tpu_torch.loadgen.scenario import Action, Scenario, ScenarioRunner
from oryx_tpu_torch.loadgen.skew import PowerLawUsers
from oryx_tpu_torch.loadgen.slo import SLOSpec, SLOVerdict, evaluate_slo

__all__ = [
    "Action",
    "DiurnalRampProcess",
    "LoadResult",
    "OpenLoopEngine",
    "PoissonProcess",
    "PowerLawUsers",
    "Scenario",
    "ScenarioRunner",
    "ScriptedFeedback",
    "SLOSpec",
    "SLOVerdict",
    "Target",
    "evaluate_slo",
]
