"""The port's serving fleet (``oryx_tpu_torch/tools/fleet.py``) against
the JAX package's (``tools/fleet.py``) under open-loop load, on the CPU.

Each case of the JAX package's fleet suites (tests/serving/test_fleet.py,
tests/tenancy/test_fleet_tenants.py,
tests/experiments/test_fleet_experiment.py and
tests/chaos/test_fleet_crash.py), at their sizes and with their markers,
runs twice on the same seeds: over the JAX package's ``FleetHarness`` of
its ServingLayers, then over the port's ``FleetHarness`` of the port's
ServingLayers on the port's ``fault+inproc:`` bus (the crash campaign's
children as ``python tools/fleet.py`` and ``python -m
oryx_tpu_torch.tools.fleet`` processes). Every run must hold the suite's
own assertions, and the two runs must give equal outcomes in all that
does not depend on timing: the scripted actions executed, the arrivals
offered and the users they drew, the failures, the sequence of
generations, each replica's model swaps, the final skew, the apply-span
tree (names, parents, attribute keys), tenant isolation, the
promote/refuse decisions and the crash report's keys and counts.
Latencies, per-replica shares and the autoscaler's event times differ
from run to run; they are held as the suites hold them, on each side.

- N replicas on one chaos-wrapped update topic, a fixed offered rate,
  and mid-run a publish, a fault window, a rollback and drain-restarts,
  with zero failed requests and the fleet converged (skew 0);
- the overload spike absorbed by shedding (no 5xx), the autoscaler
  scaling out before a diurnal peak and draining after it, and one
  traced publish applied on every replica in the same trace;
- three probe tenants under a noisy-neighbour burst, each with its own
  verdict, and one tenant's publish moving only that tenant;
- a 10% champion/challenger split with scripted feedback: the better
  challenger promoted, the worse one refused;
- three subprocess replicas, one SIGKILLed mid-run, recovered within the
  budget and with no failed request.

Each test also holds the port's resource ledger (threads, consumers,
rings) to its count before the test, and runs under the port's
lock-order watchdog (strict, a 120 s acquire budget); the shared conftest
holds the JAX package's ledger and arms its watchdog beneath the port's.
"""

from __future__ import annotations

import gc
import importlib
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus import faultbus
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common.ledger import ledger as resource_ledger
from oryx_tpu_torch.tools import fleet as fleet_tool
from torch_lock_watchdog import _port_lock_watchdog  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import fleet as ref_fleet  # noqa: E402  (the JAX package's fleet tool; tools/ is not a package)

pytestmark = pytest.mark.fleet

LEAK_KINDS = ("thread", "consumer", "ring")


def _side(pkg: str, fleet_module) -> SimpleNamespace:
    """One package's fleet and the modules its cases read."""

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg,
        fleet=fleet_module,
        loadgen=mod("loadgen"),
        slo=mod("loadgen.slo"),
        faultbus=mod("bus.faultbus"),
        tracking=mod("registry.tracking"),
        metrics=mod("common.metrics"),
        tracing=mod("common.tracing"),
        store=mod("registry.store"),
        manifest=mod("registry.manifest"),
        routing=mod("experiments.routing"),
        autoscale=mod("serving.autoscale"),
    )


REFERENCE = _side("oryx_tpu", ref_fleet)
PORT = _side("oryx_tpu_torch", fleet_tool)


def _settled(before: dict, timeout: float = 5.0) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        after = resource_ledger.counts()
        if all(after.get(k, 0) <= before.get(k, 0) for k in after):
            return after
        if time.monotonic() > deadline:
            return after
        gc.collect()
        time.sleep(0.05)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    gc.collect()
    before = resource_ledger.counts()
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    faultbus.reset()
    after = _settled(before)
    assert all(after.get(k, 0) <= before.get(k, 0) for k in after), (before, after)


def _parity(case, tmp_path, **kwargs) -> dict:
    """Run ``case(side, work_dir, **kwargs)`` over the JAX package's fleet,
    then over the port's, on the same seeds; their outcomes must be equal."""
    outcomes = {}
    for side in (REFERENCE, PORT):
        work_dir = tmp_path / side.pkg
        work_dir.mkdir()
        outcomes[side.pkg] = case(side, work_dir, **kwargs)
    assert outcomes[PORT.pkg] == outcomes[REFERENCE.pkg], outcomes
    return outcomes[PORT.pkg]


def _order(ids) -> list[int]:
    """Generation ids as the order in which each first appeared: ids are
    minted anew in each run, their sequence is what both runs share."""
    first: dict = {}
    return [first.setdefault(g, len(first)) for g in ids]


def _traffic(result) -> dict:
    """What the seeded arrivals decide, whatever the timing: the arrivals
    offered, the users they drew, and that none failed."""
    return {
        "offered": result.offered,
        "users": sorted(r.user for r in result.records),
        "failed": result.failed,
        "error_kinds": dict(result.error_kinds),
    }


def _generation_counters(layer) -> dict[str, float]:
    """Per-generation request counters from one replica's instance-scoped
    metrics (the observability the rotation assertions run on)."""
    snap = layer.instance_metrics.snapshot()
    prefix = "serving.requests.generation."
    return {
        name[len(prefix):]: entry["value"]
        for name, entry in snap.items()
        if name.startswith(prefix)
    }


def _rotation_under_chaos(S, work_dir):
    with S.fleet.FleetHarness(3, str(work_dir), bus_name="fleet-acceptance") as fleet:
        first = fleet.publish(metric=0.90)
        assert fleet.wait_converged(first, timeout=15.0)

        scenario = S.fleet.default_scenario(rate=120.0, seconds=8.0)
        result, verdict, runner = S.fleet.run_scenario(fleet, scenario)

        # every scripted action executed, none errored
        assert not runner.errors, runner.errors
        assert [a.do for a in runner.executed] == ["chaos", "publish", "chaos", "rollback"]

        # zero-downtime: not one failed request across the whole timeline
        assert result.failed == 0, dict(result.error_kinds)
        assert result.ok == result.offered > 0
        assert verdict.passed, verdict.violations
        assert verdict.p99_ms <= scenario.slo.p99_ms

        # the chaos window was actually consulted on the update path
        assert S.faultbus.get_state(fleet.chaos_locator).rolls > 0

        # the fleet converged back on generation A with zero skew
        assert fleet.generations[0] == first and fleet.generations[-1] == first
        assert fleet.wait_converged(first, timeout=10.0)
        skew = S.tracking.record_fleet_skew(fleet.replica_generations())
        assert skew == 0

        second = fleet.generations[1]
        swaps = []
        for i, layer in enumerate(fleet.replicas):
            # exactly A -> B -> A reached each manager: duplicate MODEL
            # deliveries from the dup/drop levers were all suppressed
            swaps.append(layer.model_manager.model_swaps)
            assert swaps[-1] == 3, f"replica {i}"
            # rotation is observable: every replica served traffic under
            # BOTH generations (per-generation request counters)
            gens = _generation_counters(layer)
            assert gens.get(first, 0) > 0, f"replica {i}: {gens}"
            assert gens.get(second, 0) > 0, f"replica {i}: {gens}"

        # every replica took a share of the load through the router
        for name, target in result.per_target.items():
            assert target.ok > 0, name

        return {
            "scenario": [(a.at, a.do, a.args) for a in scenario.actions],
            "executed": [a.do for a in runner.executed],
            **_traffic(result),
            "generations": _order(fleet.generations),
            "model_swaps": swaps,
            "skew": skew,
            "targets": sorted(result.per_target),
        }


def test_three_replica_rotation_under_chaos_zero_downtime(tmp_path):
    """THE acceptance scenario: 3 replicas, fixed offered rate, publish +
    chaos window + rollback mid-run; zero failed requests, p99 in SLO,
    fleet converged back on the first generation with zero skew."""
    _parity(_rotation_under_chaos, tmp_path)


def _rolling_restart(S, work_dir):
    gc.collect()
    with S.fleet.FleetHarness(2, str(work_dir), bus_name="fleet-restart") as fleet:
        gen = fleet.publish(metric=0.90)
        assert fleet.wait_converged(gen, timeout=15.0)
        originals = list(fleet.replicas)

        engine = S.loadgen.OpenLoopEngine(
            fleet.targets, template="/probe/recommend/u%d", readiness_poll_s=0.1
        )
        runner = S.loadgen.ScenarioRunner(
            [
                S.loadgen.Action(0.8, "restart", {"replica": 0, "drain_s": 5.0}),
                S.loadgen.Action(2.8, "restart", {"replica": 1, "drain_s": 5.0}),
            ],
            fleet.handlers(),
        )
        runner.start()
        result = engine.run(
            S.loadgen.PoissonProcess(rate=60.0, seed=3),
            S.loadgen.PowerLawUsers(100_000, seed=3),
            6.0,
        )
        runner.join(timeout=15.0)

        assert not runner.errors, runner.errors
        assert len(runner.executed) == 2
        assert result.failed == 0, dict(result.error_kinds)
        # both slots hold FRESH replicas that replayed to the generation
        fresh = [fleet.replicas[i] is not originals[i] for i in (0, 1)]
        assert fresh == [True, True]
        assert fleet.wait_converged(gen, timeout=10.0)
        for layer in fleet.replicas:
            assert layer.model_manager.model_swaps >= 1
        # traffic flowed to both slots across the rotation
        assert result.per_target["replica-0"].ok > 0
        assert result.per_target["replica-1"].ok > 0
        outcome = {
            "executed": [a.do for a in runner.executed],
            **_traffic(result),
            "fresh": fresh,
            "generations": _order(fleet.replica_generations()),
        }
        del originals
    return outcome


def test_rolling_restart_under_load_zero_downtime(tmp_path):
    """Drain-aware rolling restart of every replica, one at a time, while
    the offered rate holds: readiness pulls the draining replica out of
    rotation, in-flight requests finish, a fresh replica replays the
    topic and rejoins — and no request ever fails. The resource ledger
    must also come back clean: each rotated-out replica's server thread,
    consume thread, and update consumer die with it."""
    gc.collect()
    resources_before = resource_ledger.counts()
    _parity(_rolling_restart, tmp_path)
    # the rotation churned 2 replicas + 2 fresh ones through their whole
    # lifecycle; after harness teardown no thread/consumer/ring may
    # outlive the test beyond what was live before it
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        gc.collect()
        after = resource_ledger.counts()
        if all(after.get(k, 0) <= resources_before.get(k, 0) for k in LEAK_KINDS):
            break
        time.sleep(0.05)
    assert all(
        after.get(k, 0) <= resources_before.get(k, 0) for k in LEAK_KINDS
    ), (resources_before, after)


def _rollback_hammered(S, work_dir):
    with S.fleet.FleetHarness(2, str(work_dir), bus_name="fleet-hammer") as fleet:
        first = fleet.publish(metric=0.90)
        assert fleet.wait_converged(first, timeout=15.0)
        second = fleet.publish(metric=0.95)
        assert fleet.wait_converged(second, timeout=15.0)

        statuses: list[int] = []
        statuses_lock = threading.Lock()

        def hammer():
            time.sleep(0.5)  # let traffic establish first
            for _ in range(3):
                req = urllib.request.Request(
                    f"{fleet.targets[0].base_url}/model/rollback/{first}",
                    method="POST",
                )
                try:
                    with urllib.request.urlopen(req, timeout=10) as resp:
                        code = resp.status
                except urllib.error.HTTPError as e:
                    code = e.code
                with statuses_lock:
                    statuses.append(code)

        threads = [threading.Thread(target=hammer, daemon=True) for _ in range(6)]
        for t in threads:
            t.start()
        engine = S.loadgen.OpenLoopEngine(fleet.targets, template="/probe/recommend/u%d")
        result = engine.run(
            S.loadgen.PoissonProcess(rate=80.0, seed=5),
            S.loadgen.PowerLawUsers(100_000, seed=5),
            4.0,
        )
        for t in threads:
            t.join(timeout=15.0)

        assert len(statuses) == 18
        assert all(s == 200 for s in statuses), statuses
        assert result.failed == 0, dict(result.error_kinds)
        # 18 rollback publishes of the SAME generation: the first swaps
        # every replica back to A, the other 17 MODEL deliveries are
        # suppressed as duplicates of the live generation
        assert fleet.wait_converged(first, timeout=10.0)
        skew = S.tracking.record_fleet_skew(fleet.replica_generations())
        assert skew == 0
        swaps = [layer.model_manager.model_swaps for layer in fleet.replicas]
        assert swaps == [3, 3], swaps
        return {
            "statuses": sorted(statuses),
            **_traffic(result),
            "generations": _order([first, second, *fleet.replica_generations()]),
            "skew": skew,
            "model_swaps": swaps,
        }


def test_rollback_hammered_concurrently_under_traffic(tmp_path):
    """POST /model/rollback/<gen> from many threads while GET traffic
    flows: every POST succeeds, no request fails, the tracker lands on
    exactly one generation fleet-wide, and duplicate-MODEL suppression
    holds (the hammering causes exactly ONE extra swap, not N)."""
    _parity(_rollback_hammered, tmp_path)


def _drain_shutdown(S, work_dir):
    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    seen = []
    with S.fleet.FleetHarness(1, str(work_dir), bus_name="fleet-drain") as fleet:
        gen = fleet.publish(metric=0.90)
        assert fleet.wait_converged(gen, timeout=15.0)
        layer = fleet.replicas[0]
        base = fleet.targets[0].base_url

        # wait_converged returns once the generation tracker names the
        # generation, a beat before the manager has applied the MODEL and
        # readiness follows (both packages' harnesses), so settle first
        deadline = time.monotonic() + 10.0
        while get(f"{base}/readyz")[0] != 200 and time.monotonic() < deadline:
            time.sleep(0.01)
        status, body = get(f"{base}/readyz")
        seen.append(("readyz", status, json.loads(body)["draining"]))
        assert seen[-1] == ("readyz", 200, False)

        layer.begin_drain()
        status, body = get(f"{base}/readyz")
        seen.append(("readyz", status, json.loads(body)["draining"]))
        assert seen[-1] == ("readyz", 503, True)
        seen.append(("ready", get(f"{base}/ready")[0]))
        assert seen[-1] == ("ready", 503)
        # draining gates READINESS only — in-flight/new requests still work
        status, body = get(f"{base}/probe/recommend/u1")
        seen.append(("recommend", status, json.loads(body)["generation_id"] == gen))
        assert seen[-1] == ("recommend", 200, True)

        # drain() waits on the in-flight count, not wall-clock. The GET
        # above can return to the client a beat before the server-side
        # handler decrements the counter, so settle rather than assert
        # an instantaneous zero.
        deadline = time.monotonic() + 2.0
        while layer.inflight_requests and time.monotonic() < deadline:
            time.sleep(0.01)
        assert layer.inflight_requests == 0
        seen.append(("drain", layer.drain(timeout=1.0)))
        layer._request_began()
        seen.append(("inflight", layer.inflight_requests))
        seen.append(("drain", layer.drain(timeout=0.2)))  # held open -> times out
        layer._request_ended()
        seen.append(("drain", layer.drain(timeout=1.0)))
        assert seen[-4:] == [("drain", True), ("inflight", 1), ("drain", False), ("drain", True)]

        layer.close(drain_seconds=2.0)  # full drain-then-stop path
        fleet.replicas = []  # already closed; stop() must not double-close
    return {"seen": seen}


def test_drain_aware_shutdown(tmp_path):
    """begin_drain flips readiness to 503 while the replica keeps serving;
    drain() blocks on the in-flight count; close(drain_seconds) runs the
    full drain-then-stop path."""
    _parity(_drain_shutdown, tmp_path)


def _shed_counters(layer) -> dict[str, float]:
    snap = layer.instance_metrics.snapshot()
    prefix = "serving.overload.shed."
    return {
        name[len(prefix):]: entry["value"]
        for name, entry in snap.items()
        if name.startswith(prefix)
    }


def _responses_5xx(layer) -> float:
    snap = layer.instance_metrics.snapshot()
    entry = snap.get("serving.responses.5xx") or {}
    return float(entry.get("value") or 0.0)


# scripted 60 ms of service time per probe answer makes saturation a
# function of offered rate alone (Little's law), deterministic on a
# single-core host; the tightened ladder knobs let the controller walk
# rungs within the few-second phases of the test
SPIKE_OVERLAY = """
    oryx {
      serving.overload {
        inflight-target = 4
        hold-s = 0.2
        control-interval-ms = 25
        alpha = 0.5
      }
      test.probe-work-ms = 60
    }
    """


def _spike(S, work_dir):
    with S.fleet.FleetHarness(
        3, str(work_dir), bus_name="fleet-spike", overlay=SPIKE_OVERLAY
    ) as fleet:
        gen = fleet.publish(metric=0.90)
        assert fleet.wait_converged(gen, timeout=15.0)
        for layer in fleet.replicas:
            assert layer.admission is not None  # overload control is on
        fivexx_before = [_responses_5xx(layer) for layer in fleet.replicas]

        def run_phase(rate, seconds, seed):
            engine = S.loadgen.OpenLoopEngine(
                fleet.targets, template="/probe/recommend/u%d", readiness_poll_s=0.1
            )
            return engine.run(
                S.loadgen.PoissonProcess(rate=rate, seed=seed),
                S.loadgen.PowerLawUsers(100_000, seed=seed),
                seconds,
            )

        phases = {
            "baseline": run_phase(25.0, 2.5, seed=11),
            "spike": run_phase(250.0, 2.5, seed=12),  # 10x the baseline rate
            "settle": run_phase(25.0, 2.0, seed=13),  # ladder walks back down
            "recovered": run_phase(25.0, 3.0, seed=14),
        }

        # zero 5xx / zero failures across ALL phases: sheds are deliberate
        # 429s (counted separately), never failures
        for phase, result in phases.items():
            assert result.failed == 0, (phase, dict(result.error_kinds))
        fivexx = [_responses_5xx(layer) - b for layer, b in zip(fleet.replicas, fivexx_before)]
        assert fivexx == [0.0, 0.0, 0.0], fivexx

        # calm fleet serves at full quality, and the spike's p99 stays
        # inside the SLO because excess was shed, not queued
        baseline, spike = phases["baseline"], phases["spike"]
        assert baseline.quality()["full"] >= 0.99, baseline.quality()
        assert spike.latency_quantile(0.99) * 1000.0 <= 1000.0
        # the ladder actually engaged: answers below full quality during
        # the spike, per-stage shed counters ticking on the replicas
        spike_quality = spike.quality()
        assert spike_quality["full"] < 1.0, spike_quality
        assert spike.shed > 0, spike_quality  # fast-429 rung reached
        fleet_sheds: dict[str, float] = {}
        for layer in fleet.replicas:
            for stage, v in _shed_counters(layer).items():
                fleet_sheds[stage] = fleet_sheds.get(stage, 0.0) + v
        assert sum(fleet_sheds.values()) > 0, fleet_sheds

        # full recovery: >=99% full-quality answers, ladder released
        recovered_quality = phases["recovered"].quality()
        assert recovered_quality["full"] >= 0.99, recovered_quality
        with urllib.request.urlopen(
            f"{fleet.targets[0].base_url}/healthz", timeout=5
        ) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok", health
        assert health["shed_stage"] == "full", health
        return {
            **{phase: _traffic(result) for phase, result in phases.items()},
            "fivexx": fivexx,
            "health": (health["status"], health["shed_stage"]),
        }


def test_spike_absorbed_by_staged_shedding_zero_5xx(tmp_path):
    """The overload acceptance scenario: a 10x Poisson spike over a
    3-replica fleet. The shed ladder engages (excess answered below full
    quality or fast-429'd with Retry-After), p99 stays inside the SLO,
    not one request FAILS (sheds are deliberate, 5xx would be failure),
    and after the spike the ladder releases back to >=99% full-quality
    answers with /healthz reporting ok."""
    _parity(_spike, tmp_path)


def _autoscaler(S, work_dir):
    period, peak_at = 14.0, 7.0
    with S.fleet.FleetHarness(1, str(work_dir), bus_name="fleet-autoscale") as fleet:
        gen = fleet.publish(metric=0.90)
        assert fleet.wait_converged(gen, timeout=15.0)
        fleet.rate_window_s = 1.5
        cfg = S.autoscale.AutoscaleConfig(
            enabled=True,
            min_replicas=1,
            max_replicas=3,
            interval_s=0.25,
            lead_s=3.0,
            period_s=period,
            per_replica_rate=30.0,
            cooldown_s=1.5,
            # the point of this test is the predictive law: park the
            # reactive thresholds so single-core latency jitter can't fire
            burn_hi=1e9,
            queue_wait_hi_ms=1e9,
            scale_in_quiet_evals=3,
            min_fit_samples=6,
        )
        policy = fleet.start_autoscaler(cfg)
        engine = S.loadgen.OpenLoopEngine(
            fleet.targets, template="/probe/recommend/u%d", readiness_poll_s=0.1
        )
        t0 = time.monotonic()
        result = engine.run(
            S.loadgen.DiurnalRampProcess(15.0, 45.0, period, seed=17),
            S.loadgen.PowerLawUsers(100_000, seed=17),
            period,
        )
        fleet.stop_autoscaler()

        assert result.failed == 0, dict(result.error_kinds)
        outs = [e for e in policy.events if e.direction == "out"]
        ins = [e for e in policy.events if e.direction == "in"]
        # capacity landed before the diurnal peak...
        assert outs, policy.events
        assert outs[0].t - t0 < peak_at, (outs[0].t - t0, policy.events)
        # ...and the scaled-out replica actually took traffic through the
        # readiness-gated router
        assert result.per_target["replica-1"].ok > 0
        # ...then drained back in after the peak passed, on quiet evals
        assert ins, policy.events
        assert ins[0].t - t0 > peak_at, (ins[0].t - t0, policy.events)
        assert fleet.replica_count() == 1
        # a tombstoned slot is out of the generation-skew bookkeeping
        assert len(fleet.replica_generations()) == fleet.replica_count()
        return {
            **_traffic(result),
            "first_move": policy.events[0].direction,
            "last_move": policy.events[-1].direction,
            "replicas_at_end": fleet.replica_count(),
            "generations": _order([gen, *fleet.replica_generations()]),
        }


def test_autoscaler_scales_out_before_diurnal_peak(tmp_path):
    """Predictive autoscaling over a live fleet: diurnal raised-cosine
    traffic against one replica; the autoscaler fits the curve, scales
    out BEFORE the peak (lead-s ahead of predicted demand), drains back
    in after it passes, and no request ever fails — the fresh replica is
    gated by readiness, the retired one drains first."""
    _parity(_autoscaler, tmp_path)


def _span_tree(spans) -> list:
    """A trace's spans as (name, parent's name, attribute keys), sorted."""
    names = {s["span"]: s["name"] for s in spans}
    return sorted(
        (s["name"], names.get(s["parent"]), tuple(sorted(s["attrs"]))) for s in spans
    )


def _publish_to_apply_spans(S, work_dir):
    tracing, metrics = S.tracing, S.metrics
    tracing.reset()
    try:
        fresh0 = metrics.registry.histogram("serving.freshness.seconds").count
        with S.fleet.FleetHarness(3, str(work_dir), bus_name="fleet-trace") as fleet:
            gen = fleet.publish(metric=0.90)
            assert fleet.wait_converged(gen, timeout=15.0)

            (pub,) = [
                s for s in tracing.spans() if s["name"] == "batch.publish-model"
            ]
            assert pub["parent"] is None  # the publish is the trace root
            trace_id = pub["trace"]

            want = {layer.port for layer in fleet.replicas}

            def applied():
                return {
                    s["attrs"]["instance"]
                    for s in tracing.spans(trace_id)
                    if s["name"] == "serving.model.apply"
                }

            deadline = time.monotonic() + 10.0
            while applied() != want and time.monotonic() < deadline:
                time.sleep(0.05)
            assert applied() == want, "not every replica recorded an apply span"

            trace = tracing.spans(trace_id)
            applies = [s for s in trace if s["name"] == "serving.model.apply"]
            for s in applies:
                assert s["parent"] == pub["span"]  # joined, not re-rooted
                assert s["attrs"]["skew_ms"] >= 0
                assert s["attrs"]["generation"] == gen
            # one freshness observation per replica landed globally
            fresh = metrics.registry.histogram("serving.freshness.seconds")
            assert fresh.count >= fresh0 + 3
            return {
                "tree": _span_tree(trace),
                "applies": len(applies),
                "root_attrs": sorted(pub["attrs"]),
            }
    finally:
        tracing.reset()


def test_model_publish_to_apply_spans_across_fleet(tmp_path, monkeypatch):
    """The publish->apply half of the tracing story at fleet scale: one
    traced publish fans out through the chaos-wrapped update topic and
    every replica records a serving.model.apply span in the SAME trace,
    with a non-negative propagation skew and the freshness histogram fed
    once per replica."""
    monkeypatch.setenv("ORYX_TRACING_SAMPLE_RATE", "1.0")
    _parity(_publish_to_apply_spans, tmp_path)


# -- tenants (tests/tenancy/test_fleet_tenants.py) ---------------------------


TENANTS = {
    "als": {"weight": 2.0, "slo_p99_ms": 1000.0},
    "kmeans": {"weight": 1.0, "slo_p99_ms": 1000.0},
    "rdf": {"weight": 1.0, "slo_p99_ms": 1000.0},
}


def tenant_scenario(S, rate: float, seconds: float, seed: int = 7):
    """Steady weighted traffic, then a 10x noisy-neighbour burst: the als
    tenant's mix weight jumps from 2 to 20 for the middle third of the
    run, crowding the shared queue, then drops back."""
    return S.loadgen.Scenario.from_dict(
        {
            "duration_s": seconds,
            "template": "/probe/recommend/u%d",
            "arrivals": {"process": "poisson", "rate": rate, "seed": seed},
            "skew": {
                "users": 2_000_000,
                "exponent": 1.1,
                "hot_count": 16,
                "hot_weight": 0.2,
                "seed": seed,
            },
            "slo": {"p99_ms": 1000.0, "error_rate": 0.0, "window_s": 5.0},
            "actions": [
                {"at": seconds * 0.35, "do": "tenant-mix",
                 "als": 20.0, "kmeans": 1.0, "rdf": 1.0},
                {"at": seconds * 0.70, "do": "tenant-mix",
                 "als": 2.0, "kmeans": 1.0, "rdf": 1.0},
            ],
        }
    )


def _noisy_neighbour(S, work_dir):
    with S.fleet.FleetHarness(
        3, str(work_dir), bus_name="fleet-tenants", tenants=TENANTS
    ) as fleet:
        # each tenant publishes on its OWN topic into its OWN lineage;
        # the whole fleet converges on every tenant's generation
        want = {tid: fleet.publish_tenant(tid, metric=0.90) for tid in TENANTS}
        assert len(set(want.values())) == 3  # private lineages, distinct ids
        assert fleet.wait_tenants_converged(want, timeout=20.0)

        scenario = tenant_scenario(S, rate=150.0, seconds=8.0)
        mix = {tid: spec["weight"] for tid, spec in TENANTS.items()}
        result, verdict, runner = S.fleet.run_scenario(fleet, scenario, tenant_mix=mix)

        # both burst actions executed, none errored
        assert not runner.errors, runner.errors
        assert [a.do for a in runner.executed] == ["tenant-mix", "tenant-mix"]

        # zero-downtime across the burst: not one failed request, any tenant
        assert result.failed == 0, dict(result.error_kinds)
        assert verdict.passed, verdict.violations

        # every tenant took traffic, roughly by weight outside the burst
        grouped = result.tenant_records()
        assert sorted(grouped) == ["als", "kmeans", "rdf"]
        assert all(len(records) > 0 for records in grouped.values())
        assert len(grouped["als"]) > len(grouped["kmeans"])

        # per-tenant verdicts: the victims' p99 held through the burst
        specs = {
            tid: S.slo.SLOSpec(p99_ms=spec["slo_p99_ms"], error_rate=0.0)
            for tid, spec in TENANTS.items()
        }
        verdicts = S.slo.evaluate_tenant_slos(result, specs)
        for tid, tenant_verdict in verdicts.items():
            assert tenant_verdict.passed, (tid, tenant_verdict.violations)

        # per-tenant observability reached the replicas: tenant-labelled
        # request counters on each replica's instance metrics
        for layer in fleet.replicas:
            snap = layer.instance_metrics.snapshot()
            served = {
                tid: snap.get(f"serving.requests.tenant.{tid}", {}).get("value", 0)
                for tid in TENANTS
            }
            assert all(count > 0 for count in served.values()), served

        # zero tenant-generation skew at rest
        per_replica = fleet.tenant_generations_by_replica()
        assert all(per == want for per in per_replica)
        return {
            "scenario": [(a.at, a.do, a.args) for a in scenario.actions],
            "executed": [a.do for a in runner.executed],
            **_traffic(result),
            "tenants": sorted(grouped),
            "verdicts": {tid: v.passed for tid, v in verdicts.items()},
            "replicas_converged": len(per_replica),
        }


def test_three_tenants_noisy_neighbour_zero_downtime(tmp_path):
    _parity(_noisy_neighbour, tmp_path)


def _tenant_rollback(S, work_dir):
    with S.fleet.FleetHarness(
        2, str(work_dir), bus_name="fleet-tenant-iso", tenants=TENANTS
    ) as fleet:
        first = {tid: fleet.publish_tenant(tid, metric=0.90) for tid in TENANTS}
        assert fleet.wait_tenants_converged(first, timeout=20.0)

        second_als = fleet.publish_tenant("als", metric=0.95)
        want = dict(first, als=second_als)
        assert fleet.wait_tenants_converged(want, timeout=20.0)

        # the other two tenants still serve their original generation
        lives = []
        for per in fleet.tenant_generations_by_replica():
            assert per["kmeans"] == first["kmeans"]
            assert per["rdf"] == first["rdf"]
            assert per["als"] == second_als
            lives.append({tid: "second" if g == second_als else
                          "first" if g == first[tid] else g for tid, g in per.items()})
        return {"live": lives}


def test_tenant_rollback_is_isolated(tmp_path):
    """Publishing a second generation for ONE tenant moves only that
    tenant: the other tenants' live generations never change."""
    _parity(_tenant_rollback, tmp_path)


# -- online experiments (tests/experiments/test_fleet_experiment.py) --------


# 10% challenger split; small join window + sample bars so an 8-second
# run resolves enough outcomes per replica to conclude the experiment
OVERLAY = """
oryx {
  serving.ab { fraction = 0.10, join-window-s = 1.5 }
  ml.gate.online {
    enabled = true
    min-samples = 8
    min-lift = 0.0
    max-harm = 0.05
    confidence = 0.9
    check-interval-s = 0.2
  }
}
"""


def _run_split_traffic(S, fleet, feedback, seconds=8.0, rate=150.0, seed=11):
    engine = S.loadgen.OpenLoopEngine(
        fleet.targets,
        template="/probe/recommend/u%d",
        readiness_poll_s=0.1,
        on_response=feedback.on_response,
    )
    return engine.run(
        S.loadgen.PoissonProcess(rate=rate, seed=seed),
        # near-uniform users: every run exercises many distinct
        # experiment units in both arms
        S.loadgen.PowerLawUsers(600, exponent=0.2, seed=seed),
        seconds,
    )


def _assert_sticky_arms(result) -> dict:
    """Every user that saw an arm header saw exactly one arm; returns
    user -> arm for further assertions."""
    by_user: dict = {}
    for r in result.records:
        if r.arm is not None and r.user is not None:
            by_user.setdefault(r.user, set()).add(r.arm)
    assert by_user, "no arm-attributed responses recorded"
    for user, arms in by_user.items():
        assert len(arms) == 1, f"user {user} bounced between arms: {arms}"
    return {user: next(iter(arms)) for user, arms in by_user.items()}


def _assert_per_arm_observability(S, fleet, challenger_expected: bool) -> None:
    """Per-arm metrics are visible on every replica's /metrics and its
    GET /experiments report."""
    champion, challenger = S.routing.ARM_CHAMPION, S.routing.ARM_CHALLENGER
    for i in fleet.live_indices():
        snap = fleet.metrics_snapshot(i)
        assert f"serving.experiment.requests.{champion}" in snap, f"replica {i}"
        if challenger_expected:
            assert f"serving.experiment.requests.{challenger}" in snap, f"replica {i}"
        report = fleet.experiment_report(i)
        assert report["enabled"] and report["fraction"] == pytest.approx(0.10)
        arms = report["report"]["arms"]
        assert arms[champion]["serves"] > 0, f"replica {i}"
        if challenger_expected:
            assert arms[challenger]["serves"] > 0, f"replica {i}"


def _wait(predicate, timeout: float, poll: float = 0.1) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll)
    return predicate()


def _promotes_better_challenger(S, work_dir):
    champion, challenger = S.routing.ARM_CHAMPION, S.routing.ARM_CHALLENGER
    with S.fleet.FleetHarness(
        3, str(work_dir), bus_name="fleet-exp-promote", overlay=OVERLAY
    ) as fleet:
        gen_a = fleet.publish(metric=0.90)
        assert fleet.wait_converged(gen_a, timeout=15.0)
        store = S.store.RegistryStore(fleet.model_dir)
        assert store.champion_id() == gen_a

        # scripted ground truth: champion engages at 0.35, anything else
        # (the challenger) at 0.85 — the challenger IS better online
        feedback = fleet.attach_feedback({gen_a: 0.35}, default=0.85)

        # online gate on + champion present: publish does NOT move the
        # pointer; every replica classifies the new generation challenger
        gen_b = fleet.publish(metric=0.92)
        assert fleet.wait_challenger(gen_b, timeout=10.0)
        assert store.champion_id() == gen_a
        assert all(g == gen_a for g in fleet.replica_generations())

        result = _run_split_traffic(S, fleet, feedback)

        # zero-downtime bar: the split+observe path failed no request
        assert result.failed == 0, dict(result.error_kinds)
        assert result.ok > 0 and feedback.sent > 0

        arm_of = _assert_sticky_arms(result)
        assert challenger in arm_of.values(), "split routed nobody"
        assert champion in arm_of.values()
        _assert_per_arm_observability(S, fleet, challenger_expected=True)

        # evidence-gated promotion: the pointer moves, every replica
        # flips live to the promoted generation and clears its challenger
        assert _wait(lambda: store.champion_id() == gen_b, timeout=20.0), (
            "online gate never promoted: "
            f"{[fleet.experiment_report(i).get('decision') for i in fleet.live_indices()]}"
        )
        assert fleet.wait_converged(gen_b, timeout=10.0)
        assert _wait(
            lambda: all(g is None for g in fleet.challenger_generations()),
            timeout=10.0,
        )

        # the decision is durable evidence in the generation manifest
        manifest = store.read_manifest(gen_b)
        assert manifest.online_status == S.manifest.ONLINE_PROMOTED
        assert manifest.online_samples[champion] >= 8
        assert manifest.online_samples[challenger] >= 8
        assert manifest.online_lift is not None and manifest.online_lift > 0
        assert manifest.online_confidence is not None
        assert manifest.online_confidence >= 0.9

        # promoted generation actually serves now (per-request evidence)
        served = []
        for i in fleet.live_indices():
            body = json.loads(
                urllib.request.urlopen(
                    f"{fleet.targets[i].base_url}/probe/recommend/u3", timeout=5
                ).read()
            )
            served.append(body["generation_id"])
            assert served[-1] == gen_b, f"replica {i}"
        return {
            **_traffic(result),
            "arms": sorted(set(arm_of.values())),
            "status": manifest.online_status,
            "generations": _order([gen_a, gen_b, store.champion_id(), *served]),
        }


@pytest.mark.experiments
def test_fleet_promotes_genuinely_better_challenger(tmp_path):
    _parity(_promotes_better_challenger, tmp_path)


def _refuses_worse_challenger(S, work_dir):
    challenger = S.routing.ARM_CHALLENGER
    with S.fleet.FleetHarness(
        3, str(work_dir), bus_name="fleet-exp-refuse", overlay=OVERLAY
    ) as fleet:
        gen_a = fleet.publish(metric=0.90)
        assert fleet.wait_converged(gen_a, timeout=15.0)
        store = S.store.RegistryStore(fleet.model_dir)

        # seeded-worse challenger: engagement 0.08 vs the champion's 0.55
        feedback = fleet.attach_feedback({gen_a: 0.55}, default=0.08)
        gen_b = fleet.publish(metric=0.92)
        assert fleet.wait_challenger(gen_b, timeout=10.0)

        result = _run_split_traffic(S, fleet, feedback, seed=13)
        assert result.failed == 0, dict(result.error_kinds)

        arm_of = _assert_sticky_arms(result)
        assert challenger in arm_of.values()
        _assert_per_arm_observability(S, fleet, challenger_expected=True)

        # the gate refuses: manifest records it, pointer never moves
        def _refused() -> bool:
            m = store.read_manifest(gen_b)
            return m is not None and m.online_status == S.manifest.ONLINE_REFUSED

        assert _wait(_refused, timeout=20.0), (
            "online gate never refused: "
            f"{[fleet.experiment_report(i).get('decision') for i in fleet.live_indices()]}"
        )
        manifest = store.read_manifest(gen_b)
        assert manifest.online_status == S.manifest.ONLINE_REFUSED
        assert manifest.online_lift is not None and manifest.online_lift < 0
        assert store.champion_id() == gen_a

        # every replica stops routing to the refused challenger and keeps
        # serving the champion
        assert _wait(
            lambda: all(g is None for g in fleet.challenger_generations()),
            timeout=10.0,
        )
        assert all(g == gen_a for g in fleet.replica_generations())
        return {
            **_traffic(result),
            "arms": sorted(set(arm_of.values())),
            "status": manifest.online_status,
            "generations": _order(
                [gen_a, gen_b, store.champion_id(), *fleet.replica_generations()]
            ),
        }


@pytest.mark.experiments
def test_fleet_refuses_seeded_worse_challenger(tmp_path):
    _parity(_refuses_worse_challenger, tmp_path)


# -- crash campaign (tests/chaos/test_fleet_crash.py) ------------------------


def _crash_campaign(S, work_dir):
    report = S.fleet.run_crash_campaign(
        replicas=3,
        rate=60.0,
        seconds=5.0,
        work_dir=str(work_dir),
        recovery_budget_s=45.0,
    )
    assert report["crashes"] == 1, report
    assert report["failed"] == 0, report
    assert report["slo"]["passed"], report["slo"]
    assert report["recovery_within_budget"], report
    assert len(report["recovery_seconds"]) == 1
    assert 0.0 < report["recovery_seconds"][0] <= 45.0
    # the measurement also lands on the recovery.seconds gauge
    gauge = S.metrics.registry.gauge("recovery.seconds").snapshot()
    assert gauge["value"] == pytest.approx(report["recovery_seconds"][0], abs=0.001)
    return {
        "keys": sorted(report),
        "slo_keys": sorted(report["slo"]),
        **{k: report[k] for k in ("replicas", "crashes", "recovery_budget_s",
                                  "recovery_within_budget", "scenario_actions",
                                  "offered", "failed", "error_kinds")},
        "recoveries": len(report["recovery_seconds"]),
        "slo_passed": report["slo"]["passed"],
    }


@pytest.mark.chaos
def test_crash_campaign_survives_one_sigkill(tmp_path):
    _parity(_crash_campaign, tmp_path)


@pytest.mark.chaos
def test_crash_campaign_waits_for_a_respawn_slower_than_the_traffic(tmp_path, monkeypatch):
    """A crash whose respawn outlasts the traffic (and run_scenario's 5 s
    grace) is still the port's campaign's measurement: it waits for it
    within the recovery budget. The JAX package's campaign reports no
    crash in that case; the two reports differ there and only there."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()

    def slow_respawn_fleet(S):
        class SlowRespawnFleet:
            def __init__(self, n_replicas, work_dir):
                self.targets = [S.loadgen.Target(
                    "replica-0", f"http://127.0.0.1:{server.server_address[1]}")]
                self.slo_p99_ms = 1000.0
                self.crash_events = []

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                pass

            def crash(self, replica=1):
                time.sleep(6.5)  # past the 1 s run and its 5 s grace
                self.crash_events.append({"replica": replica, "recovery_seconds": 6.5})

            def handlers(self):
                return {"crash": self.crash}

        return SlowRespawnFleet

    reports = {}
    try:
        for S in (REFERENCE, PORT):
            monkeypatch.setattr(S.fleet, "ProcessFleet", slow_respawn_fleet(S))
            work_dir = tmp_path / S.pkg
            work_dir.mkdir()
            reports[S.pkg] = S.fleet.run_crash_campaign(
                replicas=1, rate=20.0, seconds=1.0, work_dir=str(work_dir),
                recovery_budget_s=20.0)
    finally:
        server.shutdown()
        server.server_close()
        serving.join(5)
    ref, port = reports[REFERENCE.pkg], reports[PORT.pkg]
    assert port["crashes"] == 1 and port["recovery_seconds"] == [6.5]
    assert port["scenario_actions"] == ["crash"] and port["failed"] == 0
    assert port["slo"]["passed"], port["slo"]
    assert ref["crashes"] == 0 and ref["recovery_seconds"] == []
    # all else that timing does not decide is equal
    assert sorted(ref) == sorted(port)
    for key in ("replicas", "recovery_budget_s", "recovery_within_budget", "duration_s",
                "offered", "offered_rate", "ok", "failed", "shed", "error_kinds"):
        assert port[key] == ref[key], key
