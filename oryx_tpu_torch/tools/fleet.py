"""Multi-replica serving fleet harness: N ServingLayers, one update topic,
open-loop traffic, scripted chaos — zero-downtime as an assertion.

The reference Oryx 2 serving tier scales horizontally: replicas share
one Kafka update topic and model generations rotate under live traffic.
This harness stands that topology up in one process — N real ServingLayer
replicas (each with its own HTTP port, update consumer, generation
tracker, and instance-scoped /metrics) consuming one update topic
through the fault-injecting chaos bus — then drives an open-loop load
scenario against the fleet while publishing generations, rolling back,
and opening chaos windows mid-run. The verdict (oryx_tpu_torch/loadgen/slo.py)
asserts the SLO: zero failed requests across a rotation, p99 within
budget, burn rates under threshold, generation skew settled to 0.

Scenario actions (oryx_tpu_torch/loadgen/scenario.py format):
  publish   {metric}                — run a ScriptedMetricUpdate batch
                                      generation and publish it
  rollback  {generation, replica}   — POST /model/rollback/<gen> to one
                                      replica; "first"/"previous" resolve
                                      against the published order
  chaos     {drop, delay_ms, dup, outage} — set the fault-bus levers
  restart   {replica, drain_s}      — drain-aware rolling restart of one
                                      replica (readiness 503 -> in-flight
                                      drain -> close -> fresh replica)
  scale     {direction, drain_s}    — scale the fleet out (fresh replica,
                                      routed once ready) or in (drain-first
                                      retirement; the slot is tombstoned)
  publish-tenant {tenant, metric}   — one generation for ONE tenant, on the
                                      tenant's namespaced topic + lineage
  tenant-mix {tenant: weight, ...}  — rebalance the engine's tenant traffic
                                      split mid-run (the noisy-neighbour
                                      burst; --tenants runs only)

The harness is also an autoscaler actuator: ``start_autoscaler()`` runs
the predictive/reactive policy (oryx_tpu_torch/serving/autoscale.py) on a
control thread that sizes the fleet from observed arrival rate, queue
wait, and SLO burn. Scale-in always drains before close, so elasticity
never fails a request.

Usage:
    python -m oryx_tpu_torch.tools.fleet --replicas 3 --rate 150 --seconds 10
    python -m oryx_tpu_torch.tools.fleet --replicas 3 --scenario scenario.json
    python -m oryx_tpu_torch.tools.fleet --replicas 2 --autoscale --rate 150 --seconds 20
    python -m oryx_tpu_torch.tools.fleet --replicas 3 --tenants "als:2,kmeans:1,rdf:1"
    python -m oryx_tpu_torch.tools.fleet --crash --replicas 3 --rate 60 --seconds 5

Replicas serve the probe app (``oryx_tpu_torch.registry.testing``), which
launches no kernel; ``--device cpu`` runs them on the CPU, as the tests do.

Port note: the counterpart of the repo's ``tools/fleet.py``, a module of
the port's package: its replicas are the port's ServingLayers, the crash
campaign's children run ``python -m oryx_tpu_torch.tools.fleet
--serve-replica``, and it imports nothing of the JAX package. One
departure: ``run_crash_campaign`` waits (within the recovery budget) for
a crash action still in flight when the traffic ends, where the JAX
package's reports no crash.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

from oryx_tpu_torch import bus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus import faultbus
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common import config as C
from oryx_tpu_torch.loadgen import engine
from oryx_tpu_torch.loadgen import (
    OpenLoopEngine,
    Scenario,
    ScenarioRunner,
    Target,
    evaluate_slo,
)
from oryx_tpu_torch.loadgen.slo import SLOSpec, evaluate_tenant_slos
from oryx_tpu_torch.registry.tracking import record_fleet_skew
from oryx_tpu_torch.serving.autoscale import (
    AutoscaleConfig,
    AutoscalerThread,
    AutoscaleSignals,
    FleetAutoscaler,
)
from oryx_tpu_torch.serving.layer import ServingLayer

REPO_ROOT = Path(__file__).resolve().parents[2]

UPDATE_TOPIC = "OryxUpdate"
INPUT_TOPIC = "OryxInput"


# persistent control-plane connections (keep-alive; thread-local inside)
_client = engine.KeepAliveClient(timeout_s=10.0)


def _http(method: str, url: str, timeout: float = 10.0):
    status, _, body, _ = _client.request(url, method=method, timeout=timeout)
    return status, body


class FleetHarness:
    """N in-process ServingLayer replicas on one (chaos-wrapped) update
    topic plus the harness-side machinery to publish generations, roll
    back, flip chaos levers, and drain-restart replicas."""

    def __init__(
        self,
        n_replicas: int,
        work_dir: str,
        bus_name: str = "fleet",
        chaos_seed: int = 7,
        skew_poll_s: float = 0.25,
        overlay: str | None = None,
        tenants: dict[str, dict] | None = None,
    ) -> None:
        self.n_replicas = int(n_replicas)
        self.work_dir = str(work_dir)
        self.inner_locator = f"inproc://{bus_name}"
        # replicas consume through the chaos wrapper; levers start at zero
        # and scenario actions (or schedule_phases) open the fault window
        self.chaos_locator = (
            f"fault+{self.inner_locator}?drop=0&delay_ms=0&dup=0&seed={chaos_seed}"
        )
        self.model_dir = f"{self.work_dir}/model"
        self.data_dir = f"{self.work_dir}/data"
        self.replicas: list[ServingLayer] = []
        self.targets: list[Target] = []
        self.generations: list[str] = []  # publish order, ids = timestamp ms
        self._next_ts = 1000
        self._skew_poll_s = float(skew_poll_s)
        self._skew_thread: threading.Thread | None = None
        self._skew_stop = threading.Event()
        self.skew_samples: list[tuple[float, list[str | None], int]] = []
        # extra HOCON overlay applied on top of every replica config
        # (tests tune overload knobs / scripted probe latency through it)
        self.overlay = overlay
        # slots retired by scale_in: the replica is drained+closed but its
        # Target stays in self.targets (ready=False) so the engine's
        # round-robin index math never races a shrinking list
        self._retired: set[int] = set()
        self._fleet_lock = threading.Lock()
        self._autoscaler: AutoscalerThread | None = None
        self.autoscaler: FleetAutoscaler | None = None
        # trailing window for the observed-arrival-rate signal, and the
        # latency threshold the burn signals are computed against (the
        # scenario's SLO p99 when driven via run_scenario)
        self.rate_window_s = 2.0
        self.slo_p99_ms = 1000.0
        # scripted-feedback producer on the input topic (attach_feedback)
        self._feedback_producer = None
        # multi-tenant fleet (docs/multi-tenancy.md): tenant id ->
        # {"weight": w, "slo_p99_ms": p99} declared on every replica as
        # probe-app tenants; each gets its own namespaced update topic
        # (OryxUpdate.<tenant>) and model lineage (model/<tenant>)
        self.tenants = dict(tenants) if tenants else None
        self.tenant_generations: dict[str, list[str]] = {}
        self._tenant_rate_prev: tuple[float, dict | None] = (time.monotonic(), None)

    # -- replica lifecycle ---------------------------------------------------

    def _replica_config(self, metric: float = 1.0):
        cfg = C.get_default().with_overlay(
            f"""
            oryx {{
              id = "Fleet"
              input-topic.broker = "{self.inner_locator}"
              update-topic.broker = "{self.chaos_locator}"
              batch.storage {{ data-dir = "{self.data_dir}/"
                               model-dir = "{self.model_dir}/" }}
              serving {{
                api.port = 0
                model-manager-class = "oryx_tpu_torch.registry.testing.PMMLProbeServingModelManager"
                application-resources = "oryx_tpu_torch.registry.testing"
              }}
              ml {{
                eval {{ candidates = 1, test-fraction = 0.5 }}
                gate.max-regression = 0.05
              }}
              test.scripted-metric = {metric}
            }}
            """
        )
        if self.tenants:
            cfg = cfg.with_overlay(self._tenancy_overlay())
        if self.overlay:
            cfg = cfg.with_overlay(self.overlay)
        return cfg

    def _tenancy_overlay(self) -> str:
        blocks = []
        for tid, spec in sorted(self.tenants.items()):
            weight = float(spec.get("weight", 1.0))
            p99 = float(spec.get("slo_p99_ms", 500.0))
            blocks.append(
                f'{tid} {{ app = "probe", weight = {weight}, '
                f"slo {{ p99-ms = {p99} }} }}"
            )
        joined = "\n            ".join(blocks)
        return f"""
        oryx.tenancy {{
          enabled = true
          fair-share {{ enabled = true, quantum = 8 }}
          tenants {{
            {joined}
          }}
        }}
        """

    def _start_replica(self) -> ServingLayer:
        layer = ServingLayer(self._replica_config())
        layer.start()
        return layer

    def start(self) -> None:
        if self._skew_thread is not None or self.replicas:
            raise RuntimeError("FleetHarness.start() called twice")
        broker = bus.get_broker(self.inner_locator)
        broker.create_topic(UPDATE_TOPIC, 1)
        if self.tenants:
            for tid in self.tenants:
                broker.create_topic(f"{UPDATE_TOPIC}.{tid}", 1)
        try:
            for i in range(self.n_replicas):
                layer = self._start_replica()
                self.replicas.append(layer)
                self.targets.append(
                    Target(f"replica-{i}", f"http://127.0.0.1:{layer.port}")
                )
        except BaseException:
            # partial fleet bring-up: tear down the replicas that DID
            # start so an aborted run strands no servers or consumers
            self.stop()
            raise
        self._skew_stop.clear()
        self._skew_thread = threading.Thread(
            target=self._watch_skew, name="FleetSkewWatch", daemon=True
        )
        self._skew_thread.start()

    def stop(self) -> None:
        self.stop_autoscaler()
        self._skew_stop.set()
        t, self._skew_thread = self._skew_thread, None
        if t is not None:
            t.join(timeout=self._skew_poll_s + 2.0)
        with self._fleet_lock:
            replicas, self.replicas = list(self.replicas), []
            self.targets.clear()
            self._retired.clear()
        errors = []
        for layer in replicas:
            try:
                layer.close()
            except Exception as e:  # close the rest before surfacing
                errors.append(e)
        producer, self._feedback_producer = self._feedback_producer, None
        if producer is not None:
            try:
                producer.close()
            except Exception as e:
                errors.append(e)
        if errors:
            raise errors[0]

    def __enter__(self) -> "FleetHarness":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- observation ---------------------------------------------------------

    def _live_indices_locked(self) -> list[int]:
        return [i for i in range(len(self.replicas)) if i not in self._retired]

    def live_indices(self) -> list[int]:
        """Slot indices still serving (scale_in tombstones, never pops)."""
        with self._fleet_lock:
            return self._live_indices_locked()

    def replica_count(self) -> int:
        """Live replica count — the autoscaler actuator's view of size."""
        return len(self.live_indices())

    def _live_replicas(self) -> list[ServingLayer]:
        with self._fleet_lock:
            return [self.replicas[i] for i in self._live_indices_locked()]

    def replica_generations(self) -> list[str | None]:
        """Each live replica's generation, straight from the trackers (the
        /healthz body reports the same value over HTTP). Retired slots are
        skipped — a closed replica's last generation is not fleet skew."""
        return [layer.health.live_generation for layer in self._live_replicas()]

    def tenant_generations_by_replica(self) -> list[dict[str, str | None]]:
        """Per live replica: tenant id -> live generation (tenanted fleet)."""
        return [
            layer.tenant_mux.live_generations()
            if getattr(layer, "tenant_mux", None) is not None
            else {}
            for layer in self._live_replicas()
        ]

    def wait_tenants_converged(
        self, want: dict[str, str], timeout: float = 15.0
    ) -> bool:
        """True once every replica serves `want[tenant]` for every tenant."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            per = self.tenant_generations_by_replica()
            if per and all(
                d.get(tid) == gen for d in per for tid, gen in want.items()
            ):
                return True
            time.sleep(0.05)
        return False

    def _watch_skew(self) -> None:
        t0 = time.monotonic()
        while not self._skew_stop.wait(self._skew_poll_s):
            if self.tenants:
                # per-tenant skew on a tenanted fleet: the worst tenant's
                # skew is the fleet's (one lagging tenant on one replica
                # IS divergence users can see)
                per = self.tenant_generations_by_replica()
                skew = 0
                gens: list = []
                for tid in sorted(self.tenants):
                    tenant_gens = [d.get(tid) for d in per]
                    skew = max(skew, record_fleet_skew(tenant_gens))
                    gens.append(tenant_gens)
                self.skew_samples.append((time.monotonic() - t0, gens, skew))
                continue
            gens = self.replica_generations()
            skew = record_fleet_skew(gens)
            self.skew_samples.append((time.monotonic() - t0, gens, skew))

    def metrics_snapshot(self, replica: int) -> dict:
        status, body = _http(
            "GET", f"{self.targets[replica].base_url}/metrics"
        )
        if status != 200:
            return {}
        return json.loads(body)

    def wait_converged(self, generation: str, timeout: float = 10.0) -> bool:
        """True once every live replica names `generation` (skew settled)
        and answers /readyz 200. The tracker names a generation when it
        filters the MODEL, a beat before the manager has applied it, and
        readiness follows the apply: the JAX package's harness returns on
        the tracker alone, so /readyz could still answer 503 just after."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(g == generation for g in self.replica_generations()) and self._all_ready():
                return True
            time.sleep(0.05)
        return False

    def _all_ready(self) -> bool:
        """Every live replica answers /readyz 200."""
        for i in self.live_indices():
            try:
                status, _ = _http("GET", f"{self.targets[i].base_url}/readyz", timeout=2.0)
            except (OSError, http.client.HTTPException):
                return False
            if status != 200:
                return False
        return True

    # -- online experiments (docs/experiments.md) ----------------------------

    def challenger_generations(self) -> list[str | None]:
        """Each live replica's challenger generation (None = no active
        experiment on that replica)."""
        return [layer.health.challenger_generation for layer in self._live_replicas()]

    def wait_challenger(self, generation: str, timeout: float = 10.0) -> bool:
        """True once every replica tracks `generation` as the challenger."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(g == generation for g in self.challenger_generations()):
                return True
            time.sleep(0.05)
        return False

    def experiment_report(self, replica: int) -> dict:
        """One replica's GET /experiments body."""
        status, body = _http("GET", f"{self.targets[replica].base_url}/experiments")
        if status != 200:
            return {}
        return json.loads(body)

    def attach_feedback(self, hit_rates: dict, default: float = 0.0, seed: int = 7):
        """Wire scripted interaction feedback into the fleet: returns a
        ScriptedFeedback whose events land on the fleet's input topic
        (raw inner broker — feedback is user behavior, not chaos target),
        for use as OpenLoopEngine(..., on_response=fb.on_response).
        `hit_rates` maps generation id -> engagement probability;
        unknown generations engage at `default`."""
        from oryx_tpu_torch.loadgen import ScriptedFeedback

        broker = bus.get_broker(self.inner_locator)
        broker.create_topic(INPUT_TOPIC, 1)
        if self._feedback_producer is None:
            self._feedback_producer = broker.producer(INPUT_TOPIC)
        producer = self._feedback_producer

        def send(line: str) -> None:
            producer.send(None, line)

        return ScriptedFeedback(
            send, lambda gen: hit_rates.get(gen, default), seed=seed
        )

    # -- scenario actions ----------------------------------------------------

    def publish(self, metric: float = 1.0) -> str:
        """Run one ScriptedMetricUpdate batch generation against the shared
        model dir and publish it on the update topic (through the RAW inner
        broker — the batch layer is not the chaos target here)."""
        from oryx_tpu_torch.registry.testing import ScriptedMetricUpdate

        ts = self._next_ts
        self._next_ts += 1000
        update = ScriptedMetricUpdate(self._replica_config(metric))
        data = [KeyMessage(None, f"r{i}") for i in range(6)]
        broker = bus.get_broker(self.inner_locator)
        with broker.producer(UPDATE_TOPIC) as producer:
            update.run_update(ts, data, [], self.model_dir, producer)
        self.generations.append(str(ts))
        return str(ts)

    def publish_tenant(self, tenant: str, metric: float = 1.0) -> str:
        """One batch generation for ONE tenant: the model lands in that
        tenant's model lineage (model/<tenant>) and the MLUpdate goes out
        on the tenant's namespaced update topic (OryxUpdate.<tenant>), so
        only that tenant's serving consumers see it."""
        from oryx_tpu_torch.registry.testing import ScriptedMetricUpdate

        if not self.tenants or tenant not in self.tenants:
            raise ValueError(f"unknown tenant {tenant!r}")
        ts = self._next_ts
        self._next_ts += 1000
        update = ScriptedMetricUpdate(self._replica_config(metric))
        data = [KeyMessage(None, f"r{i}") for i in range(6)]
        broker = bus.get_broker(self.inner_locator)
        with broker.producer(f"{UPDATE_TOPIC}.{tenant}") as producer:
            update.run_update(
                ts, data, [], f"{self.model_dir}/{tenant}", producer
            )
        self.tenant_generations.setdefault(tenant, []).append(str(ts))
        return str(ts)

    def _resolve_generation(self, generation: str) -> str:
        if generation == "first":
            return self.generations[0]
        if generation == "previous":
            return self.generations[-2]
        return generation

    def rollback(self, generation: str = "previous", replica: int = 0) -> str:
        gen = self._resolve_generation(str(generation))
        status, body = _http(
            "POST", f"{self.targets[replica].base_url}/model/rollback/{gen}"
        )
        if status != 200:
            raise RuntimeError(f"rollback to {gen} failed: {status} {body[:200]!r}")
        self.generations.append(gen)
        return gen

    def chaos(self, **levers) -> None:
        """Set the fault-bus levers (drop / delay_ms / dup / outage) on the
        replicas' update-topic consumption path."""
        faultbus.set_levers(self.chaos_locator, **levers)

    def chaos_phases(self, phases: list[dict]) -> None:
        faultbus.schedule_phases(self.chaos_locator, phases)

    def restart(self, replica: int = 0, drain_s: float = 5.0) -> None:
        """Drain-aware rolling restart: readiness flips to 503, the load
        router stops sending within its poll interval, in-flight requests
        complete, the replica closes, and a fresh one takes its slot (and
        its Target, at a new port) once it has replayed the topic."""
        old = self.replicas[replica]
        try:
            old.begin_drain()
            # let readiness pollers observe the 503 before tearing down
            time.sleep(0.6)
            old.drain(drain_s)
        finally:
            # the old replica must die even when the drain protocol blows
            # up — a stranded replica keeps its server + consumer alive
            # and the slot would point at a half-drained layer
            old.close()
        fresh = self._start_replica()
        with self._fleet_lock:
            self.replicas[replica] = fresh
            self.targets[replica].base_url = f"http://127.0.0.1:{fresh.port}"

    # -- elastic capacity (autoscaler actuator) ------------------------------

    def scale_out(self) -> bool:
        """Start one fresh replica and add it to the routable set. The new
        Target starts ready=False: the engine's readiness poller flips it
        once /readyz goes 200 (model replayed), so a cold replica never
        catches a request it cannot answer."""
        with self._fleet_lock:
            layer = self._start_replica()
            i = len(self.replicas)
            target = Target(f"replica-{i}", f"http://127.0.0.1:{layer.port}")
            target.ready = False
            self.replicas.append(layer)
            self.targets.append(target)
        return True

    def scale_in(self, drain_s: float = 5.0) -> bool:
        """Retire the newest live replica, drain-first: readiness flips to
        503, the router stops sending within its poll interval, in-flight
        requests complete, then the replica closes. The slot is tombstoned
        (Target stays in the list, ready=False) so concurrent round-robin
        picks never index a shrinking list. Returns False when only one
        live replica remains — the fleet never scales to zero."""
        with self._fleet_lock:
            live = self._live_indices_locked()
            if len(live) <= 1:
                return False
            i = live[-1]
            self._retired.add(i)
            layer = self.replicas[i]
            target = self.targets[i]
        try:
            layer.begin_drain()
            # let readiness pollers observe the 503 before tearing down
            time.sleep(0.6)
            layer.drain(drain_s)
        finally:
            layer.close()
            target.ready = False
        return True

    def scale(self, direction: str = "out", drain_s: float = 5.0) -> bool:
        """Scenario-action form: {"do": "scale", "direction": "in"}."""
        if direction == "out":
            return self.scale_out()
        return self.scale_in(drain_s)

    def autoscale_signals(self) -> AutoscaleSignals:
        """Snapshot the policy inputs from the load targets' client-side
        SLOWindows (arrival rate, latency burn vs. the scenario p99) and
        the replicas' admission controllers (queue-wait pressure)."""
        rate = sum(
            t.slo.count(self.rate_window_s) for t in self.targets
        ) / max(self.rate_window_s, 1e-9)
        threshold_s = self.slo_p99_ms / 1000.0
        burn_short = burn_long = 0.0
        cfg = self.autoscaler.cfg if self.autoscaler is not None else None
        w_short = cfg.burn_window_short_s if cfg else 5.0
        w_long = cfg.burn_window_long_s if cfg else 30.0
        for t in self.targets:
            burn_short = max(t.slo.latency_burn_rate(w_short, threshold_s, 0.01), burn_short)
            burn_long = max(t.slo.latency_burn_rate(w_long, threshold_s, 0.01), burn_long)
        queue_wait_ms = 0.0
        for layer in self._live_replicas():
            wait_ms, _depth, _inflight = layer._overload_signals()
            queue_wait_ms = max(queue_wait_ms, wait_ms)
        return AutoscaleSignals(
            rate=rate,
            queue_wait_ms=queue_wait_ms,
            burn_short=burn_short,
            burn_long=burn_long,
            tenant_rates=self._tenant_rates(),
        )

    def _tenant_rates(self) -> dict[str, float]:
        """Per-tenant arrival rates by differencing the replicas'
        serving.requests.tenant.<id> counters between signal snapshots
        (server-side attribution — the load targets don't know tenants)."""
        if not self.tenants:
            return {}
        now = time.monotonic()
        totals = {
            tid: float(
                sum(
                    layer.instance_metrics.counter(
                        f"serving.requests.tenant.{tid}"
                    ).value
                    for layer in self._live_replicas()
                )
            )
            for tid in self.tenants
        }
        prev_t, prev = self._tenant_rate_prev
        self._tenant_rate_prev = (now, totals)
        dt = now - prev_t
        if prev is None or dt <= 0:
            return {tid: 0.0 for tid in totals}
        return {
            tid: max(0.0, totals[tid] - prev.get(tid, 0.0)) / dt
            for tid in totals
        }

    def start_autoscaler(self, cfg: AutoscaleConfig | None = None) -> FleetAutoscaler:
        """Run the predictive/reactive sizing policy against this harness
        on a control thread. cfg defaults to the replica config's
        oryx.fleet.autoscale block (force enabled — calling this IS the
        opt-in)."""
        if self._autoscaler is not None:
            raise RuntimeError("autoscaler already running")
        if cfg is None:
            import dataclasses

            cfg = dataclasses.replace(
                AutoscaleConfig.from_config(self._replica_config()), enabled=True
            )
        self.autoscaler = FleetAutoscaler(
            actuator=self, signals=self.autoscale_signals, cfg=cfg
        )
        self._autoscaler = AutoscalerThread(self.autoscaler)
        self._autoscaler.start()
        return self.autoscaler

    def stop_autoscaler(self) -> None:
        t, self._autoscaler = self._autoscaler, None
        if t is not None:
            t.stop()

    def handlers(self) -> dict:
        return {
            "publish": self.publish,
            "publish-tenant": self.publish_tenant,
            "rollback": self.rollback,
            "chaos": self.chaos,
            "restart": self.restart,
            "scale": self.scale,
        }


# -- crash campaign: replicas as real processes, SIGKILL as the verb ---------


def _process_replica_config(work_dir: str, slot_dir: str):
    """Config for one subprocess replica: a file-backed bus both sides of
    the process boundary can see (inproc cannot cross it), the shared
    model dir, and a per-slot restage cache so the MODEL-REF download
    path is part of what the kill interrupts."""
    return C.get_default().with_overlay(
        f"""
        oryx {{
          id = "Fleet"
          input-topic.broker = "file:{work_dir}/bus"
          update-topic.broker = "file:{work_dir}/bus"
          batch.storage {{ data-dir = "{work_dir}/data/"
                           model-dir = "{work_dir}/model/" }}
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.registry.testing.PMMLProbeServingModelManager"
            application-resources = "oryx_tpu_torch.registry.testing"
            restage-dir = "{slot_dir}/cache"
          }}
          ml {{
            eval {{ candidates = 1, test-fraction = 0.5 }}
            gate.max-regression = 0.05
          }}
          test.scripted-metric = 0.9
        }}
        """
    )


def serve_replica(work_dir: str, slot_dir: str) -> int:
    """Child entry point (--serve-replica): run one ServingLayer until
    SIGTERM (clean close) — or SIGKILL, which is the point."""
    from oryx_tpu_torch.common import storage

    slot = Path(slot_dir)
    slot.mkdir(parents=True, exist_ok=True)
    layer = ServingLayer(_process_replica_config(work_dir, slot_dir))
    layer.start()
    # the port commit is the parent's only discovery channel — atomic, so
    # the parent never reads a half-written port
    storage.commit_text(slot / "port", str(layer.port))
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(0.5):
            pass
    finally:
        layer.close()
    return 0


class ReplicaProcess:
    """One serving replica as a child process: spawn, readiness, SIGKILL,
    respawn — the crash campaign's unit of failure."""

    def __init__(self, index: int, work_dir: str) -> None:
        self.index = index
        self.work_dir = str(work_dir)
        self.slot_dir = Path(work_dir) / f"replica-{index}"
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None

    def spawn(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            raise RuntimeError(f"replica {self.index} is already running")
        self.slot_dir.mkdir(parents=True, exist_ok=True)
        (self.slot_dir / "port").unlink(missing_ok=True)
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [
                sys.executable, "-m", "oryx_tpu_torch.tools.fleet",
                "--serve-replica", str(self.slot_dir), "--work-dir", self.work_dir,
                # the child computes where this process does
                "--device", port_device.default_device().type,
            ],
            env=env,
            cwd=str(REPO_ROOT),
        )

    def wait_ready(self, timeout: float = 60.0) -> float:
        """Block until the replica answers /readyz 200; returns seconds
        waited (the recovery-time measurement when called after a kill)."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        port_file = self.slot_dir / "port"
        while time.monotonic() < deadline:
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica-{self.index} died during startup "
                    f"(rc={self.proc.returncode})"
                )
            if self.port is None:
                try:
                    self.port = int(port_file.read_text())
                except (OSError, ValueError):
                    time.sleep(0.05)
                    continue
            try:
                status, _ = _http("GET", f"{self.base_url}/readyz", timeout=2.0)
                if status == 200:
                    return time.monotonic() - t0
            except Exception:  # noqa: BLE001 - server not up yet
                pass
            time.sleep(0.05)
        raise TimeoutError(f"replica-{self.index} not ready within {timeout}s")

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def kill(self) -> None:
        """SIGKILL — no drain, no close() chain, no atexit."""
        if self.proc is not None:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=30)
        self.port = None

    def terminate(self, timeout: float = 15.0) -> None:
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self.proc = None
        self.port = None


class ProcessFleet:
    """N subprocess replicas over one file-backed update topic, plus the
    `crash` scenario verb (SIGKILL + respawn + recovery-time measurement).
    Duck-types the FleetHarness surface run_scenario needs (targets,
    handlers(), slo_p99_ms)."""

    def __init__(self, n_replicas: int, work_dir: str) -> None:
        self.n_replicas = int(n_replicas)
        self.work_dir = str(work_dir)
        self.model_dir = f"{self.work_dir}/model"
        self.replicas = [ReplicaProcess(i, work_dir) for i in range(self.n_replicas)]
        self.targets: list[Target] = []
        self.generations: list[str] = []
        self._next_ts = 1000
        self.slo_p99_ms = 1000.0
        # one entry per crash verb: {"replica", "recovery_seconds"}; the
        # last measurement also lands on the recovery.seconds gauge
        self.crash_events: list[dict] = []

    def publish(self, metric: float = 0.9) -> str:
        """One ScriptedMetricUpdate batch generation onto the shared file
        bus (the replicas replay it on boot — publish before start)."""
        from oryx_tpu_torch.registry.testing import ScriptedMetricUpdate

        ts = self._next_ts
        self._next_ts += 1000
        update = ScriptedMetricUpdate(
            _process_replica_config(self.work_dir, f"{self.work_dir}/publisher")
        )
        data = [KeyMessage(None, f"r{i}") for i in range(6)]
        broker = bus.get_broker(f"file:{self.work_dir}/bus")
        with broker.producer(UPDATE_TOPIC) as producer:
            update.run_update(ts, data, [], self.model_dir, producer)
        self.generations.append(str(ts))
        return str(ts)

    def start(self, ready_timeout: float = 60.0) -> None:
        broker = bus.get_broker(f"file:{self.work_dir}/bus")
        broker.create_topic(UPDATE_TOPIC, 1)
        broker.create_topic(INPUT_TOPIC, 1)
        if not self.generations:
            self.publish()
        try:
            for r in self.replicas:
                r.spawn()
            for r in self.replicas:
                r.wait_ready(timeout=ready_timeout)
                self.targets.append(Target(f"replica-{r.index}", r.base_url))
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        for r in self.replicas:
            r.terminate()
        self.targets.clear()

    def __enter__(self) -> "ProcessFleet":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def crash(self, replica: int = 1, recovery_timeout: float = 60.0) -> float:
        """The crash verb: SIGKILL one replica mid-traffic (no drain — the
        router discovers the death by connection refusal and fails over),
        respawn it in the same slot, and measure SIGKILL -> /readyz 200.
        The respawned replica re-repairs its restage cache and replays
        the update topic; the measurement is the whole recovery, not just
        process start."""
        from oryx_tpu_torch.common import metrics

        r = self.replicas[replica]
        t0 = time.monotonic()
        r.kill()
        self.targets[replica].ready = False
        r.spawn()
        r.wait_ready(timeout=recovery_timeout)
        recovery_s = time.monotonic() - t0
        self.targets[replica].base_url = r.base_url
        # the readiness poller re-promotes the target from /readyz
        metrics.registry.gauge("recovery.seconds").set(recovery_s)
        self.crash_events.append(
            {"replica": replica, "recovery_seconds": round(recovery_s, 3)}
        )
        return recovery_s

    def handlers(self) -> dict:
        return {"publish": self.publish, "crash": self.crash}


def crash_scenario(rate: float, seconds: float, replica: int = 1, seed: int = 7) -> Scenario:
    """The crash-campaign proof: hold an open-loop offered rate against 3
    replicas and SIGKILL one mid-run. The SLO demands zero failed
    requests — in-flight requests to the killed replica must fail over to
    survivors — and p99 within budget on the fleet that remains."""
    return Scenario.from_dict(
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
            "actions": [{"at": seconds * 0.35, "do": "crash", "replica": replica}],
        }
    )


def run_crash_campaign(
    replicas: int,
    rate: float,
    seconds: float,
    work_dir: str,
    seed: int = 7,
    recovery_budget_s: float = 30.0,
) -> dict:
    """3-replica open-loop run, one SIGKILL, recovery measured. Returns
    the campaign report."""
    with ProcessFleet(replicas, work_dir) as fleet:
        scenario = crash_scenario(rate, seconds, seed=seed)
        result, verdict, runner = run_scenario(fleet, scenario)
        # run_scenario stops the timeline with the traffic and gives an
        # action in flight 5 s more; a respawn slower than that (a loaded
        # host) would leave the crash out of the report. Wait for it,
        # within the recovery budget, and judge what it raised.
        seen = len(runner.errors)
        runner.join(timeout=recovery_budget_s)
        for action, err in runner.errors[seen:]:
            verdict.passed = False
            verdict.violations.append(f"scenario action {action.do}@{action.at}: {err!r}")
    s = result.summary()
    recovery = [e["recovery_seconds"] for e in fleet.crash_events]
    return {
        "replicas": replicas,
        "crashes": len(fleet.crash_events),
        "recovery_seconds": recovery,
        "recovery_budget_s": recovery_budget_s,
        "recovery_within_budget": all(r <= recovery_budget_s for r in recovery),
        "scenario_actions": [a.do for a in runner.executed],
        "slo": {
            "passed": verdict.passed,
            "p99_ms": round(verdict.p99_ms, 2),
            "error_rate": verdict.error_rate,
            "violations": verdict.violations,
        },
        **s,
    }


def run_scenario(
    harness: FleetHarness,
    scenario: Scenario,
    max_inflight: int = 128,
    timeout_s: float = 10.0,
    on_response=None,
    tenant_mix: dict[str, float] | None = None,
):
    """Drive one scripted scenario: traffic + action timeline + verdict.
    Returns (LoadResult, SLOVerdict, ScenarioRunner).

    `tenant_mix` (tenant id -> weight) makes the engine stamp each request
    with a tenant drawn from the mix and route it via the /t/<tenant>
    path prefix; a scenario "tenant-mix" action rebalances the mix
    mid-run (the noisy-neighbour burst)."""
    # the autoscaler's burn signals judge against the scenario's own SLO
    harness.slo_p99_ms = scenario.slo.p99_ms
    engine = OpenLoopEngine(
        harness.targets,
        template=scenario.template,
        max_inflight=max_inflight,
        timeout_s=timeout_s,
        on_response=on_response,
        tenant_mix=tenant_mix,
    )
    handlers = harness.handlers()
    if tenant_mix is not None:
        handlers["tenant-mix"] = lambda **mix: engine.set_tenant_mix(mix)
    runner = ScenarioRunner(scenario.actions, handlers)
    runner.start()
    try:
        result = engine.run(
            scenario.build_arrivals(), scenario.build_skew(), scenario.duration_s
        )
    finally:
        runner.stop()
        runner.join(timeout=5.0)
    verdict = evaluate_slo(result, scenario.slo)
    for action, err in runner.errors:
        verdict.passed = False
        verdict.violations.append(f"scenario action {action.do}@{action.at}: {err!r}")
    return result, verdict, runner


def default_scenario(rate: float, seconds: float, seed: int = 7) -> Scenario:
    """The rotation-under-chaos proof: publish gen B mid-run, open a
    drop/delay/dup chaos window on the update bus, close it, then roll
    back to gen A — all while the generator holds the offered rate."""
    return Scenario.from_dict(
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
            # ordering is load-bearing: the chaos window opens BEFORE the
            # publish so generation B's MODEL delivery is what gets
            # dropped/delayed/duplicated, and it closes well before the
            # rollback so a stashed duplicate of B cannot redeliver after
            # A is re-published (which would swap the fleet back)
            "actions": [
                {"at": seconds * 0.25, "do": "chaos", "drop": 0.25, "delay_ms": 5, "dup": 0.25},
                {"at": seconds * 0.35, "do": "publish", "metric": 0.95},
                {"at": seconds * 0.60, "do": "chaos", "drop": 0, "delay_ms": 0, "dup": 0},
                {"at": seconds * 0.80, "do": "rollback", "generation": "first"},
            ],
        }
    )


def parse_tenant_arg(arg: str) -> dict[str, dict]:
    """``"als:2,kmeans:1,rdf:1"`` -> {"als": {"weight": 2.0}, ...}."""
    tenants: dict[str, dict] = {}
    for part in arg.split(","):
        part = part.strip()
        if not part:
            continue
        tid, _, w = part.partition(":")
        tenants[tid.strip()] = {"weight": float(w) if w else 1.0}
    if not tenants:
        raise ValueError(f"no tenants in {arg!r}")
    return tenants


def run_tenant_fleet(args, work_dir: str) -> int:
    """--tenants mode: one shared fleet, N probe-app tenants, traffic
    split by weight, per-tenant generations and per-tenant SLO verdicts
    in the report. Exit 0 only when EVERY tenant passes its SLO."""
    tenants = parse_tenant_arg(args.tenants)
    scenario = (
        Scenario.from_file(args.scenario)
        if args.scenario
        else default_tenant_scenario(args.rate, args.seconds, args.seed)
    )
    with FleetHarness(
        args.replicas, work_dir, chaos_seed=args.seed, tenants=tenants
    ) as fleet:
        want = {
            tid: fleet.publish_tenant(tid, metric=0.90) for tid in tenants
        }
        if not fleet.wait_tenants_converged(want, timeout=20.0):
            print("fleet: replicas never converged on every tenant's generation")
            return 2
        if args.autoscale:
            fleet.start_autoscaler()
        mix = {tid: spec["weight"] for tid, spec in tenants.items()}
        result, verdict, runner = run_scenario(
            fleet, scenario, max_inflight=args.max_inflight, tenant_mix=mix
        )
        fleet.stop_autoscaler()
        specs = {
            tid: SLOSpec(
                p99_ms=float(spec.get("slo_p99_ms", scenario.slo.p99_ms)),
                error_rate=scenario.slo.error_rate,
            )
            for tid, spec in tenants.items()
        }
        tenant_verdicts = evaluate_tenant_slos(result, specs)
        report = {
            "replicas": args.replicas,
            "tenants": sorted(tenants),
            "scenario_actions": [a.do for a in runner.executed],
            "tenant_generations": fleet.tenant_generations,
            "max_skew_observed": max(
                (s for _, _, s in fleet.skew_samples), default=0
            ),
            "slo": {
                "passed": verdict.passed,
                "p99_ms": round(verdict.p99_ms, 2),
                "error_rate": verdict.error_rate,
                "violations": verdict.violations,
            },
            "tenant_slo": {
                tid: {
                    "passed": v.passed,
                    "p99_ms": round(v.p99_ms, 2),
                    "error_rate": v.error_rate,
                    "violations": v.violations,
                }
                for tid, v in sorted(tenant_verdicts.items())
            },
            **result.summary(),
        }
        print(json.dumps(report, indent=2))
        ok = verdict.passed and all(v.passed for v in tenant_verdicts.values())
        return 0 if ok else 1


def default_tenant_scenario(rate: float, seconds: float, seed: int = 7) -> Scenario:
    """The multi-tenant fairness proof: steady weighted traffic across
    the tenants, then a mid-run noisy-neighbour burst (one tenant's mix
    weight multiplied 10x) that the DRR batcher and per-tenant admission
    ladders must contain — victims keep their p99, zero failures."""
    return Scenario.from_dict(
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
            # the burst rebalances the mix, not the offered rate: the
            # noisy tenant crowds the queue, it does not add capacity
            # pressure the fleet was never sized for
            "actions": [],
        }
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--rate", type=float, default=150.0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--scenario", default=None, help="scenario JSON file")
    ap.add_argument("--work-dir", default=None, help="model/data dir (default: temp)")
    ap.add_argument("--max-inflight", type=int, default=128)
    ap.add_argument(
        "--autoscale",
        action="store_true",
        help="run the predictive/reactive autoscaler during the scenario",
    )
    ap.add_argument(
        "--crash",
        action="store_true",
        help="crash campaign: subprocess replicas, one SIGKILL mid-run, "
        "per-replica recovery-time measurement",
    )
    ap.add_argument(
        "--recovery-budget",
        type=float,
        default=30.0,
        help="crash campaign: max allowed SIGKILL->/readyz seconds",
    )
    ap.add_argument(
        "--serve-replica",
        metavar="SLOT_DIR",
        default=None,
        help="internal: run one subprocess serving replica in this slot",
    )
    ap.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the replicas compute: the card (default), or the CPU for tests",
    )
    ap.add_argument(
        "--tenants",
        default=None,
        metavar="ID:WEIGHT,...",
        help="multi-tenant fleet: comma-separated tenant:weight pairs "
        '(e.g. "als:2,kmeans:1,rdf:1"); traffic is split by weight and '
        "each tenant gets its own model lineage and SLO verdict",
    )
    args = ap.parse_args(argv)
    if args.device == "cpu":
        port_device.set_device("cpu")

    if args.serve_replica:
        return serve_replica(args.work_dir, args.serve_replica)

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        work_dir = args.work_dir or tmp
        if args.crash:
            report = run_crash_campaign(
                args.replicas, args.rate, args.seconds, work_dir,
                seed=args.seed, recovery_budget_s=args.recovery_budget,
            )
            print(json.dumps(report, indent=2))
            ok = (
                report["slo"]["passed"]
                and report["failed"] == 0
                and report["recovery_within_budget"]
            )
            return 0 if ok else 1
        if args.tenants:
            return run_tenant_fleet(args, work_dir)
        scenario = (
            Scenario.from_file(args.scenario)
            if args.scenario
            else default_scenario(args.rate, args.seconds, args.seed)
        )
        with FleetHarness(args.replicas, work_dir, chaos_seed=args.seed) as fleet:
            first = fleet.publish(metric=0.90)
            if not fleet.wait_converged(first, timeout=15.0):
                print("fleet: replicas never converged on the first generation")
                return 2
            if args.autoscale:
                fleet.start_autoscaler()
            result, verdict, runner = run_scenario(
                fleet, scenario, max_inflight=args.max_inflight
            )
            fleet.stop_autoscaler()
            settled = fleet.wait_converged(fleet.generations[-1], timeout=10.0)
            final_skew = record_fleet_skew(fleet.replica_generations())
            report = {
                "replicas": args.replicas,
                "scenario_actions": [a.do for a in runner.executed],
                "generations": fleet.generations,
                "converged": settled,
                "final_skew": final_skew,
                "replica_count": fleet.replica_count(),
                "scale_events": [
                    {"t": round(e.t, 2), "direction": e.direction, "reason": e.reason,
                     "replicas": e.replicas}
                    for e in (fleet.autoscaler.events if fleet.autoscaler else [])
                ],
                "max_skew_observed": max((s for _, _, s in fleet.skew_samples), default=0),
                "slo": {
                    "passed": verdict.passed,
                    "p99_ms": round(verdict.p99_ms, 2),
                    "error_rate": verdict.error_rate,
                    "violations": verdict.violations,
                },
                **result.summary(),
            }
            print(json.dumps(report, indent=2))
            return 0 if verdict.passed and settled else 1


if __name__ == "__main__":
    raise SystemExit(main())
