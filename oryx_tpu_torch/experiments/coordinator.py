"""Per-replica experiment coordinator: owns the arm router, the online
evaluator, and the evidence-gated promotion loop.

One coordinator lives inside each ServingLayer when ``oryx.serving.ab``
is enabled and a model registry is configured. It is wired to the
layer's :class:`~oryx_tpu_torch.registry.tracking.GenerationTracker` (which
classifies incoming MODEL records into live vs challenger) and runs a
consumer thread over the *input* topic so interaction events join back
to the serves this replica made.

Promotion is coordinated through the registry, not the bus: evidence is
per-replica, and the first replica whose evidence clears the online
gate's bars applies the decision — ``set_champion`` for a promote, an
``online_status = refused`` manifest annotation for a refuse. Every
other replica polls the CHAMPION pointer and the challenger's manifest
on its gate-check interval and adopts the externally-recorded decision,
so a fleet converges without any new record types on the update topic.

Port note: a copy of ``oryx_tpu/experiments/coordinator.py`` (JAX-free),
with its imports pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import logging
import threading
import time

from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.experiments.evaluator import ExperimentEvaluator
from oryx_tpu_torch.experiments.routing import (
    ABConfig,
    ARM_CHALLENGER,
    ARM_CHAMPION,
    ArmRouter,
)
from oryx_tpu_torch.registry import manifest as manifest_mod
from oryx_tpu_torch.registry.gate import ChampionGate, OnlineDecision

log = logging.getLogger(__name__)

CONSUME_ERRORS_COUNTER = "serving.experiment.consume-errors"
_POLL_TIMEOUT_S = 0.2


class ExperimentCoordinator:
    def __init__(
        self,
        config,
        store,
        instance_metrics=None,
        clock=time.monotonic,
    ) -> None:
        self.ab = ABConfig.from_config(config)
        self.gate = ChampionGate(config)
        self.store = store
        self.router = ArmRouter(self.ab)
        self.evaluator = ExperimentEvaluator(self.ab)
        self.instance_metrics = instance_metrics
        self._clock = clock
        self._tracker = None
        self._lock = threading.Lock()
        self._decision: OnlineDecision | None = None
        self._last_check = 0.0
        self._consumer = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- wiring ----------------------------------------------------------------

    def attach_tracker(self, tracker) -> None:
        self._tracker = tracker

    @property
    def challenger_generation(self) -> str | None:
        return self._tracker.challenger_generation if self._tracker else None

    @property
    def live_generation(self) -> str | None:
        return self._tracker.live_generation if self._tracker else None

    @property
    def active(self) -> bool:
        """True while a challenger is receiving experiment traffic."""
        return self.ab.enabled and self.challenger_generation is not None

    # -- tracker callbacks -----------------------------------------------------

    def wants_challenger(self, generation: str) -> bool:
        """Should a new-generation MODEL record be tracked as the
        challenger? Yes when the registry's CHAMPION pointer names a
        *different* generation — the online gate published this one
        without moving the pointer. A pointer match (rollback republish,
        offline promotion) or a registry without a pointer stays a live
        swap."""
        if not self.ab.enabled or self.store is None:
            return False
        champion = self.store.champion_id()
        return champion is not None and generation != champion

    def on_challenger(self, generation: str | None) -> None:
        """Tracker callback: the challenger id changed."""
        if generation is not None:
            with self._lock:
                self._decision = None
            self.evaluator.reset()
            log.info("experiment started: challenger generation %s", generation)
        self._publish_gauges()

    # -- request path ----------------------------------------------------------

    def assign_request(self, path: str, headers=None):
        """(arm, generation, user) for an attributed request while an
        experiment is active; None otherwise (request proceeds exactly
        as without experiments)."""
        if not self.active:
            return None
        user = self.router.user_of(path, headers)
        if user is None:
            return None
        arm = self.router.assign(user)
        generation = (
            self.challenger_generation if arm == ARM_CHALLENGER else self.live_generation
        )
        return arm, generation, user

    def observe_request(
        self,
        user: str,
        arm: str,
        generation: str | None,
        items,
        latency_s: float | None,
        shed_stage: str | None,
    ) -> None:
        """Record an attributed serve: evaluator join state + per-arm
        instance metrics."""
        self.evaluator.observe_serve(
            user, arm, generation, items, latency_s=latency_s, shed_stage=shed_stage
        )
        im = self.instance_metrics
        if im is None:
            return
        im.counter(f"serving.experiment.requests.{arm}").inc()
        if latency_s is not None:
            im.histogram(f"serving.experiment.request.seconds.{arm}").observe(latency_s)
        if shed_stage:
            im.counter(f"serving.experiment.shed.{arm}.{shed_stage}").inc()

    # -- evaluation loop -------------------------------------------------------

    def start(self, consumer) -> None:
        """Start the input-topic consumer thread (owns `consumer`)."""
        if self._thread is not None:
            raise RuntimeError("experiment coordinator already started")
        self._consumer = consumer
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="oryx-experiment-evaluator", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        consumer = self._consumer
        if consumer is not None:
            try:
                consumer.close()
            except Exception:
                log.debug("experiment consumer close failed", exc_info=True)
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
        self._thread = None
        self._consumer = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                records = self._consumer.poll(max_records=1000, timeout=_POLL_TIMEOUT_S)
                for record in records:
                    self.evaluator.observe_event(record.message)
                self.evaluator.tick()
                now = self._clock()
                if now - self._last_check >= self.gate.online.check_interval_s:
                    self._last_check = now
                    self.check_gate()
            except Exception:
                if self._stop.is_set():
                    return
                metrics.registry.counter(CONSUME_ERRORS_COUNTER).inc()
                log.warning("experiment evaluator loop error", exc_info=True)
                self._stop.wait(_POLL_TIMEOUT_S)

    # -- gate ------------------------------------------------------------------

    def check_gate(self) -> OnlineDecision | None:
        """One gate evaluation: adopt an externally-recorded decision if
        another replica concluded first, else evaluate local evidence
        and apply the outcome. Returns the standing decision."""
        challenger = self.challenger_generation
        if challenger is None or not self.gate.online.enabled:
            self._publish_gauges()
            with self._lock:
                return self._decision
        external = self._external_decision(challenger)
        if external is not None:
            self._conclude(challenger, external, record=False)
            return external
        snap = self.evaluator.snapshot()
        champion_arm = snap["arms"][ARM_CHAMPION]
        challenger_arm = snap["arms"][ARM_CHALLENGER]
        pairs = snap["pairs"]
        decision = self.gate.decide_online(
            champion_samples=champion_arm["resolved"],
            challenger_samples=challenger_arm["resolved"],
            champion_hit_rate=champion_arm["hit_rate"],
            challenger_hit_rate=challenger_arm["hit_rate"],
            challenger_wins=pairs["challenger_wins"],
            champion_wins=pairs["champion_wins"],
        )
        with self._lock:
            self._decision = decision
        if decision.concluded:
            self._conclude(challenger, decision, record=True)
        self._publish_gauges()
        return decision

    def _external_decision(self, challenger: str) -> OnlineDecision | None:
        """A decision another replica already recorded in the registry."""
        try:
            if self.store.champion_id() == challenger:
                return OnlineDecision(
                    verdict="promote", reason="champion pointer moved (peer decision)"
                )
            manifest = self.store.read_manifest(challenger)
        except Exception:
            log.debug("registry poll failed", exc_info=True)
            return None
        if manifest is not None and manifest.online_status == manifest_mod.ONLINE_REFUSED:
            return OnlineDecision(
                verdict="refuse",
                reason=manifest.online_reason or "refused (peer decision)",
            )
        return None

    def _conclude(self, challenger: str, decision: OnlineDecision, record: bool) -> None:
        with self._lock:
            self._decision = decision
        if record:
            self._record_decision(challenger, decision)
        if self._tracker is not None:
            if decision.verdict == "promote":
                self._tracker.promote_challenger()
            else:
                self._tracker.drop_challenger()
        log.info(
            "experiment concluded for generation %s: %s (%s)",
            challenger,
            decision.verdict,
            decision.reason,
        )
        self._publish_gauges()

    def _record_decision(self, challenger: str, decision: OnlineDecision) -> None:
        """First-concluder path: write the decision into the registry so
        the rest of the fleet converges on it."""
        try:
            if decision.verdict == "promote":
                self.store.set_champion(challenger)
            manifest = self.store.read_manifest(challenger)
            if manifest is not None:
                manifest.online_status = (
                    manifest_mod.ONLINE_PROMOTED
                    if decision.verdict == "promote"
                    else manifest_mod.ONLINE_REFUSED
                )
                manifest.online_reason = decision.reason
                manifest.online_samples = {
                    ARM_CHAMPION: decision.champion_samples,
                    ARM_CHALLENGER: decision.challenger_samples,
                }
                manifest.online_lift = decision.lift
                manifest.online_confidence = decision.confidence
                self.store.write_manifest(manifest)
        except Exception:
            log.warning(
                "failed to record online decision for %s", challenger, exc_info=True
            )

    # -- reporting -------------------------------------------------------------

    def _publish_gauges(self) -> None:
        im = self.instance_metrics
        if im is None:
            return
        im.gauge("serving.experiment.active").set(1 if self.active else 0)
        snap = self.evaluator.snapshot()
        for arm in (ARM_CHAMPION, ARM_CHALLENGER):
            stats = snap["arms"][arm]
            im.gauge(f"serving.experiment.resolved.{arm}").set(stats["resolved"])
            if stats["hit_rate"] is not None:
                im.gauge(f"serving.experiment.hit-rate.{arm}").set(stats["hit_rate"])
            if stats["mrr"] is not None:
                im.gauge(f"serving.experiment.mrr.{arm}").set(stats["mrr"])
        pairs = snap["pairs"]
        im.gauge("serving.experiment.pairs").set(
            pairs["challenger_wins"] + pairs["champion_wins"] + pairs["ties"]
        )
        with self._lock:
            decision = self._decision
        if decision is not None:
            if decision.lift is not None:
                im.gauge("serving.experiment.lift").set(decision.lift)
            if decision.confidence is not None:
                im.gauge("serving.experiment.confidence").set(decision.confidence)

    def report(self) -> dict:
        """The serializable ExperimentReport served on GET /experiments
        and by `cli experiments`."""
        with self._lock:
            decision = self._decision
        return {
            "enabled": self.ab.enabled,
            "fraction": self.ab.fraction,
            "active": self.active,
            "champion": self.live_generation,
            "challenger": self.challenger_generation,
            "online_gate": {
                "enabled": self.gate.online.enabled,
                "min_samples": self.gate.online.min_samples,
                "min_lift": self.gate.online.min_lift,
                "max_harm": self.gate.online.max_harm,
                "confidence": self.gate.online.confidence,
            },
            "decision": (
                {
                    "verdict": decision.verdict,
                    "reason": decision.reason,
                    "champion_samples": decision.champion_samples,
                    "challenger_samples": decision.challenger_samples,
                    "lift": decision.lift,
                    "confidence": decision.confidence,
                }
                if decision is not None
                else None
            ),
            "report": self.evaluator.snapshot(),
        }
