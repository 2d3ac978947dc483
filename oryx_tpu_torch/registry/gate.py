"""Champion/challenger gate: should a new candidate be published?

The MLUpdate evaluation contract is higher-is-better (MLUpdate.java's
evaluate). The gate compares the freshly-trained challenger's eval metric
against the current champion's (read from its manifest) and blocks the
publish when the challenger regresses by more than
``oryx.ml.gate.max-regression`` — an *absolute* tolerance in the metric's
own units (negated RMSE for ALS, silhouette-like score for k-means, ...).
A gated generation is still promoted to the model dir with
``status = "gated"`` in its manifest — archived for forensics, invisible
to serving.

The gate is deliberately permissive on missing evidence: no champion yet,
an unreadable champion manifest, a champion with no recorded metric, or a
NaN challenger metric (test-fraction = 0 trains have nothing to evaluate
against) all publish. Gating on absent data would wedge a pipeline that
never evaluates.

Online mode (``oryx.ml.gate.online.*``, docs/experiments.md) layers a
second, evidence-gated stage on top: a candidate that passes the offline
gate is published *without* moving the CHAMPION pointer, serving routes a
slice of traffic to it (``oryx.serving.ab``), and
:meth:`ChampionGate.decide_online` promotes or refuses it from the
accumulated per-arm outcomes — a paired one-sided sign test supplies the
confidence.

Port note: a copy of ``oryx_tpu/registry/gate.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.registry.store import RegistryStore

log = logging.getLogger(__name__)

GATED_COUNTER = "ml.gate.gated"
PASSED_COUNTER = "ml.gate.passed"
ONLINE_PROMOTED_COUNTER = "ml.gate.online.promoted"
ONLINE_REFUSED_COUNTER = "ml.gate.online.refused"


def sign_test_confidence(wins: int, losses: int) -> float:
    """Confidence that the 'wins' side is genuinely better, from a
    one-sided paired sign test: 1 minus the probability of seeing at
    least this many wins out of ``wins + losses`` informative (non-tied)
    pairs under the null of no difference (Binomial(n, 1/2))."""
    n = wins + losses
    if n == 0:
        return 0.0
    tail = sum(math.comb(n, k) for k in range(wins, n + 1)) / 2.0**n
    return 1.0 - tail


@dataclass
class OnlineGateConfig:
    """``oryx.ml.gate.online`` knob block."""

    enabled: bool = False
    min_samples: int = 50
    min_lift: float = 0.0
    max_harm: float = 0.05
    confidence: float = 0.95
    check_interval_s: float = 2.0

    @classmethod
    def from_config(cls, config: Config) -> "OnlineGateConfig":
        block = config.get_config("oryx.ml.gate.online")
        return cls(
            enabled=block.get_bool("enabled"),
            min_samples=block.get_int("min-samples"),
            min_lift=block.get_float("min-lift"),
            max_harm=block.get_float("max-harm"),
            confidence=block.get_float("confidence"),
            check_interval_s=block.get_float("check-interval-s"),
        )


@dataclass
class OnlineDecision:
    """Outcome of one online-gate evaluation."""

    verdict: str  # "promote" | "refuse" | "continue"
    reason: str
    champion_samples: int = 0
    challenger_samples: int = 0
    lift: float | None = None
    confidence: float | None = None

    @property
    def concluded(self) -> bool:
        return self.verdict in ("promote", "refuse")


@dataclass
class GateDecision:
    publish: bool
    reason: str | None = None
    champion_id: str | None = None
    champion_metric: float | None = None
    candidate_metric: float | None = None


class ChampionGate:
    def __init__(self, config: Config) -> None:
        self.max_regression = config.get_optional_float("oryx.ml.gate.max-regression")
        self.online = OnlineGateConfig.from_config(config)

    @property
    def enabled(self) -> bool:
        return self.max_regression is not None

    def decide_online(
        self,
        champion_samples: int,
        challenger_samples: int,
        champion_hit_rate: float | None,
        challenger_hit_rate: float | None,
        challenger_wins: int,
        champion_wins: int,
    ) -> OnlineDecision:
        """Evaluate accumulated online evidence against the promotion
        bars. Sample counts are *resolved* outcomes per arm; wins are
        the informative (non-tied) pairs from index-paired outcomes."""
        cfg = self.online
        if champion_samples < cfg.min_samples or challenger_samples < cfg.min_samples:
            return OnlineDecision(
                verdict="continue",
                reason=(
                    f"insufficient samples (champion {champion_samples}, "
                    f"challenger {challenger_samples}, need {cfg.min_samples} each)"
                ),
                champion_samples=champion_samples,
                challenger_samples=challenger_samples,
            )
        if champion_hit_rate is None or challenger_hit_rate is None:
            return OnlineDecision(
                verdict="continue",
                reason="hit rates not yet defined",
                champion_samples=champion_samples,
                challenger_samples=challenger_samples,
            )
        lift = challenger_hit_rate - champion_hit_rate
        promote_conf = sign_test_confidence(challenger_wins, champion_wins)
        refuse_conf = sign_test_confidence(champion_wins, challenger_wins)
        base = dict(
            champion_samples=champion_samples,
            challenger_samples=challenger_samples,
            lift=lift,
        )
        if lift >= cfg.min_lift and promote_conf >= cfg.confidence:
            decision = OnlineDecision(
                verdict="promote",
                reason=(
                    f"lift {lift:.4f} >= min-lift {cfg.min_lift} at "
                    f"confidence {promote_conf:.4f} >= {cfg.confidence} "
                    f"({challenger_wins}/{champion_wins} informative pairs)"
                ),
                confidence=promote_conf,
                **base,
            )
            metrics.registry.counter(ONLINE_PROMOTED_COUNTER).inc()
            log.info("online gate: %s", decision.reason)
            return decision
        if lift <= -cfg.max_harm and refuse_conf >= cfg.confidence:
            decision = OnlineDecision(
                verdict="refuse",
                reason=(
                    f"harm {-lift:.4f} >= max-harm {cfg.max_harm} at "
                    f"confidence {refuse_conf:.4f} >= {cfg.confidence} "
                    f"({champion_wins}/{challenger_wins} informative pairs)"
                ),
                confidence=refuse_conf,
                **base,
            )
            metrics.registry.counter(ONLINE_REFUSED_COUNTER).inc()
            log.warning("online gate: %s", decision.reason)
            return decision
        return OnlineDecision(
            verdict="continue",
            reason=(
                f"evidence inconclusive (lift {lift:.4f}, promote confidence "
                f"{promote_conf:.4f}, refuse confidence {refuse_conf:.4f})"
            ),
            confidence=max(promote_conf, refuse_conf),
            **base,
        )

    def decide(self, store: RegistryStore, candidate_metric: float | None) -> GateDecision:
        if not self.enabled:
            return GateDecision(publish=True, reason="gate disabled")
        champion_id = store.champion_id()
        if champion_id is None:
            return self._passed(GateDecision(publish=True, reason="no champion yet"))
        manifest = store.read_manifest(champion_id)
        champion_metric = manifest.eval_metric if manifest is not None else None
        if champion_metric is None or math.isnan(champion_metric):
            return self._passed(
                GateDecision(
                    publish=True,
                    reason="champion has no recorded eval metric",
                    champion_id=champion_id,
                )
            )
        if candidate_metric is None or math.isnan(candidate_metric):
            return self._passed(
                GateDecision(
                    publish=True,
                    reason="candidate has no eval metric (nothing to compare)",
                    champion_id=champion_id,
                    champion_metric=champion_metric,
                )
            )
        regression = champion_metric - candidate_metric
        decision = GateDecision(
            publish=regression <= self.max_regression,
            champion_id=champion_id,
            champion_metric=champion_metric,
            candidate_metric=candidate_metric,
        )
        if decision.publish:
            decision.reason = (
                f"candidate {candidate_metric} within {self.max_regression} "
                f"of champion {champion_metric}"
            )
            return self._passed(decision)
        decision.reason = (
            f"candidate {candidate_metric} regresses champion {champion_metric} "
            f"(generation {champion_id}) by {regression}, beyond "
            f"max-regression {self.max_regression}"
        )
        metrics.registry.counter(GATED_COUNTER).inc()
        log.warning("challenger gated: %s", decision.reason)
        return decision

    @staticmethod
    def _passed(decision: GateDecision) -> GateDecision:
        metrics.registry.counter(PASSED_COUNTER).inc()
        return decision
