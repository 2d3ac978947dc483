"""Interleaved online evaluation: join interaction events back to served
recommendations and accumulate per-arm evidence.

Every attributed serve is recorded as *pending* for its user. A
subsequent interaction event (the ``user,item[,value]`` CSV lines the
speed layer folds in) within ``oryx.serving.ab.join-window-s`` resolves
the oldest pending serve for that user into an *outcome*: the reciprocal
of the interacted item's observed rank in the served list (1.0 for a
top-1 hit), or 0.0 when the item was not in the list. Pending serves
that outlive the window resolve to a 0.0 miss. Outcomes are paired
across arms in resolution order — the i-th resolved champion outcome
against the i-th resolved challenger outcome, Radlinski & Joachims
style — which is what the online gate's sign test consumes.

All methods are thread-safe: serves arrive from request-handler threads
while events arrive from the evaluator's input-topic consumer.

Port note: a copy of ``oryx_tpu/experiments/evaluator.py`` (JAX-free),
with its imports pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from oryx_tpu_torch.experiments.routing import ABConfig, ARM_CHALLENGER, ARM_CHAMPION

#: Hard bound on the per-arm outcome streams used for pairing.
_MAX_OUTCOMES = 100_000
#: Latency samples retained per arm for the report quantiles.
_LATENCY_RESERVOIR = 2048


def parse_event(line: str) -> tuple[str, str] | None:
    """Parse a ``user,item[,value]`` interaction line; None when the
    line is not event-shaped (the input topic also carries free text)."""
    parts = line.strip().split(",")
    if len(parts) < 2:
        return None
    user, item = parts[0].strip(), parts[1].strip()
    if not user or not item:
        return None
    return user, item


def _quantile(sorted_values: list[float], q: float) -> float | None:
    if not sorted_values:
        return None
    idx = min(len(sorted_values) - 1, int(q * len(sorted_values)))
    return sorted_values[idx]


@dataclass
class _PendingServe:
    t: float
    arm: str
    generation: str | None
    items: tuple[str, ...]


@dataclass
class ArmStats:
    """Accumulated per-arm evidence."""

    serves: int = 0
    resolved: int = 0
    hits: int = 0
    rank_reciprocal_sum: float = 0.0
    shed: dict = field(default_factory=dict)
    latencies: deque = field(default_factory=lambda: deque(maxlen=_LATENCY_RESERVOIR))

    @property
    def hit_rate(self) -> float | None:
        return (self.hits / self.resolved) if self.resolved else None

    @property
    def mrr(self) -> float | None:
        """Mean observed-rank reciprocal rank over resolved serves
        (misses contribute 0)."""
        return (self.rank_reciprocal_sum / self.resolved) if self.resolved else None

    def latency_quantiles(self) -> dict:
        values = sorted(self.latencies)
        return {
            "p50_s": _quantile(values, 0.50),
            "p99_s": _quantile(values, 0.99),
            "samples": len(values),
        }

    def to_dict(self) -> dict:
        return {
            "serves": self.serves,
            "resolved": self.resolved,
            "hits": self.hits,
            "hit_rate": self.hit_rate,
            "mrr": self.mrr,
            "latency": self.latency_quantiles(),
            "shed": dict(self.shed),
        }


class ExperimentEvaluator:
    """Joins served recommendations to interaction events and keeps the
    per-arm evidence the online gate decides on."""

    def __init__(self, cfg: ABConfig, clock=time.monotonic) -> None:
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        # user -> deque[_PendingServe], LRU-ordered by last serve
        self._pending_serves: OrderedDict[str, deque] = OrderedDict()
        self.arms: dict[str, ArmStats] = {
            ARM_CHAMPION: ArmStats(),
            ARM_CHALLENGER: ArmStats(),
        }
        self._outcomes: dict[str, list] = {ARM_CHAMPION: [], ARM_CHALLENGER: []}
        self.events_seen = 0
        self.events_joined = 0
        self.started_at = time.time()

    # -- serve side ----------------------------------------------------------

    def observe_serve(
        self,
        user: str,
        arm: str,
        generation: str | None,
        items,
        latency_s: float | None = None,
        shed_stage: str | None = None,
    ) -> None:
        """Record an attributed serve (called from the request path)."""
        now = self._clock()
        with self._lock:
            stats = self.arms[arm]
            stats.serves += 1
            if latency_s is not None:
                stats.latencies.append(latency_s)
            if shed_stage:
                stats.shed[shed_stage] = stats.shed.get(shed_stage, 0) + 1
            if not items:
                # nothing was recommended (non-recommendation endpoint or
                # an error body): per-arm traffic counted above, but there
                # is no serve to join an interaction against
                self._expire_locked(now)
                return
            queue = self._pending_serves.get(user)
            if queue is None:
                queue = deque()
                self._pending_serves[user] = queue
            queue.append(
                _PendingServe(now, arm, generation, tuple(str(i) for i in items or ()))
            )
            self._pending_serves.move_to_end(user)
            self._expire_locked(now)
            while len(self._pending_serves) > self.cfg.max_tracked_users:
                _, evicted = self._pending_serves.popitem(last=False)
                for serve in evicted:
                    self._resolve_locked(serve, outcome=0.0, hit=False)

    # -- event side ----------------------------------------------------------

    def observe_event(self, line: str) -> bool:
        """Consume one input-topic line; True when it joined a serve."""
        parsed = parse_event(line)
        now = self._clock()
        with self._lock:
            self.events_seen += 1
            self._expire_locked(now)
            if parsed is None:
                return False
            user, item = parsed
            queue = self._pending_serves.get(user)
            while queue:
                serve = queue.popleft()
                if now - serve.t > self.cfg.join_window_s:
                    self._resolve_locked(serve, outcome=0.0, hit=False)
                    continue
                self.events_joined += 1
                if item in serve.items:
                    rank = serve.items.index(item) + 1
                    self._resolve_locked(serve, outcome=1.0 / rank, hit=True)
                else:
                    self._resolve_locked(serve, outcome=0.0, hit=False)
                if not queue:
                    self._pending_serves.pop(user, None)
                return True
            self._pending_serves.pop(user, None)
            return False

    def tick(self) -> None:
        """Resolve pending serves whose join window has expired (called
        periodically by the coordinator's consumer loop)."""
        with self._lock:
            self._expire_locked(self._clock())

    # -- internals -----------------------------------------------------------

    def _expire_locked(self, now: float) -> None:
        window = self.cfg.join_window_s
        for user in list(self._pending_serves):
            queue = self._pending_serves[user]
            while queue and now - queue[0].t > window:
                self._resolve_locked(queue.popleft(), outcome=0.0, hit=False)
            if not queue:
                del self._pending_serves[user]

    def _resolve_locked(self, serve: _PendingServe, outcome: float, hit: bool) -> None:
        stats = self.arms[serve.arm]
        stats.resolved += 1
        if hit:
            stats.hits += 1
            stats.rank_reciprocal_sum += outcome
        stream = self._outcomes[serve.arm]
        if len(stream) < _MAX_OUTCOMES:
            stream.append(outcome)

    # -- gate/report side ----------------------------------------------------

    def pair_counts(self) -> tuple[int, int, int]:
        """(challenger-wins, champion-wins, ties) over index-paired
        resolved outcomes."""
        with self._lock:
            champion = self._outcomes[ARM_CHAMPION]
            challenger = self._outcomes[ARM_CHALLENGER]
            n = min(len(champion), len(challenger))
            pos = neg = ties = 0
            for i in range(n):
                if challenger[i] > champion[i]:
                    pos += 1
                elif challenger[i] < champion[i]:
                    neg += 1
                else:
                    ties += 1
            return pos, neg, ties

    def snapshot(self) -> dict:
        """Serializable per-arm evidence (the ExperimentReport body)."""
        with self._lock:
            pending = sum(len(q) for q in self._pending_serves.values())
            arms = {arm: stats.to_dict() for arm, stats in self.arms.items()}
        pos, neg, ties = self.pair_counts()
        return {
            "arms": arms,
            "pairs": {"challenger_wins": pos, "champion_wins": neg, "ties": ties},
            "events_seen": self.events_seen,
            "events_joined": self.events_joined,
            "pending_serves": pending,
            "join_window_s": self.cfg.join_window_s,
            "started_at": self.started_at,
        }

    def reset(self) -> None:
        """Drop all evidence (a new experiment is starting)."""
        with self._lock:
            self._pending_serves.clear()
            self.arms = {ARM_CHAMPION: ArmStats(), ARM_CHALLENGER: ArmStats()}
            self._outcomes = {ARM_CHAMPION: [], ARM_CHALLENGER: []}
            self.events_seen = 0
            self.events_joined = 0
            self.started_at = time.time()
