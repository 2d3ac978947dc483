"""SLO specs and burn-rate verdicts over an open-loop run.

The harness treats SLOs as first-class test outcomes: a scenario
declares its SLO (p99 threshold, error-rate budget, burn-rate window)
and the run FAILS — as a pytest assertion or a nonzero fleet.py exit —
when any replica or the fleet as a whole burns budget faster than the
declared multiple. Definitions follow the SRE-workbook convention
implemented by ``common.metrics.SLOWindow``: burn rate = observed bad
fraction / budgeted bad fraction over a trailing window, so 1.0 means
"spending budget exactly as fast as allowed".

Two evidence sources compose:

- engine records (``LoadResult``) — client-observed truth, including
  queueing delay and requests that never reached a replica
  (``no-ready-replica``);
- replica ``/metrics`` snapshots — server-side truth per replica, from
  which ``burn_from_metrics`` computes error burn over a window by
  differencing the 5xx / request counters between polls.

Both must be green for the verdict to pass: a replica that 500s while
the router has already dropped it burns server-side budget even though
clients never saw it.

Port note: a copy of ``oryx_tpu/loadgen/slo.py`` (JAX-free), with its imports pointed
at ``oryx_tpu_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from collections import Counter

from oryx_tpu_torch.loadgen.engine import LoadResult

__all__ = [
    "SLOSpec",
    "SLOVerdict",
    "burn_from_metrics",
    "evaluate_slo",
    "evaluate_tenant_slos",
]


@dataclass
class SLOSpec:
    """Declared SLO for a scenario run.

    p99_ms: client-observed p99 (including queueing delay) must be under
    this. error_rate: budgeted failure fraction (0.0 = zero-downtime — a
    single failed request fails the run). window_s: trailing window for
    burn-rate computation. max_burn: maximum tolerated burn rate over
    that window (ignored when error_rate is 0 — any failure is infinite
    burn by definition).
    """

    p99_ms: float = 500.0
    error_rate: float = 0.0
    window_s: float = 5.0
    max_burn: float = 1.0
    # quality dimension: minimum fraction of answered requests that must
    # be served at FULL quality (shed-ladder stage 0). None = no quality
    # assertion. Deliberate sheds never count against error_rate — they
    # count against this instead.
    min_full_quality: float | None = None


@dataclass
class SLOVerdict:
    passed: bool
    p99_ms: float
    error_rate: float
    failed_requests: int
    burn_rates: dict[str, float] = field(default_factory=dict)  # scope -> burn
    violations: list[str] = field(default_factory=list)
    # fraction of answered requests per shed-ladder stage (engine
    # LoadResult.quality()); {} for runs recorded before the ladder
    quality: dict[str, float] = field(default_factory=dict)

    def __bool__(self) -> bool:  # `assert verdict, verdict.violations`
        return self.passed


def evaluate_slo(result: LoadResult, spec: SLOSpec) -> SLOVerdict:
    """Judge one open-loop run against its declared SLO: fleet-wide p99
    and error rate from the engine's client-side records, plus per-replica
    error burn rates from each target's SLOWindow."""
    violations: list[str] = []
    p99_ms = result.latency_quantile(0.99) * 1000.0
    if p99_ms > spec.p99_ms:
        violations.append(f"fleet p99 {p99_ms:.1f} ms > SLO {spec.p99_ms:.1f} ms")
    if spec.error_rate <= 0.0:
        if result.failed:
            violations.append(
                f"zero-downtime SLO: {result.failed} failed request(s) "
                f"({dict(result.error_kinds)})"
            )
    elif result.error_rate > spec.error_rate:
        violations.append(
            f"fleet error rate {result.error_rate:.5f} > SLO {spec.error_rate:.5f}"
        )
    quality = result.quality()
    if spec.min_full_quality is not None:
        full = quality.get("full", 0.0)
        if full < spec.min_full_quality:
            violations.append(
                f"quality SLO: {full:.4f} full-quality answers < "
                f"required {spec.min_full_quality:.4f} "
                f"(per-stage {quality})"
            )
    burns: dict[str, float] = {}
    for name, target in result.per_target.items():
        burn = target.slo.error_burn_rate(spec.window_s, spec.error_rate)
        burns[name] = burn
        if spec.error_rate > 0.0 and burn > spec.max_burn:
            violations.append(
                f"replica {name} error burn {burn:.2f} > {spec.max_burn:.2f} "
                f"over {spec.window_s:.0f}s"
            )
    return SLOVerdict(
        passed=not violations,
        p99_ms=p99_ms,
        error_rate=result.error_rate,
        failed_requests=result.failed,
        burn_rates=burns,
        violations=violations,
        quality=quality,
    )


def evaluate_tenant_slos(
    result: LoadResult, specs: dict[str, SLOSpec]
) -> dict[str, "SLOVerdict"]:
    """Per-tenant verdicts over one multi-tenant open-loop run.

    Each tenant's records are carved out of the shared run and judged
    against the tenant's own declared SLO — the fairness contract
    (docs/multi-tenancy.md) is exactly that a noisy neighbour's burst
    must not flip a victim tenant's verdict. Tenants with a declared
    spec but no records get a failing verdict (a tenant that was starved
    out of the run entirely is the worst possible violation, not a
    vacuous pass). Per-replica burn windows are fleet-scoped, not
    tenant-scoped, so they are judged once in :func:`evaluate_slo`, not
    here."""
    grouped = result.tenant_records()
    verdicts: dict[str, SLOVerdict] = {}
    for tid, spec in specs.items():
        recs = grouped.get(tid, [])
        if not recs:
            verdicts[tid] = SLOVerdict(
                passed=False,
                p99_ms=0.0,
                error_rate=1.0,
                failed_requests=0,
                violations=[f"tenant {tid}: no completed requests in the run"],
            )
            continue
        n_ok = sum(1 for r in recs if r.ok)
        n_shed = sum(1 for r in recs if r.kind == "shed")
        sub = LoadResult(
            duration_s=result.duration_s,
            offered=len(recs),
            completed=len(recs),
            ok=n_ok,
            failed=len(recs) - n_ok - n_shed,
            error_kinds=Counter(
                r.kind for r in recs if not r.ok and r.kind != "shed"
            ),
            records=recs,
            queued_arrivals=0,
            peak_inflight=result.peak_inflight,
            per_target={},  # replica burn is fleet-scoped; judged once
            shed=n_shed,
        )
        verdict = evaluate_slo(sub, spec)
        verdict.violations = [f"tenant {tid}: {v}" for v in verdict.violations]
        verdict.passed = not verdict.violations
        verdicts[tid] = verdict
    return verdicts


def burn_from_metrics(
    before: dict, after: dict, window_s: float, slo_error_rate: float
) -> float:
    """Server-side error burn rate between two /metrics snapshots of one
    replica: delta(5xx) / delta(total responses), divided by the budgeted
    error fraction. Snapshots are the JSON bodies /metrics serves; missing
    counters count as 0 (a replica that served nothing burned nothing)."""

    def counter(snap: dict, name: str) -> float:
        entry = snap.get(name) or {}
        return float(entry.get("value") or 0.0)

    bad = counter(after, "serving.responses.5xx") - counter(before, "serving.responses.5xx")
    total = 0.0
    for klass in ("2xx", "3xx", "4xx", "5xx"):
        total += counter(after, f"serving.responses.{klass}") - counter(
            before, f"serving.responses.{klass}"
        )
    if total <= 0:
        return 0.0
    observed = bad / total
    if slo_error_rate <= 0.0:
        return float("inf") if observed > 0 else 0.0
    return observed / slo_error_rate
