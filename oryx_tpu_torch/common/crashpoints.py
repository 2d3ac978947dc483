"""Seeded, env-activated kill-point instrumentation (crash-only testing).

The lambda architecture's fault-tolerance story (PAPER.md) is usually
tested at the message level — the fault bus drops/delays/duplicates
deliveries — but the failures that actually corrupt state are process
deaths *between* the steps of a commit sequence: the model directory is
promoted but the manifest isn't written, the update message is published
but the input offsets aren't committed, the CHAMPION temp file is
renamed but never fsynced. This module marks those instants explicitly.

Every state-mutating commit sequence in the repo calls
``crashpoint("<site>")`` at each step boundary. In production the call
is a no-op costing one attribute load and one comparison. Under test,
setting

    ORYX_CRASHPOINT=<site>:<nth>

in a worker's environment kills the process with SIGKILL the <nth> time
(1-based) execution reaches that site — no atexit hooks, no ``finally``
blocks, no stream flushing: the closest stand-in for ``kill -9`` a
process can inflict on itself. The sweep harness
(oryx_tpu_torch/tools/crash_sweep.py) iterates every site in
``CATALOG``, kills a worker at each one, restarts it, and asserts the
at-least-once invariants (no acknowledged-input loss, no duplicate
generations, monotone CHAMPION lineage) survived.

For in-process unit tests ``arm(site, nth, action="raise")`` raises
``CrashPointReached`` instead of killing the interpreter, so a single
test can simulate the death of one commit step and then drive recovery
in the same process.

Port note: a copy of ``oryx_tpu/common/crashpoints.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import os
import signal
import threading

__all__ = [
    "CATALOG",
    "CrashPointReached",
    "arm",
    "arm_from_env",
    "armed_site",
    "crashpoint",
    "hits",
    "reset",
    "sites",
]

# Exit status a killed worker reports to its parent: SIGKILL's 128+9.
KILL_EXIT_CODE = 137

# The authoritative kill-point registry: site -> (layer, what dies here).
# Docs (docs/durability.md) and the sweep harness
# (oryx_tpu_torch/tools/crash_sweep.py) both read this table;
# an instrumented call site MUST be declared here or the sweep will
# never exercise it. Sites are named <subsystem>.<sequence>.<step>.
CATALOG: dict[str, tuple[str, str]] = {
    # -- bus: file-backed partition logs + offset ledger --------------------
    "bus.file.append.pre": (
        "bus", "before record lines land in the active segment (send not acked)"),
    "bus.file.append.post": (
        "bus", "records appended + flushed, before send() returns the ack"),
    "bus.file.roll.mid": (
        "bus", "segment archived to its rolled name, before the .base sidecar commit"),
    "bus.file.offsets.pre": (
        "bus", "records consumed, before the offset-ledger atomic replace"),
    "bus.file.offsets.post": (
        "bus", "offset ledger replaced, before commit() returns"),
    # -- bus: shared-memory ring --------------------------------------------
    "bus.shm.publish.pre": (
        "bus", "frame bytes + CRC written into the ring, head not yet published"),
    "bus.shm.publish.post": (
        "bus", "head published past the new frame, before send() returns"),
    # -- storage: the atomic temp+rename commit helper ----------------------
    "storage.commit.pre": (
        "storage", "temp file written + fsynced, before the atomic rename"),
    "storage.commit.post": (
        "storage", "renamed over the target, before the parent-directory fsync"),
    # -- registry ------------------------------------------------------------
    "registry.champion.pre": (
        "registry", "before the CHAMPION pointer write begins"),
    "registry.publish.pre": (
        "registry", "generation durable in the registry, before the update-topic send"),
    "registry.publish.post": (
        "registry", "update-topic send acked, before publish_generation returns"),
    # -- batch layer: MLUpdate commit sequence ------------------------------
    "ml.promote.mid": (
        "batch", "candidate promoted into the model dir, manifest not yet written"),
    "ml.champion.pre": (
        "batch", "manifest written, CHAMPION pointer not yet moved"),
    "ml.publish.pre": (
        "batch", "CHAMPION moved, model not yet published on the update topic"),
    "ml.publish.post": (
        "batch", "model published on the update topic, before GC / return"),
    # -- batch layer: micro-batch persistence + input commit ----------------
    "batch.save.pre": (
        "batch", "generation complete, micro-batch not yet saved to the data dir"),
    "batch.commit.pre": (
        "batch", "micro-batch saved, input offsets not yet committed"),
    # -- speed layer ----------------------------------------------------------
    "speed.commit.pre": (
        "speed", "UP deltas published, input offsets not yet committed"),
    "speed.commit.post": (
        "speed", "input offsets committed, before batch bookkeeping"),
    # -- serving: MODEL-REF restage ------------------------------------------
    "serving.restage.mid": (
        "serving", "some artifact files copied into the staging temp dir"),
    "serving.restage.pre-commit": (
        "serving", "all artifacts staged, before the atomic rename into the cache"),
}

ENV_VAR = "ORYX_CRASHPOINT"


class CrashPointReached(BaseException):
    """Raised (instead of killing the process) when a site is armed with
    action="raise" — BaseException so no ``except Exception`` recovery
    path can accidentally swallow the simulated death."""

    def __init__(self, site: str) -> None:
        super().__init__(f"crashpoint {site} reached")
        self.site = site


_lock = threading.Lock()
_hits: dict[str, int] = {}
_armed_site: str | None = None
_armed_nth: int = 1
_armed_action: str = "kill"


def _parse_spec(spec: str) -> tuple[str, int]:
    site, sep, nth = spec.partition(":")
    if not site:
        raise ValueError(f"bad {ENV_VAR} spec {spec!r} (want <site>:<nth>)")
    return site, int(nth) if sep and nth else 1


def arm(site: str, nth: int = 1, action: str = "kill") -> None:
    """Arm one site in-process: the nth visit dies (action="kill") or
    raises CrashPointReached (action="raise", for unit tests)."""
    global _armed_site, _armed_nth, _armed_action
    if action not in ("kill", "raise"):
        raise ValueError(f"unknown crashpoint action {action!r}")
    with _lock:
        _armed_site, _armed_nth, _armed_action = site, max(1, int(nth)), action


def arm_from_env(environ=os.environ) -> str | None:
    """Arm from $ORYX_CRASHPOINT (no-op when unset). Returns the site."""
    spec = environ.get(ENV_VAR)
    if not spec:
        return None
    site, nth = _parse_spec(spec)
    arm(site, nth, action="kill")
    return site


def reset() -> None:
    """Disarm and forget hit counts (test isolation)."""
    global _armed_site
    with _lock:
        _armed_site = None
        _hits.clear()


def armed_site() -> str | None:
    return _armed_site


def hits(site: str) -> int:
    with _lock:
        return _hits.get(site, 0)


def sites(layer: str | None = None) -> list[str]:
    """Registered kill-point names, optionally filtered by layer."""
    return sorted(s for s, (lyr, _) in CATALOG.items() if layer is None or lyr == layer)


def _die() -> None:  # pragma: no cover - by design nothing after it runs
    try:
        os.kill(os.getpid(), signal.SIGKILL)
    finally:
        # SIGKILL cannot be handled, but cover exotic platforms anyway
        os._exit(KILL_EXIT_CODE)


def crashpoint(site: str) -> None:
    """Mark one step boundary of a commit sequence. No-op unless armed."""
    if _armed_site is None:  # fast path: production cost is this check
        return
    if site != _armed_site:
        return
    with _lock:
        if _armed_site != site:  # re-check under the lock (disarm race)
            return
        n = _hits.get(site, 0) + 1
        _hits[site] = n
        if n != _armed_nth:
            return
        action = _armed_action
    if action == "raise":
        raise CrashPointReached(site)
    _die()


# a worker spawned with ORYX_CRASHPOINT set is armed from birth
arm_from_env()
