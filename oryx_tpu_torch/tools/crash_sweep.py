"""Kill-point sweep: SIGKILL the pipeline at every registered crashpoint
and verify recovery.

The crashpoint catalog (oryx_tpu_torch/common/crashpoints.py) registers
every state-mutating commit sequence in the port. This harness proves each
one is crash-safe, site by site:

1. **kill run** — a worker subprocess drives one scripted pass through
   all three layers (filebus + shm appends, offset commits, a batch
   generation through the real MLUpdate harness, a speed micro-batch,
   a registry republish, a MODEL-REF restage) with
   ``ORYX_CRASHPOINT=<site>:1`` armed, and must die with SIGKILL (exit
   137) at exactly that site. A worker that exits cleanly means the
   catalog has drifted from the code — reported as a failure, so the
   sweep keeps the catalog honest.
2. **recovery run** — the same worker reruns in the same workdir with no
   crashpoint armed. Repair-on-open machinery (filebus/shm fsck,
   registry fsck, restage sweep) must absorb whatever the kill left
   behind and the run must complete.
3. **invariant audit** — the harness then asserts the at-least-once
   contract over the surviving state: no acknowledged input lost, no
   duplicate model generations, CHAMPION lineage monotone, and a clean
   registry fsck.

The worker appends an fsync'd ack line *after* each commit returns, so
"acknowledged" has a crisp on-disk meaning the audit can replay against.

The workers compute where the harness does: on the card by default, on
the CPU with ``--device cpu`` (as the tests run it). Without CUDA and
without ``--device cpu`` the harness raises the port's "no CUDA device"
error before it starts a worker.

Usage:
    python -m oryx_tpu_torch.tools.crash_sweep                 # sweep all sites
    python -m oryx_tpu_torch.tools.crash_sweep --site bus.file.append.pre
    python -m oryx_tpu_torch.tools.crash_sweep --device cpu    # on the CPU
    python -m oryx_tpu_torch.tools.crash_sweep --worker DIR --device cpu  # internal: one pass

Also importable (tests/test_torch_crash_sweep_*.py run it on the CPU,
chip_smoke.py's crash-sweep phase on the card's host).

Port note: the counterpart of the repo's ``tools/crash_sweep.py``, a
module of the port's package: its worker drives the port's brokers,
storage, layers, registry and stager, its config names the port's
classes, and it imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.common import crashpoints

REPO_ROOT = Path(__file__).resolve().parents[2]

WORKER_TIMEOUT_S = 120.0


# -- worker ------------------------------------------------------------------


def _pipeline_config(wd: Path):
    from oryx_tpu_torch.common import config as config_utils

    return config_utils.get_default().with_overlay(
        f"""
        oryx {{
          id = "CrashSweep"
          input-topic.broker = "file:{wd}/bus"
          update-topic.broker = "file:{wd}/bus"
          batch.storage {{ data-dir = "{wd}/data/"
                           model-dir = "{wd}/model/"
                           format = "jsonl" }}
          batch.update-class = "oryx_tpu_torch.registry.testing.ScriptedMetricUpdate"
          speed.model-manager-class = "oryx_tpu_torch.example.speed:ExampleSpeedModelManager"
          ml {{
            eval {{ candidates = 1, test-fraction = 0.5 }}
            gate.max-regression = 0.05
          }}
          test.scripted-metric = 0.9
        }}
        """
    )


def worker(workdir: str) -> int:
    """One scripted pass through every instrumented commit sequence.

    Idempotent across reruns in the same workdir: a per-run nonce (itself
    committed through the storage helper, so even it is kill-tested)
    keys every record and generation id, so a rerun after a kill never
    collides with what the dead run left behind."""
    from oryx_tpu_torch.bus import get_broker
    from oryx_tpu_torch.common import storage
    from oryx_tpu_torch.lambda_.batch import BatchLayer
    from oryx_tpu_torch.lambda_.speed import SpeedLayer
    from oryx_tpu_torch.registry.store import RegistryStore, publish_generation
    from oryx_tpu_torch.serving.restage import ModelStager

    wd = Path(workdir)
    wd.mkdir(parents=True, exist_ok=True)
    ack_path = wd / "acks.log"

    def ack(line: str) -> None:
        # the audit's definition of "acknowledged": this line is durable
        with open(ack_path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    # storage commit helper (storage.commit.pre/.post) — the run nonce
    runs = wd / "runs.txt"
    n = (int(runs.read_text()) + 1) if runs.exists() else 1
    storage.commit_text(runs, str(n))
    ack(f"nonce:{n}")

    # filebus appends + segment roll + offset-ledger commit
    # (bus.file.append.*, bus.file.roll.mid, bus.file.offsets.*)
    fb = get_broker(f"file:{wd}/bus")
    fb.create_topic("raw", 1, {"segment-bytes": 64})  # tiny: force rolls
    with fb.producer("raw") as p:
        for i in range(8):
            p.send(f"k{i}", f"fb-{n}-{i}")
            ack(f"fb:{n}:{i}")
    consumer = fb.consumer("raw", group="sweeper", from_beginning=True)
    drained = 0
    while True:
        batch = consumer.poll(timeout=0.05)
        if not batch:
            break
        drained += len(batch)
    consumer.commit()
    consumer.close()
    ack(f"fb-commit:{n}:{drained}")

    # shm ring publish (bus.shm.publish.*)
    sb = get_broker(f"shm:{wd}/shm")
    sb.create_topic("stream", 1)
    with sb.producer("stream") as p:
        for i in range(4):
            p.send(f"k{i}", f"shm-{n}-{i}")
            ack(f"shm:{n}:{i}")

    # one batch generation through the real MLUpdate harness
    # (batch.save.pre, batch.commit.pre, ml.promote.mid, ml.champion.pre,
    #  ml.publish.*, registry.champion.pre — and MLUpdate's own
    #  fsck(repair=True) absorbs whatever a previous kill left behind)
    cfg = _pipeline_config(wd)
    generation_id = 100_000 + n
    batch = BatchLayer(cfg)
    try:
        # attach the input consumer BEFORE producing: a fresh group starts
        # at latest, so records sent first would be invisible to the drain
        batch.prepare()
        with fb.producer("OryxInput") as p:
            for i in range(6):
                p.send(None, f"in{n}x{i},in{n}y{i}")
                ack(f"in:{n}:{i}")
        batch.run_one_generation(timestamp_ms=generation_id)
    finally:
        batch.close()
    ack(f"generation:{generation_id}")
    store = RegistryStore(f"{wd}/model")
    champion = store.champion_id()
    ack(f"champion:{champion}")

    # one speed micro-batch (speed.commit.*)
    speed = SpeedLayer(cfg)
    try:
        speed.prepare_input()
        with fb.producer("OryxInput") as p:
            for i in range(4):
                p.send(None, f"sp{n}x{i},sp{n}y{i}")
                ack(f"sin:{n}:{i}")
        sent = speed.run_one_batch()
    finally:
        speed.close()
    ack(f"speed:{n}:{sent}")

    # registry republish, forced to MODEL-REF (registry.publish.*)
    with fb.producer("OryxUpdate") as p:
        key = publish_generation(store, champion, p, max_message_size=16)
    ack(f"republished:{champion}:{key}")

    # MODEL-REF restage into the local cache (serving.restage.*)
    stager = ModelStager(wd / "cache")
    staged = stager.stage(store.generation_dir(champion))
    assert staged is not None and (staged / "model.pmml").is_file()
    ack(f"staged:{champion}")
    return 0


# -- harness -----------------------------------------------------------------


@dataclass
class SiteResult:
    site: str
    kill_exit: int | None = None
    recovered: bool = False
    recovery_seconds: float = 0.0
    violations: list[str] = field(default_factory=list)
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.recovered and not self.violations

    def to_dict(self) -> dict:
        return {
            "site": self.site,
            "ok": self.ok,
            "kill_exit": self.kill_exit,
            "recovered": self.recovered,
            "recovery_seconds": round(self.recovery_seconds, 3),
            "violations": self.violations,
            "error": self.error,
        }


def _run_worker(workdir: Path, site: str | None = None) -> subprocess.CompletedProcess:
    # the worker computes where this process does: raises here, before any
    # worker starts, when there is no CUDA device and the CPU was not chosen
    device = port_device.default_device().type
    env = dict(os.environ)
    env.pop(crashpoints.ENV_VAR, None)
    if site is not None:
        env[crashpoints.ENV_VAR] = f"{site}:1"
    env["PYTHONPATH"] = str(REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    if sys.dont_write_bytecode and "PYTHONPYCACHEPREFIX" not in env:
        # where bytecode is never written (the card's host sets
        # PYTHONDONTWRITEBYTECODE=1), every worker compiles torch from
        # source: the workers share a bytecode cache beside their workdirs
        env.pop("PYTHONDONTWRITEBYTECODE", None)
        env["PYTHONPYCACHEPREFIX"] = str(Path(workdir).parent / ".pycache")
    return subprocess.run(
        [
            sys.executable, "-m", "oryx_tpu_torch.tools.crash_sweep",
            "--worker", str(workdir), "--device", device,
        ],
        env=env,
        cwd=str(REPO_ROOT),
        capture_output=True,
        text=True,
        timeout=WORKER_TIMEOUT_S,
    )


def _parse_acks(workdir: Path) -> list[tuple[str, ...]]:
    path = workdir / "acks.log"
    if not path.exists():
        return []
    return [tuple(line.split(":")) for line in path.read_text().splitlines() if line]


def check_invariants(workdir: Path) -> list[str]:
    """The at-least-once audit, run after the recovery pass. Returns a
    list of violation descriptions (empty = all invariants hold)."""
    from oryx_tpu_torch.bus import get_broker
    from oryx_tpu_torch.registry.store import RegistryStore

    wd = Path(workdir)
    acks = _parse_acks(wd)
    violations: list[str] = []

    def drain(broker, topic) -> list:
        c = broker.consumer(topic, from_beginning=True)
        out = []
        try:
            while True:
                batch = c.poll(timeout=0.05)
                if not batch:
                    return out
                out.extend(batch)
        finally:
            c.close()

    # 1. no lost acknowledged input: every payload acked by any run (dead
    # or alive) must still be readable from its topic
    fb = get_broker(f"file:{wd}/bus")
    sb = get_broker(f"shm:{wd}/shm")
    surviving = {
        "fb": {m.message for m in drain(fb, "raw")},
        "shm": {m.message for m in drain(sb, "stream")},
        "in": {m.message for m in drain(fb, "OryxInput")},
        "sin": {m.message for m in drain(fb, "OryxInput")},
    }
    payload = {
        "fb": lambda n, i: f"fb-{n}-{i}",
        "shm": lambda n, i: f"shm-{n}-{i}",
        "in": lambda n, i: f"in{n}x{i},in{n}y{i}",
        "sin": lambda n, i: f"sp{n}x{i},sp{n}y{i}",
    }
    for kind, fmt in payload.items():
        for a in acks:
            if a[0] != kind:
                continue
            expect = fmt(a[1], a[2])
            if expect not in surviving[kind]:
                violations.append(f"lost acknowledged input: {expect!r} ({kind})")

    # 2. acked generations survive intact, exactly once, and the registry
    # audits clean (quarantines are renamed aside, so a leftover problem
    # means recovery missed it)
    store = RegistryStore(f"{wd}/model")
    gens = store.list_generations()
    if len(gens) != len(set(gens)):
        violations.append(f"duplicate generation ids in registry: {gens}")
    for a in acks:
        if a[0] == "generation" and a[1] not in gens:
            violations.append(f"acknowledged generation {a[1]} lost from registry")
        if a[0] == "generation" and not store.has_generation(a[1]):
            violations.append(f"acknowledged generation {a[1]} has no model.pmml")
    fsck = store.fsck(repair=False)
    dirty = {k: v for k, v in fsck.items() if v}
    if dirty:
        violations.append(f"registry not clean after recovery: {dirty}")

    # 3. CHAMPION lineage monotone: the pointer never moves backwards
    # past an acknowledged champion, and always names an intact generation
    champions = [a[1] for a in acks if a[0] == "champion" and a[1] != "None"]
    final = store.champion_id()
    if final is None:
        if champions:
            violations.append("CHAMPION pointer lost after recovery")
    else:
        if final not in gens or not store.has_generation(final):
            violations.append(f"CHAMPION points at non-intact generation {final}")
        if champions and int(final) < max(int(c) for c in champions):
            violations.append(
                f"CHAMPION moved backwards: {final} < acknowledged {max(champions)}"
            )
    return violations


def sweep_site(site: str, workdir: Path) -> SiteResult:
    """Kill at one site, recover, audit. ``workdir`` must be empty/fresh."""
    res = SiteResult(site=site)
    try:
        kill = _run_worker(workdir, site=site)
        res.kill_exit = kill.returncode
        # subprocess reports a signal death as -SIGKILL; a shell would
        # render the same death as exit 137
        if kill.returncode not in (crashpoints.KILL_EXIT_CODE, -signal.SIGKILL):
            res.error = (
                f"expected SIGKILL exit {crashpoints.KILL_EXIT_CODE} at {site}, got "
                f"{kill.returncode} (site unreachable? catalog drift). "
                f"stderr tail: {kill.stderr[-500:]}"
            )
            return res
        t0 = time.monotonic()
        recovery = _run_worker(workdir, site=None)
        res.recovery_seconds = time.monotonic() - t0
        res.recovered = recovery.returncode == 0
        if not res.recovered:
            res.error = f"recovery run failed rc={recovery.returncode}: {recovery.stderr[-500:]}"
            return res
        res.violations = check_invariants(workdir)
    except subprocess.TimeoutExpired:
        res.error = "worker timed out"
    return res


def sweep(sites: list[str] | None = None, base_dir: str | None = None) -> list[SiteResult]:
    sites = sites or sorted(crashpoints.CATALOG)
    root = Path(base_dir) if base_dir else Path(tempfile.mkdtemp(prefix="crash-sweep-"))
    return [sweep_site(site, root / site.replace(".", "_")) for site in sites]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", metavar="DIR", default=None, help="internal: run one worker pass")
    ap.add_argument("--site", action="append", default=None, help="sweep only this site (repeatable)")
    ap.add_argument("--base-dir", default=None, help="keep workdirs under this directory")
    ap.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the workers compute: the card (default), or the CPU for tests",
    )
    args = ap.parse_args(argv)
    if args.device == "cpu":
        port_device.set_device("cpu")

    if args.worker:
        return worker(args.worker)

    results = sweep(sites=args.site, base_dir=args.base_dir)
    report = {
        "sites": len(results),
        "passed": sum(r.ok for r in results),
        "failed": [r.to_dict() for r in results if not r.ok],
        "results": [r.to_dict() for r in results],
    }
    print(json.dumps(report, indent=2))
    return 0 if report["passed"] == report["sites"] else 1


if __name__ == "__main__":
    sys.exit(main())
