"""Command-line launcher (counterpart of ``oryx_tpu/cli.py``):

    python -m oryx_tpu_torch batch --conf oryx.conf
    python -m oryx_tpu_torch speed --conf oryx.conf
    python -m oryx_tpu_torch serving --conf oryx.conf
    python -m oryx_tpu_torch bus-setup --conf oryx.conf
    python -m oryx_tpu_torch bus-serve --conf oryx.conf [--bind HOST:PORT] [--data-dir DIR]
    python -m oryx_tpu_torch bus-tail  --conf oryx.conf [--from-beginning]
    python -m oryx_tpu_torch bus-input --conf oryx.conf --input-file data.csv
    python -m oryx_tpu_torch trace     --conf oryx.conf [TRACE_ID]
    python -m oryx_tpu_torch config    --conf oryx.conf
    python -m oryx_tpu_torch health    --conf oryx.conf
    python -m oryx_tpu_torch models    list | show GEN | rollback GEN | gc --conf oryx.conf
    python -m oryx_tpu_torch tenants   list | show TENANT --conf oryx.conf
    python -m oryx_tpu_torch experiments --conf oryx.conf
    python -m oryx_tpu_torch lint      [--select PASS,...]
    python -m oryx_tpu_torch repair    --conf oryx.conf

The three layers are ported; each runs as its own process, and they meet
on the bus the config names (the packaged default is the file bus
``file:/tmp/OryxTPU/bus``). The bus commands are the JAX package's:
``bus-setup`` creates the input and update topics, ``bus-serve`` serves a
bus directory over TCP (``tcp://host:port`` locators), ``bus-tail``
follows both topics and ``bus-input`` sends a file's lines to the input
topic. ``trace`` prints the serving layer's ``GET /trace`` (Chrome-trace
JSON, optionally one trace id's spans). The operator commands are the
JAX package's, with its output lines and exit codes: ``config`` dumps
the resolved ``oryx.*`` tree, ``health`` probes ``/healthz`` and
``/readyz`` against the registry's champion, ``models`` lists, shows,
rolls back and collects generations, ``tenants`` lists and shows the
declared tenants, ``experiments`` prints ``GET /experiments`` and
``repair`` runs the offline fsck of the bus, the registry and the
restage cache, and ``lint`` runs the port's static-analysis gate
(``oryx_tpu_torch.analysis``) over ``oryx_tpu_torch/`` with its
checked-in baseline; ``--select`` runs some of its passes alone.
Config layers as in the JAX package: packaged defaults <- ``--conf``
file <- ``--set`` overrides. The config must name the port's classes,
e.g. ``model-manager-class =
"oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"``,
``application-resources = "oryx_tpu_torch.app.als"``, ``update-class =
"oryx_tpu_torch.app.kmeans.update:KMeansUpdate"`` (or
``"oryx_tpu_torch.app.rdf.update:RDFUpdate"``) or, for the speed layer,
``model-manager-class =
"oryx_tpu_torch.app.kmeans.speed:KMeansSpeedModelManager"``; a name under
``oryx_tpu`` is refused.
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import os
import signal
import sys

from oryx_tpu_torch.common import config as config_utils
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.lang import close_at_shutdown

log = logging.getLogger(__name__)

COMMANDS = (
    "batch", "speed", "serving", "bus-setup", "bus-serve", "bus-tail", "bus-input", "config",
    "health", "models", "trace", "experiments", "lint", "repair", "tenants",
)

MODELS_SUBCOMMANDS = ("list", "show", "rollback", "gc")

TENANTS_SUBCOMMANDS = ("list", "show")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oryx_tpu_torch",
        description="PyTorch/CUDA lambda-architecture ML framework launcher",
    )
    p.add_argument("command", choices=COMMANDS, help="which layer or utility to run")
    p.add_argument(
        "subcommand",
        nargs="?",
        default=None,
        help="models: list | show <generation> | rollback <generation> | gc; "
        "tenants: list | show <tenant>; trace: optional trace id to filter by",
    )
    p.add_argument(
        "generation",
        nargs="?",
        default=None,
        help="models show/rollback: the generation id (a <timestampMs> dir "
        "name); tenants show: the tenant id",
    )
    p.add_argument(
        "--conf",
        default=None,
        help="configuration file (HOCON); defaults to ./oryx.conf when present",
    )
    p.add_argument(
        "--app-dir",
        action="append",
        default=[],
        help="directory added to sys.path so config-named app classes import; repeatable",
    )
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="config override, e.g. --set oryx.serving.api.port=9090; repeatable",
    )
    p.add_argument("--input-file", default=None, help="bus-input: file to send line-by-line")
    p.add_argument(
        "--bind", default="0.0.0.0:6378",
        help="bus-serve: host:port to listen on (default 0.0.0.0:6378)",
    )
    p.add_argument(
        "--data-dir", default=None,
        help="bus-serve: directory for the served topic logs "
        "(default: the path of the config's file: input-topic broker)",
    )
    p.add_argument(
        "--from-beginning",
        action="store_true",
        help="bus-tail: start from offset 0 instead of latest",
    )
    p.add_argument(
        "--select", default=None,
        help="lint only: comma-separated pass ids to run (default: every pass)",
    )
    p.add_argument("--log-level", default="INFO", help="python logging level")
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the layer computes: the card (default), or the CPU for tests and rehearsals",
    )
    return p


def load_config(conf: str | None, overrides: list[str]) -> Config:
    """Layered config: packaged defaults <- --conf file <- --set overrides."""
    if conf is None and os.path.exists("oryx.conf"):
        conf = "oryx.conf"
    if conf is not None:
        if not os.path.exists(conf):
            raise SystemExit(f"Config file {conf} does not exist")
        os.environ["ORYX_CONF"] = conf
    cfg = config_utils.get_default()
    if overrides:
        lines = []
        for kv in overrides:
            if "=" not in kv:
                raise SystemExit(f"bad --set {kv!r}: expected KEY=VALUE")
            key, _, value = kv.partition("=")
            lines.append(f"{key} = {value}")
        cfg = cfg.with_overlay("\n".join(lines))
    return cfg


def _install_signal_handlers(layer) -> None:
    def handler(signum, frame):  # noqa: ARG001
        log.info("signal %s: shutting down", signum)
        layer.close()

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, handler)
        except ValueError:  # pragma: no cover - non-main thread
            pass


def run_batch(cfg: Config) -> None:
    """deploy/oryx-batch Main.java:31-37 analogue."""
    from oryx_tpu_torch.lambda_.batch import BatchLayer

    layer = BatchLayer(cfg)
    close_at_shutdown(layer)
    _install_signal_handlers(layer)
    layer.start()
    layer.await_termination()


def run_speed(cfg: Config) -> None:
    from oryx_tpu_torch.lambda_.speed import SpeedLayer

    layer = SpeedLayer(cfg)
    close_at_shutdown(layer)
    _install_signal_handlers(layer)
    layer.start()
    layer.await_termination()


def run_serving(cfg: Config) -> None:
    from oryx_tpu_torch.serving.layer import ServingLayer

    layer = ServingLayer(cfg)
    close_at_shutdown(layer)
    _install_signal_handlers(layer)
    layer.start()
    layer.await_termination()


def run_bus_setup(cfg: Config) -> None:
    """Create the input topic with its partitions and the update topic,
    then report each."""
    from oryx_tpu_torch.bus import core as bus

    input_broker = cfg.get_string("oryx.input-topic.broker")
    input_topic = cfg.get_string("oryx.input-topic.message.topic")
    input_parts = cfg.get_optional_int("oryx.input-topic.message.partitions") or 1
    bus.maybe_create_topic(input_broker, input_topic, input_parts)
    print(f"created (or found) input topic {input_topic} "
          f"({input_parts} partitions) on {input_broker}")

    update_broker = cfg.get_optional_string("oryx.update-topic.broker")
    update_topic = cfg.get_optional_string("oryx.update-topic.message.topic")
    if update_broker and update_topic:
        update_parts = cfg.get_optional_int("oryx.update-topic.message.partitions") or 1
        max_size = cfg.get_optional_int("oryx.update-topic.message.max-size")
        bus.maybe_create_topic(
            update_broker, update_topic, update_parts,
            {"max-size": max_size} if max_size else None,
        )
        print(f"created (or found) update topic {update_topic} "
              f"({update_parts} partitions) on {update_broker}")


def run_bus_tail(cfg: Config, from_beginning: bool = False, out=None,
                 stop_after: int | None = None) -> None:
    """Follow the input and update topics, one line per message as
    '<topic>\t<key>\t<message>'."""
    from oryx_tpu_torch.bus.core import get_broker

    out = out or sys.stdout
    pairs = [(cfg.get_string("oryx.input-topic.broker"),
              cfg.get_string("oryx.input-topic.message.topic"))]
    ub = cfg.get_optional_string("oryx.update-topic.broker")
    ut = cfg.get_optional_string("oryx.update-topic.message.topic")
    if ub and ut:
        pairs.append((ub, ut))
    consumers = [
        (topic, get_broker(loc).consumer(topic, from_beginning=from_beginning))
        for loc, topic in pairs
    ]
    printed = 0
    try:
        while True:
            idle = True
            for topic, consumer in consumers:
                for rec in consumer.poll(timeout=0.2):
                    print(f"{topic}\t{rec.key}\t{rec.message}", file=out)
                    idle = False
                    printed += 1
                    if stop_after is not None and printed >= stop_after:
                        return
            if idle:
                out.flush()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        for _, consumer in consumers:
            consumer.close()


def run_bus_input(cfg: Config, input_file: str | None) -> int:
    """Send lines (of input_file, else standard input) to the input topic,
    keyed by a hex hash of the line so they spread over partitions."""
    from oryx_tpu_torch.bus.core import get_broker

    broker = get_broker(cfg.get_string("oryx.input-topic.broker"))
    topic = cfg.get_string("oryx.input-topic.message.topic")
    parts = cfg.get_optional_int("oryx.input-topic.message.partitions") or 1
    broker.create_topic(topic, parts)

    if input_file:
        if not os.path.exists(input_file):
            raise SystemExit(f"Input file {input_file} does not exist")
        f = open(input_file, "r", encoding="utf-8")
    else:
        f = sys.stdin
    sent = 0
    try:
        with broker.producer(topic) as producer:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                key = hashlib.md5(line.encode("utf-8")).hexdigest()
                producer.send(key, line)
                sent += 1
    finally:
        if f is not sys.stdin:
            f.close()
    print(f"sent {sent} messages to {topic}")
    return sent


def run_config_dump(cfg: Config, out=None) -> None:
    """Dump the resolved oryx.* tree as key=value lines for shell
    consumption (the reference's ConfigToProperties)."""
    out = out or sys.stdout
    props = cfg.get_config("oryx").to_properties(prefix="oryx")
    for key in sorted(props):
        print(f"{key}={props[key]}", file=out)


def run_health(cfg: Config, out=None) -> int:
    """Probe the serving layer's /healthz and /readyz (docs/resilience.md)
    and print one line per endpoint, then compare the live generation
    /healthz reports against the registry's CHAMPION pointer — serving
    answering from a generation the registry no longer endorses is the
    skew this probe exists to catch. Exit 0 only when everything is green
    and in sync."""
    import json
    from urllib.error import URLError
    from urllib.request import urlopen

    out = out or sys.stdout
    scheme = "https" if cfg.get_optional_string("oryx.serving.api.keystore-file") else "http"
    port = cfg.get_int(
        "oryx.serving.api.secure-port" if scheme == "https" else "oryx.serving.api.port"
    )
    ctx_path = cfg.get_string("oryx.serving.api.context-path").rstrip("/")
    ok = True
    live_generation = None
    tenant_generations: dict | None = None
    for endpoint in ("/healthz", "/readyz"):
        url = f"{scheme}://localhost:{port}{ctx_path}{endpoint}"
        try:
            with urlopen(url, timeout=5) as resp:
                status, body = resp.status, resp.read()
        except URLError as e:
            resp = getattr(e, "fp", None)
            if resp is None:
                print(f"{endpoint}: unreachable ({e})", file=out)
                ok = False
                continue
            status, body = e.code, resp.read()
        try:
            detail = json.loads(body)
        except ValueError:
            detail = None
        if endpoint == "/healthz" and isinstance(detail, dict):
            live_generation = detail.get("live_generation")
            tenants = detail.get("tenants")
            if isinstance(tenants, dict):
                tenant_generations = tenants
            # unified operator verdict (ok/degraded/draining/down) plus the
            # overload ladder's current rung when it is shedding quality
            unified = detail.get("status")
            if unified is not None:
                shed = detail.get("shed_stage")
                summary = f"status={unified}"
                if shed and shed != "full":
                    summary += f" shed_stage={shed}"
                print(f"{endpoint}: {summary}", file=out)
        print(f"{endpoint}: {status}" + (f" {detail}" if detail is not None else ""), file=out)
        ok = ok and status == 200

    model_dir = cfg.get_optional_string("oryx.batch.storage.model-dir")
    if model_dir:
        from oryx_tpu_torch.registry.store import RegistryStore

        champion = RegistryStore(model_dir).champion_id()
        if live_generation is not None and champion is not None:
            if live_generation == champion:
                print(f"generations: live={live_generation} champion={champion} (in sync)", file=out)
            else:
                print(f"generations: live={live_generation} champion={champion} SKEW", file=out)
                ok = False
        else:
            print(f"generations: live={live_generation} champion={champion}", file=out)
    # per-tenant skew: each tenant's live generation (from /healthz's
    # tenants map) against that tenant's OWN registry champion — one
    # lagging tenant is skew even when every other tenant is in sync
    if tenant_generations is not None:
        from oryx_tpu_torch.registry.store import RegistryStore
        from oryx_tpu_torch.tenancy import TenantRegistry, tenant_config

        registry = TenantRegistry.from_config(cfg)
        for tid in sorted(tenant_generations):
            live = tenant_generations[tid]
            spec = registry.get(tid) if registry is not None else None
            champion = None
            if spec is not None:
                tenant_model_dir = tenant_config(cfg, spec).get_optional_string(
                    "oryx.batch.storage.model-dir"
                )
                if tenant_model_dir and os.path.isdir(tenant_model_dir):
                    champion = RegistryStore(tenant_model_dir).champion_id()
            if champion is None:
                print(f"tenant {tid}: live={live}", file=out)
            elif live == champion:
                print(f"tenant {tid}: live={live} champion={champion} (in sync)", file=out)
            else:
                print(f"tenant {tid}: live={live} champion={champion} SKEW", file=out)
                ok = False
    return 0 if ok else 1


def run_tenants(cfg: Config, subcommand: str | None, tenant_id: str | None, out=None) -> int:
    """Tenancy operator surface (docs/multi-tenancy.md):

        tenants list          one line per declared tenant: app, weight,
                              quota, SLO p99 (the fair-share inputs)
        tenants show <id>     the tenant's full derived identity as JSON —
                              namespaced topics, registry root, wired
                              classes — plus its registry's champion when
                              the model dir exists
    """
    import json

    from oryx_tpu_torch.tenancy import TenantRegistry, tenant_config

    out = out or sys.stdout
    registry = TenantRegistry.from_config(cfg)
    if registry is None:
        print("tenancy disabled (oryx.tenancy.enabled = false or no tenants declared)", file=out)
        return 1
    if subcommand not in TENANTS_SUBCOMMANDS:
        raise SystemExit(
            f"tenants requires a subcommand: {' | '.join(TENANTS_SUBCOMMANDS)}"
        )

    if subcommand == "list":
        for spec in registry:
            marker = " *default*" if spec.tenant_id == registry.default_tenant else ""
            quota = f"{spec.quota_qps:g}qps" if spec.quota_qps else "-"
            print(
                f"{spec.tenant_id}\tapp={spec.app}\tweight={spec.weight:g}\t"
                f"quota={quota}\tslo_p99={spec.slo_p99_ms:g}ms{marker}",
                file=out,
            )
        return 0

    if tenant_id is None:
        raise SystemExit("tenants show requires a tenant id")
    spec = registry.get(tenant_id)
    if spec is None:
        print(f"no such tenant {tenant_id!r} (declared: {', '.join(registry.ids())})", file=out)
        return 1
    tcfg = tenant_config(cfg, spec)
    model_dir = tcfg.get_optional_string("oryx.batch.storage.model-dir")
    view = {
        "tenant": spec.tenant_id,
        "app": spec.app,
        "weight": spec.weight,
        "quota_qps": spec.quota_qps,
        "slo": {
            "p99_ms": spec.slo_p99_ms,
            "error_rate": spec.slo_error_rate,
            "min_full_quality": spec.slo_min_full_quality,
        },
        "input_topic": tcfg.get_optional_string("oryx.input-topic.message.topic"),
        "update_topic": tcfg.get_optional_string("oryx.update-topic.message.topic"),
        "model_dir": model_dir,
        "wiring": {
            "update_class": spec.wiring("update-class"),
            "speed_manager": spec.wiring("speed-manager"),
            "serving_manager": spec.wiring("serving-manager"),
            "resources": spec.resource_modules(),
        },
    }
    if model_dir and os.path.isdir(model_dir):
        from oryx_tpu_torch.registry.store import RegistryStore

        store = RegistryStore(model_dir)
        view["champion"] = store.champion_id()
        view["generations"] = store.list_generations()
    print(json.dumps(view, indent=2), file=out)
    return 0


def run_lint(cfg: Config, out=None, select: str | None = None) -> int:
    """Run the port's static-analysis suite over its default targets with
    the checked-in baseline — the same gate tier-1 runs
    (tests/test_torch_lint_tree.py), as an operator command next to
    ``health``. ``select``: comma-separated pass ids to run. Exit 0
    only when the tree is clean."""
    from oryx_tpu_torch.analysis import run_passes

    out = out or sys.stdout
    res = run_passes(select=set(select.split(",")) if select else None)
    for f in res.findings:
        print(f.render(), file=out)
    for key in sorted(res.stale_baseline):
        print(f"note: stale baseline entry (no longer fires): {key}", file=out)
    verdict = (
        "clean"
        if res.rc == 0
        else f"{len(res.findings)} finding(s)"
    )
    print(f"oryxlint: {verdict} ({len(res.suppressed)} baselined)", file=out)
    return res.rc


def run_repair(cfg: Config, out=None) -> int:
    """Offline fsck across every durable store the config names
    (docs/durability.md): bus topic logs (torn tails, unreadable offset
    ledgers, garbled shm frames), the model registry layout (stale
    commit temps, half-written generations, an unusable CHAMPION), and
    the serving restage cache. The same audits run automatically on
    consumer open / MLUpdate start / stager construction; this command
    runs them all at once, with everything down, and prints what was
    repaired. Run it with the layers stopped — a registry fsck racing an
    in-flight promote mistakes a generation mid-upload for a torn one.

    Exit 0 when every store is clean or repaired; repairs are also
    visible on the bus.repair.* / registry.repair.* counters."""
    out = out or sys.stdout
    repaired_anything = False

    seen: set[str] = set()
    for key in ("oryx.input-topic.broker", "oryx.update-topic.broker"):
        loc = cfg.get_optional_string(key)
        if not loc or loc in seen:
            continue
        seen.add(loc)
        from oryx_tpu_torch.bus.core import get_broker

        broker = get_broker(loc)
        if not hasattr(broker, "repair"):
            print(f"bus {loc}: no repairable on-disk state ({type(broker).__name__})", file=out)
            continue
        report = broker.repair()
        # "frames" counts intact frames walked, not repairs
        repaired_anything |= any(v for k, v in report.items() if k != "frames")
        summary = ", ".join(f"{k}={v}" for k, v in sorted(report.items()) if v)
        print(f"bus {loc}: {summary or 'clean'}", file=out)

    model_dir = cfg.get_optional_string("oryx.batch.storage.model-dir")
    if model_dir:
        from oryx_tpu_torch.registry.store import RegistryStore

        report = RegistryStore(model_dir).fsck(repair=True)
        repaired_anything |= any(report.values())
        summary = ", ".join(f"{k}={v}" for k, v in sorted(report.items()) if v)
        print(f"registry {model_dir}: {summary or 'clean'}", file=out)

    restage_dir = cfg.get_optional_string("oryx.serving.restage-dir")
    if restage_dir and os.path.isdir(restage_dir):
        from oryx_tpu_torch.serving.restage import ModelStager

        swept = ModelStager(restage_dir).swept_on_open
        repaired_anything |= swept > 0
        print(f"restage {restage_dir}: " + (f"swept={swept}" if swept else "clean"), file=out)

    print("repair: " + ("repairs applied" if repaired_anything else "all stores clean"), file=out)
    return 0


def run_models(cfg: Config, subcommand: str | None, generation: str | None, out=None) -> int:
    """Registry operator surface (docs/model-registry.md):

        models list             one line per generation + the champion
        models show <gen>       the generation's manifest, as JSON
        models rollback <gen>   republish an archived generation onto the
                                update topic and move the CHAMPION pointer
        models gc               apply oryx.ml.retention.max-generations now
    """
    from oryx_tpu_torch.registry.store import RegistryStore, publish_generation

    out = out or sys.stdout
    if subcommand not in MODELS_SUBCOMMANDS:
        raise SystemExit(
            f"models requires a subcommand: {' | '.join(MODELS_SUBCOMMANDS)}"
        )
    model_dir = cfg.get_string("oryx.batch.storage.model-dir")
    store = RegistryStore(model_dir)

    if subcommand == "list":
        champion = store.champion_id()
        gens = store.list_generations()
        if not gens:
            print(f"no generations under {model_dir}", file=out)
            return 0
        for gen in gens:
            manifest = store.read_manifest(gen)
            status = manifest.status if manifest else "?"
            metric = manifest.eval_metric if manifest else None
            marker = " *champion*" if gen == champion else ""
            print(f"{gen}\t{status}\teval={metric}{marker}", file=out)
        return 0

    if subcommand == "gc":
        deleted = store.gc(cfg.get_int("oryx.ml.retention.max-generations"))
        print(f"deleted {len(deleted)} generation(s): {deleted}", file=out)
        return 0

    if generation is None:
        raise SystemExit(f"models {subcommand} requires a generation id")
    if not store.has_generation(generation):
        print(f"no such generation {generation} under {model_dir}", file=out)
        return 1

    if subcommand == "show":
        manifest = store.read_manifest(generation)
        if manifest is None:
            print(f"generation {generation} has no manifest", file=out)
            return 1
        print(manifest.to_json(), file=out)
        return 0

    # rollback: same path the serving endpoint takes — republish, then
    # move the champion so batch gates/warm-starts against it
    from oryx_tpu_torch.bus.core import get_broker

    broker_loc = cfg.get_optional_string("oryx.update-topic.broker")
    topic = cfg.get_optional_string("oryx.update-topic.message.topic")
    if not broker_loc or not topic:
        raise SystemExit("models rollback requires an update topic in config")
    with get_broker(broker_loc).producer(topic) as producer:
        key = publish_generation(
            store, generation, producer,
            cfg.get_int("oryx.update-topic.message.max-size"),
        )
    store.set_champion(generation)
    print(f"republished generation {generation} as {key}; champion moved", file=out)
    return 0


def run_experiments(cfg: Config, out=None) -> int:
    """Fetch and pretty-print the serving layer's GET /experiments body
    (docs/experiments.md): arm split config, champion/challenger
    generations, per-arm online metrics, and the standing online-gate
    decision. Exit 0 when the endpoint answered, 1 when unreachable."""
    import json
    from urllib.error import URLError
    from urllib.request import urlopen

    out = out or sys.stdout
    scheme = "https" if cfg.get_optional_string("oryx.serving.api.keystore-file") else "http"
    port = cfg.get_int(
        "oryx.serving.api.secure-port" if scheme == "https" else "oryx.serving.api.port"
    )
    ctx_path = cfg.get_string("oryx.serving.api.context-path").rstrip("/")
    url = f"{scheme}://localhost:{port}{ctx_path}/experiments"
    try:
        with urlopen(url, timeout=10) as resp:
            body = resp.read().decode("utf-8", "replace")
    except URLError as e:
        print(f"/experiments: unreachable ({e})", file=out)
        return 1
    try:
        print(json.dumps(json.loads(body), indent=2, sort_keys=True), file=out)
    except ValueError:
        print(body, file=out)
    return 0


def run_bus_serve(cfg: Config, bind: str, data_dir: str | None) -> None:
    """Serve a bus over TCP (oryx_tpu_torch.bus.netbus): the topic logs
    live in data_dir on this host, and every layer on any host reaches
    them through a tcp://host:port locator."""
    host, _, port = bind.partition(":")
    if data_dir is None:
        loc = cfg.get_string("oryx.input-topic.broker")
        if not loc.startswith("file:"):
            raise SystemExit(
                "--data-dir required (input-topic broker is not a file: path)"
            )
        # the path get_broker opens: leading '//' pairs stripped, so
        # file:///var/x serves the same /var/x a co-located layer opens
        data_dir = loc[len("file:"):]
        while data_dir.startswith("//"):
            data_dir = data_dir[1:]
    from oryx_tpu_torch.bus.netbus import BusServer

    server = BusServer((host or "0.0.0.0", int(port or 6378)), data_dir)
    log.info("bus-serve: tcp://%s:%s over %s", host, server.server_address[1], data_dir)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


def run_trace(cfg: Config, trace_id: str | None = None, out=None) -> int:
    """Dump the serving layer's recorded spans as Chrome-trace JSON: fetch
    GET /trace from the configured serving port, optionally filtered to
    one trace id, and print it. Exit 0 when the layer answered, 1 when it
    is unreachable."""
    from urllib.error import URLError
    from urllib.request import urlopen

    out = out or sys.stdout
    scheme = "https" if cfg.get_optional_string("oryx.serving.api.keystore-file") else "http"
    port = cfg.get_int(
        "oryx.serving.api.secure-port" if scheme == "https" else "oryx.serving.api.port"
    )
    ctx_path = cfg.get_string("oryx.serving.api.context-path").rstrip("/")
    url = f"{scheme}://localhost:{port}{ctx_path}/trace"
    if trace_id:
        url += f"?trace={trace_id}"
    try:
        with urlopen(url, timeout=10) as resp:
            body = resp.read().decode("utf-8", "replace")
    except URLError as e:
        print(f"/trace: unreachable ({e})", file=out)
        return 1
    print(body, file=out)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)-5s %(name)s: %(message)s",
    )
    for d in args.app_dir:
        sys.path.insert(0, os.path.abspath(d))
    if args.device == "cpu":
        from oryx_tpu_torch.device import set_device

        set_device("cpu")
    cfg = load_config(args.conf, args.set)
    if args.command == "batch":
        run_batch(cfg)
    elif args.command == "speed":
        run_speed(cfg)
    elif args.command == "serving":
        run_serving(cfg)
    elif args.command == "bus-setup":
        run_bus_setup(cfg)
    elif args.command == "bus-serve":
        run_bus_serve(cfg, args.bind, args.data_dir)
    elif args.command == "bus-tail":
        run_bus_tail(cfg, from_beginning=args.from_beginning)
    elif args.command == "bus-input":
        run_bus_input(cfg, args.input_file)
    elif args.command == "config":
        run_config_dump(cfg)
    elif args.command == "health":
        return run_health(cfg)
    elif args.command == "models":
        return run_models(cfg, args.subcommand, args.generation)
    elif args.command == "tenants":
        return run_tenants(cfg, args.subcommand, args.generation)
    elif args.command == "trace":
        return run_trace(cfg, args.subcommand)
    elif args.command == "experiments":
        return run_experiments(cfg)
    elif args.command == "lint":
        return run_lint(cfg, select=args.select)
    elif args.command == "repair":
        return run_repair(cfg)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
