"""The port's operator commands (``python -m oryx_tpu_torch config |
health | models | tenants | experiments | repair``) against the JAX
package's, on the same config and the same (or an identically built)
model dir: the same output lines and the same exit codes.

- ``config``: the same ``key=value`` lines, less the JAX package's two
  TPU scan-tile keys (``oryx.serving.scan.block`` / ``chunk``), which the
  port's packaged defaults do not carry.
- ``models list | show | rollback | gc`` on one seeded registry: equal
  lines, equal manifests, the same generation republished and the
  CHAMPION moved alike, the same generations collected.
- ``tenants list | show``: equal lines; ``show``'s JSON equal once the
  JAX package's class names are read as the port's.
- ``repair`` over a torn file bus, a CHAMPION naming a missing generation
  and promote litter: the same lines (the directory masked), the stores
  repaired alike, and a second pass clean in both.
- ``health`` and ``experiments`` against each package's serving layer
  (the probe app, one generation live): equal lines where the bodies
  agree, the same exit codes for in sync, skewed, not ready and
  unreachable.
- ``lint`` is not a port command, and ``--help`` says why.
"""

import io
import json
import socket
import time
import urllib.request
from pathlib import Path

import pytest

from oryx_tpu import bus as jbus
from oryx_tpu import cli as jcli
from oryx_tpu.app import pmml as japp_pmml
from oryx_tpu.common import corruption as jcorruption
from oryx_tpu.common import pmml as jpmml
from oryx_tpu.registry.manifest import GenerationManifest as JaxManifest
from oryx_tpu.registry.store import RegistryStore as JaxStore
from oryx_tpu.serving.layer import ServingLayer as JaxServingLayer
from oryx_tpu_torch import bus as tbus
from oryx_tpu_torch import cli as tcli
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app import pmml as tapp_pmml
from oryx_tpu_torch.bus import faultbus
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import corruption as tcorruption
from oryx_tpu_torch.common import pmml as tpmml
from oryx_tpu_torch.common.ledger import ledger
from oryx_tpu_torch.registry.manifest import GenerationManifest
from oryx_tpu_torch.registry.store import RegistryStore
from oryx_tpu_torch.serving.layer import ServingLayer

pytestmark = pytest.mark.registry

PACKAGES = {
    "jax": dict(name="oryx_tpu", cli=jcli, bus=jbus, app_pmml=japp_pmml, pmml=jpmml,
                manifest=JaxManifest, store=JaxStore, layer=JaxServingLayer,
                corruption=jcorruption),
    "torch": dict(name="oryx_tpu_torch", cli=tcli, bus=tbus, app_pmml=tapp_pmml, pmml=tpmml,
                  manifest=GenerationManifest, store=RegistryStore, layer=ServingLayer,
                  corruption=tcorruption),
}
# the JAX package's TPU scan tiles: keys the port's packaged defaults lack
JAX_ONLY_KEYS = ("oryx.serving.scan.block=", "oryx.serving.scan.chunk=")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.delenv("ORYX_CONF", raising=False)
    port_device.set_device("cpu")
    before = ledger.counts()
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    faultbus.reset()
    deadline = time.monotonic() + 5.0
    while True:
        after = ledger.counts()
        if all(after.get(k, 0) <= before.get(k, 0) for k in after) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert all(after.get(k, 0) <= before.get(k, 0) for k in after), (before, after)


def make_config(pkg: str, root: Path, broker: str, retention: int = -1, extra: str = ""):
    name = PACKAGES[pkg]["name"]
    return PACKAGES[pkg]["cli"].load_config(None, []).with_overlay(
        f"""
        oryx {{
          id = "CLIOps"
          input-topic.broker = "{broker}"
          update-topic.broker = "{broker}"
          batch.storage {{ data-dir = "{root}/data/", model-dir = "{root}/model/" }}
          ml.retention.max-generations = {retention}
          serving {{
            api.port = 0
            model-manager-class = "{name}.registry.testing.PMMLProbeServingModelManager"
            application-resources = "{name}.registry.testing"
          }}
          {extra}
        }}
        """
    )


def seed_registry(pkg: str, root: Path, model_dir: Path | None = None):
    """Generations 100, 200 (champion) and 300 under ``model_dir``
    (``<root>/model`` by default), each a PMML carrying its generation,
    with fixed manifests."""
    m = PACKAGES[pkg]
    model_dir = model_dir or root / "model"
    store = m["store"](str(model_dir))
    for gen, metric in (("100", 0.8), ("200", 0.9), ("300", 0.85)):
        d = model_dir / gen
        d.mkdir(parents=True)
        xml = m["pmml"].build_skeleton_pmml()
        m["app_pmml"].add_extension(xml, "generation", gen)
        m["pmml"].write_pmml(xml, d / "model.pmml")
        store.write_manifest(m["manifest"](
            generation_id=gen, eval_metric=metric, created_at_ms=int(gen) * 1000,
            parent_id=None if gen == "100" else "100", train_count=6, test_count=3))
    store.set_champion("200", now_ms=5000)
    return store


def call(pkg: str, fn: str, *args, **kw):
    """(exit code, output lines) of one command function."""
    out = io.StringIO()
    rc = getattr(PACKAGES[pkg]["cli"], fn)(*args, out=out, **kw)
    return rc, out.getvalue().splitlines()


def test_config_dump_equals_the_reference(tmp_path):
    overlay = 'oryx { id = "Dump", batch.streaming.generation-interval-sec = 42 }'
    lines = {}
    for pkg in PACKAGES:
        cfg = PACKAGES[pkg]["cli"].load_config(None, ["oryx.speed.ui.port=4041"])
        out = io.StringIO()
        PACKAGES[pkg]["cli"].run_config_dump(cfg.with_overlay(overlay), out=out)
        lines[pkg] = out.getvalue().splitlines()
    assert lines["torch"] == [l for l in lines["jax"] if not l.startswith(JAX_ONLY_KEYS)]
    assert "oryx.id=Dump" in lines["torch"] and "oryx.speed.ui.port=4041" in lines["torch"]


def test_config_command_through_main(tmp_path, capsys, monkeypatch):
    conf = tmp_path / "oryx.conf"
    conf.write_text('oryx { id = "MainDump" }\n')
    out = {}
    for pkg in PACKAGES:
        assert PACKAGES[pkg]["cli"].main(["config", "--conf", str(conf)]) == 0
        out[pkg] = capsys.readouterr().out.splitlines()
        monkeypatch.delenv("ORYX_CONF", raising=False)
    assert out["torch"] == [l for l in out["jax"] if not l.startswith(JAX_ONLY_KEYS)]
    assert "oryx.id=MainDump" in out["torch"]


@pytest.mark.parametrize("args", [("list", None), ("show", "100"), ("show", "200"),
                                  ("show", "404")])
def test_models_list_and_show_equal_the_reference(tmp_path, args):
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        seed_registry(pkg, root)
        cfg = make_config(pkg, root, f"inproc://cli-ops-{pkg}")
        rc, lines = call(pkg, "run_models", cfg, *args)
        out[pkg] = (rc, [l.replace(str(root), "<root>") for l in lines])
    assert out["torch"] == out["jax"]
    rc, lines = out["torch"]
    if args[0] == "list":
        assert rc == 0 and len(lines) == 3 and "*champion*" in lines[1]
    elif args[1] == "404":
        assert rc == 1 and lines == ["no such generation 404 under <root>/model/"]
    else:
        assert rc == 0 and json.loads("\n".join(lines))["generation_id"] == args[1]


@pytest.mark.parametrize("args", [("show", None), ("frobnicate", None), (None, None)])
def test_models_usage_errors_exit_alike(tmp_path, args):
    messages = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        seed_registry(pkg, root)
        with pytest.raises(SystemExit) as e:
            call(pkg, "run_models", make_config(pkg, root, f"inproc://cli-ops-{pkg}"), *args)
        messages[pkg] = str(e.value)
    assert messages["torch"] == messages["jax"]


def test_models_rollback_republishes_and_moves_the_champion_alike(tmp_path):
    got = {}
    for pkg in PACKAGES:
        m = PACKAGES[pkg]
        root, loc = tmp_path / pkg, f"inproc://cli-ops-rollback-{pkg}"
        store = seed_registry(pkg, root)
        broker = m["bus"].get_broker(loc)
        broker.create_topic("OryxUpdate", 1)
        tail = broker.consumer("OryxUpdate", from_beginning=True)
        rc, lines = call(pkg, "run_models", make_config(pkg, root, loc), "rollback", "100")
        msgs = tail.poll(timeout=1.0)
        tail.close()
        xml = m["pmml"].from_string(msgs[0].message)
        got[pkg] = (rc, lines, store.champion_id(), [r.key for r in msgs],
                    m["app_pmml"].get_extension_value(xml, "generation"))
    assert got["torch"] == got["jax"]
    assert got["torch"] == (0, ["republished generation 100 as MODEL; champion moved"], "100",
                            ["MODEL"], "100")


@pytest.mark.parametrize("retention", [1, 2, -1])
def test_models_gc_collects_alike(tmp_path, retention):
    got = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        store = seed_registry(pkg, root)
        cfg = make_config(pkg, root, f"inproc://cli-ops-{pkg}", retention=retention)
        rc, lines = call(pkg, "run_models", cfg, "gc", None)
        got[pkg] = (rc, lines, store.list_generations())
    assert got["torch"] == got["jax"]
    if retention == 1:
        assert got["torch"][2] == ["200", "300"]


TENANTS = """
  tenancy {
    enabled = true
    default-tenant = "movies"
    tenants {
      movies { app = "als", weight = 2.0, quota-qps = 50, slo { p99-ms = 250 } }
      sensors { app = "kmeans", weight = 1.0 }
      churn { app = "rdf", weight = 0.5, slo { error-rate = 0.01, min-full-quality = 0.9 } }
      probe { app = "probe" }
    }
  }
"""


def _as_port(text: str) -> str:
    return text.replace("oryx_tpu.", "oryx_tpu_torch.")


@pytest.mark.parametrize("args", [("list", None), ("show", "movies"), ("show", "churn"),
                                  ("show", "probe"), ("show", "nobody")])
def test_tenants_list_and_show_equal_the_reference(tmp_path, args):
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        cfg = make_config(pkg, root, f"inproc://cli-ops-{pkg}", extra=TENANTS)
        if args[1] == "probe":  # a tenant registry to report the champion of
            seed_registry(pkg, root, root / "model" / "probe")
        rc, lines = call(pkg, "run_tenants", cfg, *args)
        out[pkg] = (rc, [l.replace(str(root), "<root>") for l in lines])
    assert out["torch"] == (out["jax"][0], [_as_port(l) for l in out["jax"][1]])
    rc, lines = out["torch"]
    if args[0] == "list":
        assert rc == 0 and len(lines) == 4
        assert [l.split("\t")[0] for l in lines if l.endswith("*default*")] == ["movies"]
    elif args[1] == "nobody":
        assert rc == 1
    else:
        view = json.loads("\n".join(lines))
        assert view["tenant"] == args[1] and view["wiring"]["serving_manager"].startswith(
            "oryx_tpu_torch.")


def test_tenants_disabled_and_usage_alike(tmp_path):
    got = {}
    for pkg in PACKAGES:
        cfg = make_config(pkg, tmp_path / pkg, f"inproc://cli-ops-{pkg}")
        disabled = call(pkg, "run_tenants", cfg, "list", None)
        with pytest.raises(SystemExit) as e:
            call(pkg, "run_tenants",
                 make_config(pkg, tmp_path / pkg, f"inproc://cli-ops-{pkg}", extra=TENANTS),
                 "frobnicate", None)
        got[pkg] = (disabled, str(e.value))
    assert got["torch"] == got["jax"] and got["torch"][0][0] == 1


def _corrupted_stores(pkg: str, root: Path):
    """A file bus with a torn input partition, a registry whose CHAMPION
    names a missing generation beside promote litter, a restage dir."""
    m = PACKAGES[pkg]
    broker = m["bus"].get_broker(f"file:{root}/bus")
    broker.create_topic("OryxInput", partitions=1)
    with broker.producer("OryxInput") as p:
        for j in range(4):
            p.send(None, f"x{j},y{j}")
    m["corruption"].tear_filebus_partition(root / "bus", "OryxInput", cut=2)
    model_dir = root / "model"
    (model_dir / "100").mkdir(parents=True)
    (model_dir / "100" / "model.pmml").write_text("<PMML generation=100/>")
    m["store"](str(model_dir)).set_champion("100")
    m["corruption"].point_champion_at(model_dir, "31337")
    m["corruption"].litter_promote(model_dir)
    return m["cli"].load_config(None, []).with_overlay(
        f"""
        oryx {{
          input-topic.broker = "file:{root}/bus"
          update-topic.broker = "file:{root}/bus"
          batch.storage.model-dir = "{model_dir}/"
          serving.restage-dir = "{root}/cache"
        }}
        """
    )


def test_repair_sweeps_every_store_alike(tmp_path):
    got = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        cfg = _corrupted_stores(pkg, root)
        (root / "cache").mkdir()
        first = call(pkg, "run_repair", cfg)
        second = call(pkg, "run_repair", cfg)
        champion = PACKAGES[pkg]["store"](str(root / "model")).champion_id()
        got[pkg] = [(rc, [l.replace(str(root), "<root>") for l in lines])
                    for rc, lines in (first, second)] + [champion]
    assert got["torch"] == got["jax"]
    (rc1, lines1), (rc2, lines2), champion = got["torch"]
    assert rc1 == rc2 == 0 and champion == "100"
    assert lines1[-1] == "repair: repairs applied" and lines2[-1] == "repair: all stores clean"


def test_repair_reports_a_bus_without_disk_state_alike(tmp_path):
    got = {}
    for pkg in PACKAGES:
        cfg = PACKAGES[pkg]["cli"].load_config(None, []).with_overlay(
            f'oryx {{ input-topic.broker = "inproc://cli-ops-repair-{pkg}", '
            f'update-topic.broker = "inproc://cli-ops-repair-{pkg}", '
            f'batch.storage.model-dir = "{tmp_path / pkg}/model/" }}')
        rc, lines = call(pkg, "run_repair", cfg)
        got[pkg] = (rc, [l.replace(f"-{pkg}", "-<pkg>").replace(str(tmp_path / pkg), "<root>")
                         for l in lines])
    assert got["torch"] == got["jax"] and got["torch"][0] == 0


def _start_layer(pkg: str, root: Path, loc: str, extra: str = ""):
    layer = PACKAGES[pkg]["layer"](make_config(pkg, root, loc, extra=extra))
    layer.start()
    return layer


def _publish(pkg: str, root: Path, loc: str, gen: str) -> None:
    with PACKAGES[pkg]["bus"].get_broker(loc).producer("OryxUpdate") as p:
        p.send("MODEL", (root / "model" / gen / "model.pmml").read_text())


def _wait_live(base: str, gen: str) -> None:
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(f"{base}/readyz", timeout=5) as resp:
                if resp.status == 200:
                    with urllib.request.urlopen(f"{base}/healthz", timeout=5) as h:
                        if json.loads(h.read()).get("live_generation") == gen:
                            return
        except OSError:
            pass
        time.sleep(0.05)
    raise AssertionError(f"{base} never served generation {gen}")


VOLATILE = ("staleness_s", "last_update_age_s", "uptime_s", "age_s")


def _health_shape(lines: list[str]) -> list:
    """Health lines with each printed body reduced to its keys and its
    non-volatile values."""
    shaped = []
    for line in lines:
        head, sep, rest = line.partition(" {")
        if not sep:
            shaped.append(line)
            continue
        body = eval("{" + rest)  # the command prints the body's repr
        shaped.append((head, sorted(body),
                       {k: v for k, v in body.items() if k not in VOLATILE and
                        not isinstance(v, float)}))
    return shaped


def test_health_against_each_packages_layer_alike(tmp_path):
    got = {}
    for pkg in PACKAGES:
        root, loc = tmp_path / pkg, f"inproc://cli-ops-health-{pkg}"
        store = seed_registry(pkg, root)
        layer = _start_layer(pkg, root, loc)
        try:
            probe = make_config(pkg, root, loc).with_overlay(
                f"oryx.serving.api.port = {layer.port}")
            not_ready = call(pkg, "run_health", probe)
            _publish(pkg, root, loc, "200")
            _wait_live(f"http://127.0.0.1:{layer.port}", "200")
            in_sync = call(pkg, "run_health", probe)
            store.set_champion("300", now_ms=6000)
            skewed = call(pkg, "run_health", probe)
        finally:
            layer.close()
        unreachable = call(pkg, "run_health", probe)
        got[pkg] = [(rc, _health_shape(lines)) for rc, lines in
                    (not_ready, in_sync, skewed)] + [
            (unreachable[0], [l.split(" (")[0] for l in unreachable[1]])]
    assert got["torch"] == got["jax"]
    (rc0, nr), (rc1, sync), (rc2, skew), (rc3, gone) = got["torch"]
    assert (rc0, rc1, rc2, rc3) == (1, 0, 1, 1)
    assert "generations: live=200 champion=200 (in sync)" in sync
    assert "generations: live=200 champion=300 SKEW" in skew
    assert gone[:2] == ["/healthz: unreachable", "/readyz: unreachable"]


def test_experiments_against_each_packages_layer_alike(tmp_path):
    got = {}
    for pkg in PACKAGES:
        root, loc = tmp_path / pkg, f"inproc://cli-ops-exp-{pkg}"
        seed_registry(pkg, root)
        layer = _start_layer(pkg, root, loc, extra="serving.ab { fraction = 0.25 }")
        try:
            _publish(pkg, root, loc, "200")
            _wait_live(f"http://127.0.0.1:{layer.port}", "200")
            probe = make_config(pkg, root, loc).with_overlay(
                f"oryx.serving.api.port = {layer.port}")
            rc, lines = call(pkg, "run_experiments", probe)
        finally:
            layer.close()
        body = json.loads("\n".join(lines))
        assert body["report"].pop("started_at") > 0  # the evaluator's wall clock
        got[pkg] = (rc, body)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()[1]
        rc, lines = call(pkg, "run_experiments",
                         probe.with_overlay(f"oryx.serving.api.port = {dead}"))
        got[pkg] += (rc, [l.split(" (")[0] for l in lines])
    assert got["torch"] == got["jax"]
    rc, body, rc_gone, gone = got["torch"]
    assert rc == 0 and body["fraction"] == 0.25 and body["champion"] == "200"
    assert rc_gone == 1 and gone == ["/experiments: unreachable"]


def test_lint_is_not_a_port_command_and_help_says_why(capsys):
    assert "lint" in jcli.COMMANDS and "lint" not in tcli.COMMANDS
    assert set(tcli.COMMANDS) == set(jcli.COMMANDS) - {"lint"}
    assert tcli.MODELS_SUBCOMMANDS == jcli.MODELS_SUBCOMMANDS
    assert tcli.TENANTS_SUBCOMMANDS == jcli.TENANTS_SUBCOMMANDS
    with pytest.raises(SystemExit) as e:
        tcli.main(["lint"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    assert "'lint' command" in capsys.readouterr().out
