"""The port's model-lineage endpoints and MODEL-REF restage cache
(``GET /model/generations``, ``POST /model/rollback/<generation>``,
oryx_tpu_torch/serving/restage.py) against the JAX package's, on the CPU.

- tests/registry/test_registry_e2e.py on both packages: generations A,
  B (gated) and C through each package's MLUpdate harness with the
  probe app; the ``/model/generations`` bodies are equal (exact: the
  generation ids, statuses, parents, metrics and creation stamps are the
  harness's inputs), and ``POST /model/rollback/A`` answers alike,
  moves CHAMPION and brings A back live in both.
- Rollback across packages: the port's layer lists and rolls back a
  registry the JAX package wrote.
- ``ModelStager``: the same generation dir stages to the same files in
  both; a raise mid-download and tests/chaos/test_restage_crash.py's
  SIGKILL mid-download leave the same litter, which each package's next
  stager sweeps before staging whole.
- MODEL-REF through the restage cache in each package's layer: a
  generation too big for the update topic goes out as a ref, is staged
  under ``oryx.serving.restage-dir/<generation>`` and served, with no
  temporary dir left.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from oryx_tpu import bus as jbus
from oryx_tpu.bus.core import KeyMessage as JaxKeyMessage
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import crashpoints as jcrashpoints
from oryx_tpu.registry.store import RegistryStore as JaxRegistryStore
from oryx_tpu.registry.testing import ScriptedMetricUpdate as JaxScriptedMetricUpdate
from oryx_tpu.serving import restage as jrestage
from oryx_tpu.serving.layer import ServingLayer as JaxServingLayer
from oryx_tpu_torch import bus as tbus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import crashpoints as tcrashpoints
from oryx_tpu_torch.common import metrics as tmetrics
from oryx_tpu_torch.registry.manifest import STATUS_GATED, STATUS_PUBLISHED
from oryx_tpu_torch.registry.store import RegistryStore
from oryx_tpu_torch.registry.testing import ScriptedMetricUpdate
from oryx_tpu_torch.serving import restage as trestage
from oryx_tpu_torch.serving.layer import ServingLayer

REPO_ROOT = Path(__file__).resolve().parent.parent
KILLED = (-int(signal.SIGKILL), 128 + int(signal.SIGKILL))

PACKAGES = {
    "jax": dict(name="oryx_tpu", config=jconfig, bus=jbus, km=JaxKeyMessage,
                store=JaxRegistryStore, update=JaxScriptedMetricUpdate, layer=JaxServingLayer,
                restage=jrestage, crashpoints=jcrashpoints),
    "torch": dict(name="oryx_tpu_torch", config=tconfig, bus=tbus, km=KeyMessage,
                  store=RegistryStore, update=ScriptedMetricUpdate, layer=ServingLayer,
                  restage=trestage, crashpoints=tcrashpoints),
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    for pkg in PACKAGES.values():
        pkg["restage"].set_active(None)


def make_config(pkg, model_dir, broker_loc, metric=1.0, extra=""):
    name = PACKAGES[pkg]["name"]
    return PACKAGES[pkg]["config"].get_default().with_overlay(
        f"""
        oryx {{
          id = "Lineage"
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          batch.storage {{ data-dir = "{model_dir}/../data/"
                           model-dir = "{model_dir}" }}
          serving {{
            api.port = 0
            model-manager-class = "{name}.registry.testing.PMMLProbeServingModelManager"
            application-resources = "{name}.registry.testing"
          }}
          ml {{
            eval {{ candidates = 1, test-fraction = 0.5 }}
            gate.max-regression = 0.05
          }}
          test.scripted-metric = {metric}
          {extra}
        }}
        """
    )


def http(method, url, body=None):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_for(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def run_generation(pkg, model_dir, broker_loc, timestamp_ms, metric, extra=""):
    """One batch generation through the package's MLUpdate harness."""
    mods = PACKAGES[pkg]
    update = mods["update"](make_config(pkg, model_dir, broker_loc, metric, extra))
    broker = mods["bus"].get_broker(broker_loc)
    broker.create_topic("OryxUpdate", 1)
    data = [mods["km"](None, f"r{i}") for i in range(6)]
    with broker.producer("OryxUpdate") as producer:
        update.run_update(timestamp_ms, data, [], str(model_dir), producer)


def probe_generation(base):
    status, body = http("GET", f"{base}/probe/model")
    return json.loads(body)["generation_id"] if status == 200 else None


def gate_and_rollback(pkg, tmp_path) -> dict:
    mods = PACKAGES[pkg]
    model_dir = tmp_path / pkg / "model"
    broker_loc = f"inproc://lineage-{pkg}"
    store = mods["store"](str(model_dir))
    layer = mods["layer"](make_config(pkg, model_dir, broker_loc))
    layer.start()
    base = f"http://127.0.0.1:{layer.port}"
    out = {}
    try:
        run_generation(pkg, model_dir, broker_loc, 1000, metric=0.90)
        assert store.champion_id() == "1000"
        assert wait_for(lambda: probe_generation(base) == "1000")
        run_generation(pkg, model_dir, broker_loc, 2000, metric=0.70)  # gated
        assert store.champion_id() == "1000"
        run_generation(pkg, model_dir, broker_loc, 3000, metric=0.95)
        assert wait_for(lambda: probe_generation(base) == "3000")
        assert layer.model_manager.model_swaps == 2
        status, body = http("GET", f"{base}/model/generations")
        assert status == 200
        out["generations"] = json.loads(body)
        out["missing"] = http("POST", f"{base}/model/rollback/9999")
        status, body = http("POST", f"{base}/model/rollback/1000")
        out["rollback"] = (status, json.loads(body))
        assert wait_for(lambda: probe_generation(base) == "1000")
        out["swaps"] = layer.model_manager.model_swaps
        out["champion"] = store.champion_id()
        out["after"] = json.loads(http("GET", f"{base}/model/generations")[1])
    finally:
        layer.close()
    return out


def test_gate_and_rollback_match_jax(tmp_path):
    rollbacks = tmetrics.registry.counter("serving.model.rollbacks")
    before = rollbacks.value
    got = gate_and_rollback("torch", tmp_path)
    assert rollbacks.value == before + 1
    want = gate_and_rollback("jax", tmp_path)
    assert got == want
    listing = got["generations"]
    assert listing["live_generation"] == listing["champion"] == "3000"
    by_id = {g["generation_id"]: g for g in listing["generations"]}
    assert set(by_id) == {"1000", "2000", "3000"}
    assert by_id["2000"]["status"] == STATUS_GATED
    assert by_id["1000"]["status"] == by_id["3000"]["status"] == STATUS_PUBLISHED
    assert by_id["3000"]["parent_id"] == "1000"  # lineage skips the gated one
    assert got["missing"][0] == 404
    assert got["rollback"] == (200, {"generation_id": "1000", "published_as": "MODEL"})
    assert got["swaps"] == 3 and got["champion"] == "1000"
    assert got["after"]["live_generation"] == got["after"]["champion"] == "1000"


def test_port_rolls_back_a_registry_the_jax_package_wrote(tmp_path):
    model_dir = tmp_path / "jax" / "model"
    for ts, metric in ((1000, 0.9), (2000, 0.95)):
        run_generation("jax", model_dir, "inproc://written-by-jax", ts, metric)
    layer = ServingLayer(make_config("torch", model_dir, "inproc://port-reads"))
    layer.start()
    base = f"http://127.0.0.1:{layer.port}"
    try:
        listing = json.loads(http("GET", f"{base}/model/generations")[1])
        assert [g["generation_id"] for g in listing["generations"]] == ["1000", "2000"]
        assert listing["champion"] == "2000" and listing["live_generation"] is None
        status, body = http("POST", f"{base}/model/rollback/1000")
        assert status == 200 and json.loads(body)["published_as"] == "MODEL"
        assert wait_for(lambda: probe_generation(base) == "1000")
        assert JaxRegistryStore(str(model_dir)).champion_id() == "1000"
    finally:
        layer.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("case, status", [
    ("no-registry", 404), ("read-only", 403), ("no-update-topic", 503)])
def test_rollback_refusals_match(tmp_path, pkg, case, status):
    extra = {
        "no-registry": "batch.storage.model-dir = null",
        "read-only": "serving.api.read-only = true",
        "no-update-topic": "update-topic.message.topic = null",
    }[case]
    model_dir = tmp_path / pkg / "model"
    if case != "no-registry":
        run_generation(pkg, model_dir, f"inproc://refuse-{pkg}-{case}", 1000, 0.9)
    layer = PACKAGES[pkg]["layer"](
        make_config(pkg, model_dir, f"inproc://refuse-{pkg}-{case}", extra=extra))
    layer.start()
    try:
        base = f"http://127.0.0.1:{layer.port}"
        assert http("POST", f"{base}/model/rollback/1000")[0] == status
        if case == "no-registry":
            assert http("GET", f"{base}/model/generations")[0] == 404
    finally:
        layer.close()


# -- ModelStager: tests/chaos/test_restage_crash.py on both packages --------------


def make_generation_dir(model_dir: Path, gen: str = "100") -> str:
    d = model_dir / gen
    (d / "extra").mkdir(parents=True)
    (d / "extra" / "ids.txt").write_text("u1\nu2\n")
    (d / "model.pmml").write_text("<PMML>gen-%s</PMML>" % gen)
    return str(d)


def tree(root: Path) -> dict:
    return {
        p.relative_to(root).as_posix(): p.read_bytes()
        for p in sorted(root.rglob("*")) if p.is_file()
    }


def litter(root: Path) -> list[str]:
    return sorted(p.name.rsplit("-", 1)[0] for p in root.iterdir()
                  if p.name.startswith(".stage-"))


def test_stage_is_idempotent_and_matches_jax(tmp_path):
    ref = make_generation_dir(tmp_path / "models")
    staged = {}
    for pkg in PACKAGES:
        stager = PACKAGES[pkg]["restage"].ModelStager(tmp_path / f"cache-{pkg}")
        assert stager.stage(ref) == stager.staged_path("100")
        assert stager.stage(ref) == stager.staged_path("100")  # a hit
        assert stager.is_staged("100")
        assert stager.stage(str(tmp_path / "models" / "not-a-gen")) is None
        assert stager.stage(str(tmp_path / "models" / "999")) is None  # vanished
        staged[pkg] = tree(stager.root)
    assert staged["torch"] == staged["jax"]
    assert set(staged["torch"]) == {"100/model.pmml", "100/extra/ids.txt"}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_raise_mid_download_leaves_nothing(tmp_path, pkg):
    mods = PACKAGES[pkg]
    ref = make_generation_dir(tmp_path / "models")
    stager = mods["restage"].ModelStager(tmp_path / "cache")
    mods["crashpoints"].arm("serving.restage.mid", action="raise")
    try:
        with pytest.raises(mods["crashpoints"].CrashPointReached):
            stager.stage(ref)
    finally:
        mods["crashpoints"].reset()
    assert not stager.is_staged("100") and not stager.staged_path("100").exists()
    assert litter(stager.root) == []
    assert stager.stage(ref) == stager.staged_path("100")
    assert tree(stager.root) == {"100/extra/ids.txt": b"u1\nu2\n",
                                 "100/model.pmml": b"<PMML>gen-100</PMML>"}


def sigkilled_stage(pkg, cache: Path, ref: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["ORYX_CRASHPOINT"] = "serving.restage.mid:1"
    env["PYTHONPATH"] = str(REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    name = PACKAGES[pkg]["name"]
    return subprocess.run(
        [sys.executable, "-c",
         f"import sys; from {name}.serving.restage import ModelStager; "
         "ModelStager(sys.argv[1]).stage(sys.argv[2])", str(cache), ref],
        env=env, timeout=60, capture_output=True,
    )


def test_sigkill_mid_download_sweeps_alike(tmp_path):
    """The crash case of tests/chaos/test_restage_crash.py: a stager killed
    mid-download leaves only its hidden temp dir (side artifacts copied,
    model.pmml not), and either package's next stager sweeps it, whoever
    left it, then stages whole."""
    ref = make_generation_dir(tmp_path / "models")
    left = {}
    for pkg in PACKAGES:
        cache = tmp_path / f"cache-{pkg}"
        proc = sigkilled_stage(pkg, cache, ref)
        assert proc.returncode in KILLED, (pkg, proc.returncode, proc.stderr.decode())
        assert litter(cache) == [".stage-100"]
        (tmp,) = [p for p in cache.iterdir() if p.name.startswith(".stage-")]
        left[pkg] = tree(tmp)
        assert not (cache / "100").exists()
    assert left["torch"] == left["jax"] == {"extra/ids.txt": b"u1\nu2\n"}
    # each package's stager sweeps the other's litter
    for pkg, other in (("torch", "jax"), ("jax", "torch")):
        cache = tmp_path / f"cache-{other}"
        swept = tmetrics.registry.counter("serving.restage.swept").value
        stager = PACKAGES[pkg]["restage"].ModelStager(cache)
        assert stager.swept_on_open == 1 and litter(cache) == []
        if pkg == "torch":
            assert tmetrics.registry.counter("serving.restage.swept").value == swept + 1
        assert (stager.stage(ref) / "model.pmml").read_text() == "<PMML>gen-100</PMML>"


# -- MODEL-REF through the restage cache, in each package's layer ----------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_model_ref_is_staged_then_served(tmp_path, pkg):
    mods = PACKAGES[pkg]
    model_dir = tmp_path / pkg / "model"
    stage_dir = tmp_path / pkg / "stage"
    # a max message size below any PMML: publishes go out as MODEL-REF
    extra = f'update-topic.message.max-size = 16\nserving.restage-dir = "{stage_dir}"'
    broker_loc = f"inproc://restage-{pkg}"
    layer = mods["layer"](make_config(pkg, model_dir, broker_loc, extra=extra))
    layer.start()
    base = f"http://127.0.0.1:{layer.port}"
    try:
        assert mods["restage"].active() is layer.model_stager
        run_generation(pkg, model_dir, broker_loc, 1000, 0.9, extra)
        assert wait_for(lambda: probe_generation(base) == "1000")
        assert layer.health.live_generation == "1000"
        staged = tree(stage_dir / "1000")
        assert staged == tree(model_dir / "1000") and "model.pmml" in staged
        assert litter(stage_dir) == []
        status, body = http("POST", f"{base}/model/rollback/1000")
        assert status == 200 and json.loads(body)["published_as"] == "MODEL-REF"
    finally:
        layer.close()
    assert mods["restage"].active() is None  # the layer took its hook back
