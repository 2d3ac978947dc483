"""The k-means batch slice as a whole: the port's BatchLayer, MLUpdate,
registry and KMeansUpdate against the JAX package's, on the CPU.

- The k-means end-to-end steps of tests/app/kmeans/test_kmeans_e2e.py
  (ingest through /add, one batch generation, /assign) run on the port's
  BatchLayer and ServingLayer.
- One generation of each package on the same input, each after its own
  ``rng.use_test_seed()``: with ``init = "random"`` both draw the same
  seeds, so the published centers agree within 1e-5 and the counts are
  equal. A champion PMML from either package serves the same /assign
  answers from the other's manager.
- Registry store, gate and manifest cases run on both packages.
- Settings the port does not serve yet raise NotYetPortedError, and
  the port's CLI refuses config-named classes of the JAX package.
"""

import json
import math
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from oryx_tpu import bus as jbus
from oryx_tpu.app.kmeans import common as jcommon
from oryx_tpu.app.kmeans import serving as jserving
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import metrics as jmetrics
from oryx_tpu.common import pmml as jpmml
from oryx_tpu.common import rng as jrng
from oryx_tpu.lambda_.batch import BatchLayer as JaxBatchLayer
from oryx_tpu.registry import gate as jgate
from oryx_tpu.registry import manifest as jmanifest
from oryx_tpu.registry import store as jstore
from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch import bus as tbus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.kmeans import common as tcommon
from oryx_tpu_torch.app.kmeans import serving as tserving
from oryx_tpu_torch.app.kmeans.update import KMeansUpdate
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import metrics as tmetrics
from oryx_tpu_torch.common import pmml as tpmml
from oryx_tpu_torch.common import rng as trng
from oryx_tpu_torch.lambda_.batch import BatchLayer
from oryx_tpu_torch.registry import gate as tgate
from oryx_tpu_torch.registry import manifest as tmanifest
from oryx_tpu_torch.registry import store as tstore
from oryx_tpu_torch.serving.layer import ServingLayer

ROOT = Path(__file__).resolve().parent.parent

PACKAGES = {
    "jax": dict(
        name="oryx_tpu", config=jconfig, pmml=jpmml, bus=jbus, common=jcommon,
        serving=jserving, batch=JaxBatchLayer, rng=jrng,
        gate=jgate, manifest=jmanifest, store=jstore, metrics=jmetrics,
    ),
    "torch": dict(
        name="oryx_tpu_torch", config=tconfig, pmml=tpmml, bus=tbus, common=tcommon,
        serving=tserving, batch=BatchLayer, rng=trng,
        gate=tgate, manifest=tmanifest, store=tstore, metrics=tmetrics,
    ),
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    trng.use_test_seed()
    yield
    trng.clear_test_seed()
    port_device.set_device(None)
    InProcessBroker.reset_all()


def kmeans_config(pkg, tmp_path, broker_loc, extra=""):
    name = PACKAGES[pkg]["name"]
    return PACKAGES[pkg]["config"].get_default().with_overlay(
        f"""
        oryx {{
          id = "KMBatch"
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          input-schema {{
            num-features = 2
            numeric-features = ["0", "1"]
          }}
          kmeans.hyperparams.k = 3
          batch {{
            streaming.generation-interval-sec = 3600
            update-class = "{name}.app.kmeans.update:KMeansUpdate"
            storage {{ data-dir = "{tmp_path}/{pkg}/data/"
                      model-dir = "{tmp_path}/{pkg}/model/" }}
          }}
          serving {{
            api.port = 0
            model-manager-class = "{name}.app.kmeans.serving:KMeansServingModelManager"
            application-resources = "{name}.app.kmeans.serving"
          }}
          ml.eval {{ candidates = 1, test-fraction = 0 }}
          {extra}
        }}
        """
    )


def blob_lines(seed=4, per=40):
    gen = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 10.0]])
    lines = []
    for c in centers:
        for _ in range(per):
            p = c + 0.5 * gen.standard_normal(2)
            lines.append(f"{p[0]:.3f},{p[1]:.3f}")
    return lines


def http(method, url, body=None):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
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


def test_kmeans_batch_to_serving_pipeline(tmp_path):
    """tests/app/kmeans/test_kmeans_e2e.py steps 1-3 on the port."""
    cfg = kmeans_config("torch", tmp_path, "inproc://port-kmeans-e2e")
    batch = BatchLayer(cfg)
    batch.prepare()
    serving = ServingLayer(cfg)
    serving.start()
    base = f"http://127.0.0.1:{serving.port}"
    try:
        # 1. ingest three well-separated Gaussian blobs through /add
        status, _ = http("POST", f"{base}/add", "\n".join(blob_lines()).encode())
        assert status == 204

        # 2. batch trains and publishes the ClusteringModel PMML
        batch.run_one_generation(timestamp_ms=777)
        assert (tmp_path / "torch" / "model" / "777" / "model.pmml").exists()
        assert batch.generation_count == 1
        manifest = tstore.RegistryStore(str(tmp_path / "torch" / "model")).read_manifest("777")
        assert manifest.published and manifest.train_count == 120
        assert any(n.startswith("oryx-777.") for n in os.listdir(tmp_path / "torch" / "data"))

        # 3. serving loads the model and assigns correctly
        assert wait_for(lambda: http("GET", f"{base}/ready")[0] == 200)
        a0 = json.loads(http("GET", f"{base}/assign/0.1,0.2")[1])
        a1 = json.loads(http("GET", f"{base}/assign/9.8,10.1")[1])
        a2 = json.loads(http("GET", f"{base}/assign/-9.9,9.9")[1])
        assert len({a0, a1, a2}) == 3
        status, body = http("GET", f"{base}/distanceToNearest/0.1,0.2")
        assert status == 200 and json.loads(body) < 2.0
        status, body = http("POST", f"{base}/assign", b"0.1,0.2\n9.8,10.1\n")
        assert status == 200 and json.loads(body) == [a0, a1]
        assert http("GET", f"{base}/assign/0.1")[0] == 400
    finally:
        serving.close()
        batch.close()


def run_generation(pkg, tmp_path, lines, extra=""):
    """One generation of ``pkg``'s BatchLayer on ``lines``; returns the
    published clusters, read back with that package's own PMML reader."""
    p = PACKAGES[pkg]
    loc = f"inproc://parity-{pkg}"
    batch = p["batch"](kmeans_config(pkg, tmp_path, loc, extra))
    batch.prepare()
    try:
        with p["bus"].get_broker(loc).producer("OryxInput") as prod:
            for line in lines:
                prod.send(None, line)
        p["rng"].use_test_seed()  # just before: the seed sequences line up
        batch.run_one_generation(timestamp_ms=777)
    finally:
        batch.close()
    text = (tmp_path / pkg / "model" / "777" / "model.pmml").read_text()
    return p["common"].pmml_to_clusters(p["pmml"].from_string(text)), text


def test_one_generation_matches_the_jax_package(tmp_path):
    lines = blob_lines(seed=11, per=60)
    extra = 'kmeans.initialization-strategy = "random"'
    jc, _ = run_generation("jax", tmp_path, lines, extra)
    tc, _ = run_generation("torch", tmp_path, lines, extra)
    assert [c.id for c in tc] == [c.id for c in jc]
    assert [c.count for c in tc] == [c.count for c in jc]
    np.testing.assert_allclose(
        np.stack([c.center for c in tc]), np.stack([c.center for c in jc]), rtol=1e-5, atol=1e-5
    )


def test_champion_pmml_serves_the_same_assignments_in_both_packages(tmp_path):
    """The PMML is the interchange format: a champion written by either
    package loads in the other's KMeansServingModelManager and answers
    /assign alike."""
    lines = blob_lines(seed=12)
    _, jtext = run_generation("jax", tmp_path, lines)
    _, ttext = run_generation("torch", tmp_path, lines)
    probes = np.random.default_rng(0).uniform(-12, 12, size=(50, 2))
    for text in (jtext, ttext):
        answers = {}
        for pkg, p in PACKAGES.items():
            manager = p["serving"].KMeansServingModelManager(
                kmeans_config(pkg, tmp_path, f"inproc://serve-{pkg}")
            )
            manager.consume(iter([KeyMessage("MODEL", text)]))
            model = manager.get_model()
            answers[pkg] = [model.closest_cluster(q) for q in probes]
        assert [c.id for c, _ in answers["torch"]] == [c.id for c, _ in answers["jax"]]
        np.testing.assert_allclose(
            [d for _, d in answers["torch"]], [d for _, d in answers["jax"]], rtol=1e-12
        )


def test_second_generation_warm_starts_minibatch(tmp_path):
    cfg = kmeans_config(
        "torch", tmp_path, "inproc://port-warm", "ml.kmeans.minibatch-size = 50"
    )
    batch = BatchLayer(cfg)
    batch.prepare()
    try:
        lines = blob_lines(seed=5)
        with tbus.get_broker("inproc://port-warm").producer("OryxInput") as prod:
            for line in lines:
                prod.send(None, line)
        batch.run_one_generation(timestamp_ms=1000)
        with tbus.get_broker("inproc://port-warm").producer("OryxInput") as prod:
            for line in blob_lines(seed=6):
                prod.send(None, line)
        batch.run_one_generation(timestamp_ms=2000)
    finally:
        batch.close()
    update = batch._update
    assert update.previous_generation_id == "1000"
    store = tstore.RegistryStore(str(tmp_path / "torch" / "model"))
    assert store.champion_id() == "2000"
    assert store.read_manifest("2000").parent_id == "1000"
    clusters = tcommon.pmml_to_clusters(tpmml.from_string(store.read_pmml_text("2000")))
    assert sum(c.count for c in clusters) == 240  # past + new data
    centers = np.stack([c.center for c in clusters])
    for true in ([0.0, 0.0], [10.0, 10.0], [-10.0, 10.0]):
        assert np.min(np.linalg.norm(centers - true, axis=1)) < 0.5


# -- registry --------------------------------------------------------------------


def make_generation(store, gen_id, pmml_text="<PMML/>"):
    d = Path(store.generation_dir(gen_id))
    d.mkdir(parents=True, exist_ok=True)
    (d / "model.pmml").write_text(pmml_text)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_registry_manifest_round_trip_and_nan(tmp_path, pkg):
    st, mf = PACKAGES[pkg]["store"], PACKAGES[pkg]["manifest"]
    store = st.RegistryStore(str(tmp_path))
    make_generation(store, "1000")
    manifest = mf.GenerationManifest(
        generation_id="1000", parent_id="999", status=mf.STATUS_PUBLISHED,
        hyperparams=[4, 0.01], eval_metric=-1.25, train_count=80, test_count=20,
        wall_time_sec=1.5, content_hash=mf.content_hash_of(b"<PMML/>"), created_at_ms=1000,
    )
    store.write_manifest(manifest)
    assert store.read_manifest("1000") == manifest
    make_generation(store, "5")
    store.write_manifest(mf.GenerationManifest(generation_id="5", eval_metric=math.nan))
    assert json.loads((tmp_path / "5" / "manifest.json").read_text())["eval_metric"] is None
    (tmp_path / "1000" / "manifest.json").write_text("{not json")
    assert store.read_manifest("1000") is None


def test_registry_manifest_json_identical_in_both_packages():
    texts = {
        pkg: p["manifest"].GenerationManifest(
            generation_id="7", parent_id="6", hyperparams=[3], eval_metric=0.5,
            content_hash=p["manifest"].content_hash_of(b"x"),
        ).to_json()
        for pkg, p in PACKAGES.items()
    }
    assert texts["torch"] == texts["jax"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_registry_champion_listing_and_gc(tmp_path, pkg):
    st = PACKAGES[pkg]["store"]
    store = st.RegistryStore(str(tmp_path))
    assert store.champion_id() is None
    for gen in ("1", "2", "3", "4", "5"):
        make_generation(store, gen)
    (tmp_path / "scratch").mkdir()
    assert store.list_generations() == ["1", "2", "3", "4", "5"]
    store.set_champion("1", now_ms=111)
    assert json.loads((tmp_path / "CHAMPION").read_text()) == {
        "generation_id": "1", "updated_at_ms": 111,
    }
    assert store.gc(2, never_delete={"3"}) == ["2"]
    assert store.list_generations() == ["1", "3", "4", "5"]
    assert store.gc(-1) == []
    (tmp_path / "CHAMPION").write_text("garbage")
    assert store.champion_id() is None
    assert st.generation_id_from_ref("/data/model/12345/model.pmml") == "12345"


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_registry_fsck_repairs_half_written_generation(tmp_path, pkg):
    st = PACKAGES[pkg]["store"]
    store = st.RegistryStore(str(tmp_path))
    make_generation(store, "10")
    (tmp_path / "11").mkdir()  # promoted, never given its model.pmml
    store.set_champion("11")
    report = store.fsck(repair=True)
    assert report["generations-quarantined"] == 1 and report["champion-reset"] == 1
    assert store.champion_id() == "10"
    assert store.list_generations() == ["10"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_registry_publish_generation_inline_and_ref(tmp_path, pkg):
    p = PACKAGES[pkg]
    store = p["store"].RegistryStore(str(tmp_path))
    make_generation(store, "42", pmml_text="<PMML>inline</PMML>")
    broker = p["bus"].get_broker(f"inproc://registry-{pkg}")
    broker.create_topic("OryxUpdate", 1)
    tail = broker.consumer("OryxUpdate", from_beginning=True)
    with broker.producer("OryxUpdate") as producer:
        assert p["store"].publish_generation(store, "42", producer, 1024) == "MODEL"
        assert p["store"].publish_generation(store, "42", producer, 4) == "MODEL-REF"
        with pytest.raises(FileNotFoundError):
            p["store"].publish_generation(store, "404", producer, 1024)
    msgs = tail.poll(timeout=1.0)
    assert [(m.key, m.message) for m in msgs] == [
        ("MODEL", "<PMML>inline</PMML>"), ("MODEL-REF", store.generation_dir("42")),
    ]


def _store_with_champion(p, tmp_path, metric):
    store = p["store"].RegistryStore(str(tmp_path))
    make_generation(store, "1000")
    manifest = p["manifest"].GenerationManifest(generation_id="1000", eval_metric=metric)
    store.write_manifest(manifest)
    store.set_champion("1000")
    return store


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_gate_permissive_on_missing_evidence(tmp_path, pkg):
    p = PACKAGES[pkg]
    assert not p["gate"].ChampionGate(p["config"].get_default()).enabled
    gate = p["gate"].ChampionGate(
        p["config"].get_default().with_overlay("oryx.ml.gate.max-regression = 0.05")
    )
    assert gate.decide(p["store"].RegistryStore(str(tmp_path / "empty")), 0.5).publish
    assert gate.decide(_store_with_champion(p, tmp_path, None), 0.5).publish
    store = _store_with_champion(p, tmp_path, 0.9)
    assert gate.decide(store, math.nan).publish
    assert gate.decide(store, None).publish


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_gate_regression_beyond_tolerance(tmp_path, pkg):
    p = PACKAGES[pkg]
    gate = p["gate"].ChampionGate(
        p["config"].get_default().with_overlay("oryx.ml.gate.max-regression = 0.05")
    )
    store = _store_with_champion(p, tmp_path, 0.90)
    gated = p["metrics"].registry.counter(p["gate"].GATED_COUNTER)
    before = gated.value
    decision = gate.decide(store, 0.80)
    assert not decision.publish and decision.champion_id == "1000"
    assert "max-regression" in decision.reason
    assert gated.value == before + 1
    assert gate.decide(store, 0.86).publish and gate.decide(store, 0.95).publish


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_online_gate_decisions(pkg):
    p = PACKAGES[pkg]
    gate = p["gate"].ChampionGate(
        p["config"].get_default().with_overlay(
            "oryx.ml.gate.online { enabled = true, min-samples = 10 }"
        )
    )
    assert gate.decide_online(5, 5, 0.5, 0.6, 3, 1).verdict == "continue"
    assert gate.decide_online(100, 100, 0.4, 0.6, 40, 5).verdict == "promote"
    assert gate.decide_online(100, 100, 0.6, 0.4, 5, 40).verdict == "refuse"
    assert p["gate"].sign_test_confidence(0, 0) == 0.0


# -- what the port refuses ---------------------------------------------------------


def _write_conf(tmp_path, update_class):
    conf = tmp_path / "batch.conf"
    conf.write_text(
        f"""
        oryx {{
          input-topic.broker = "inproc://cli"
          update-topic.broker = "inproc://cli"
          batch.update-class = "{update_class}"
          batch.storage {{ data-dir = "{tmp_path}/data/", model-dir = "{tmp_path}/model/" }}
        }}
        """
    )
    return conf


def test_cli_batch_refuses_jax_package_classes(tmp_path):
    conf = _write_conf(tmp_path, "oryx_tpu.app.kmeans.update:KMeansUpdate")
    env = {k: v for k, v in os.environ.items() if k != "ORYX_CONF"}
    out = subprocess.run(
        [sys.executable, "-m", "oryx_tpu_torch", "batch", "--conf", str(conf)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "names the JAX package" in out.stderr
    assert "oryx_tpu_torch.app.kmeans.update:KMeansUpdate" in out.stderr


@pytest.mark.parametrize(
    "extra",
    [
        'batch.compute.distributed.coordinator-address = "localhost:1234"',
        "batch.compute.distributed.auto = true",
        'compute.compile-cache-dir = "/nonexistent/cache"',
    ],
)
def test_unported_compute_settings_raise(tmp_path, extra):
    with pytest.raises(NotYetPortedError):
        BatchLayer(kmeans_config("torch", tmp_path, "inproc://refuse", extra))


def test_distributed_environment_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("ORYX_COORDINATOR", "localhost:1234")
    with pytest.raises(NotYetPortedError, match="ORYX_COORDINATOR"):
        BatchLayer(kmeans_config("torch", tmp_path, "inproc://refuse"))


def test_mesh_raises(tmp_path):
    cfg = kmeans_config("torch", tmp_path, "inproc://refuse", "batch.compute.mesh { data = 1 }")
    with pytest.raises(NotYetPortedError, match="mesh"):
        KMeansUpdate(cfg)


def test_profile_dir_traces_on_both_packages(tmp_path):
    """``batch.compute.profile-dir``, once refused, traces a generation on
    both packages: each writes one ``batch-generation-<ms>`` directory (the
    port's a torch.profiler Chrome trace, the JAX package's an xprof one),
    and the published model is the one an untraced generation gives."""
    def model(text):  # the PMML less its header's timestamp
        return re.sub(r"<Timestamp>[^<]*</Timestamp>", "", text)

    lines = blob_lines()
    plain = model(run_generation("torch", tmp_path / "plain", lines)[1])
    for pkg in PACKAGES:
        extra = f'batch.compute.profile-dir = "{tmp_path}/prof-{pkg}"'
        text = run_generation(pkg, tmp_path, lines, extra)[1]
        (target,) = os.listdir(tmp_path / f"prof-{pkg}")
        assert target.startswith("batch-generation-")
        assert any(files for _, _, files in os.walk(tmp_path / f"prof-{pkg}" / target))
        if pkg == "torch":
            assert model(text) == plain
            doc = json.loads((tmp_path / "prof-torch" / target / "trace.json").read_text())
            cats = {e.get("cat") for e in doc["traceEvents"]}
            assert "cpu_op" in cats  # the generation's own torch ops
            assert any(e.get("name") == "batch-generation" for e in doc["traceEvents"])
