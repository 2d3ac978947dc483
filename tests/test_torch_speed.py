"""The port's speed layer (oryx_tpu_torch.lambda_.speed, .pipeline,
app/kmeans/speed.py) against the JAX package's, on the CPU.

Counterparts of tests/lambda_/test_speed_layer.py, the pipeline cases of
tests/lambda_/test_speed_pipeline.py that need no ALS speed manager and
no shm or fault bus, and
tests/app/kmeans/test_kmeans.py::test_speed_manager_drift_and_updates;
the port's k-means speed manager and the JAX package's emit identical UP
messages on the same model and the same seeded points (both fold in
float64 numpy); and the k-means lambda loop on a file: bus, in one
process and as three CLI processes.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from oryx_tpu.app.kmeans.speed import KMeansSpeedModelManager as JaxKMeansSpeedManager
from oryx_tpu.bus.core import KeyMessage as JaxKeyMessage
from oryx_tpu.common import config as jconfig
from oryx_tpu.lambda_.speed import SpeedLayer as JaxSpeedLayer
from oryx_tpu_torch import bus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.kmeans import common as km
from oryx_tpu_torch.app.kmeans.speed import KMeansSpeedModelManager
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as C
from oryx_tpu_torch.common import metrics, tracing
from oryx_tpu_torch.common import pmml as pmml_io
from oryx_tpu_torch.lambda_.pipeline import HandoffQueue
from oryx_tpu_torch.lambda_.speed import SpeedLayer


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


def wait_until(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def kmeans_config(broker, extra="", pkg="oryx_tpu_torch", interval=3600, conf=C):
    return conf.get_default().with_overlay(
        f"""
        oryx {{
          id = "SpeedIT"
          input-topic.broker = "{broker}"
          update-topic.broker = "{broker}"
          input-schema {{ num-features = 2, numeric-features = ["0", "1"] }}
          speed {{
            streaming.generation-interval-sec = {interval}
            model-manager-class = "{pkg}.app.kmeans.speed:KMeansSpeedModelManager"
            {extra}
          }}
        }}
        """
    )


CLUSTERS = [(0, [0.0, 0.0], 4), (1, [10.0, 10.0], 4), (2, [-10.0, 10.0], 7)]


def model_message(cfg) -> str:
    clusters = [km.ClusterInfo(i, np.array(c), n) for i, c, n in CLUSTERS]
    return pmml_io.to_string(km.clusters_to_pmml(clusters, InputSchema(cfg)))


def seeded_lines(n, seed):
    gen = np.random.default_rng(seed)
    centers = np.array([c for _, c, _ in CLUSTERS])
    pts = centers[gen.integers(0, len(centers), n)] + gen.standard_normal((n, 2))
    return [f"{x:.6f},{y:.6f}" for x, y in pts]


def ups_of(records):
    return [m.message for m in records if m.key != tracing.TRACE_KEY]


# -- tests/lambda_/test_speed_layer.py ----------------------------------------------


def test_speed_layer_consumes_model_and_emits_updates():
    """Seed the update topic with a model, then input: the UP deltas are
    the JAX package's speed layer's, message for message."""
    lines = seeded_lines(50, 1)
    got = {}
    for name, layer_cls, conf, pkg in (
        ("port", SpeedLayer, C, "oryx_tpu_torch"),
        ("jax", JaxSpeedLayer, jconfig, "oryx_tpu"),
    ):
        from oryx_tpu import bus as jax_bus

        loc = f"inproc://speed-it-{name}"
        broker = (bus if name == "port" else jax_bus).get_broker(loc)
        cfg = kmeans_config(loc, pkg=pkg, conf=conf)
        layer = layer_cls(cfg)
        layer.init_topics()
        with broker.producer("OryxUpdate") as p:
            p.send("MODEL", model_message(kmeans_config(loc)))
        layer.start()
        try:
            assert wait_until(lambda: layer.manager.model is not None)
            with broker.producer("OryxInput") as p:
                p.send_many((None, line) for line in lines)
            tail = broker.consumer("OryxUpdate")  # latest: skip the seeded model
            sent = layer.run_one_batch()
            got[name] = ups_of(tail.poll(max_records=100, timeout=2.0))
            assert sent == len(got[name]) == 3
        finally:
            layer.close()
    assert got["port"] == got["jax"]


def test_speed_layer_background_microbatches():
    loc = "inproc://speed-it2"
    broker = bus.get_broker(loc)
    cfg = kmeans_config(loc, interval=1)
    layer = SpeedLayer(cfg)
    layer.init_topics()
    with broker.producer("OryxUpdate") as p:
        p.send("MODEL", model_message(cfg))
    layer.start()
    try:
        assert wait_until(lambda: layer.manager.model is not None)
        with broker.producer("OryxInput") as p:
            p.send(None, "1.0,1.0")
        assert wait_until(
            lambda: layer.batch_count >= 1 and layer.manager.model.get_cluster(0).count == 5
        )
        np.testing.assert_allclose(layer.manager.model.get_cluster(0).center, [0.2, 0.2])
    finally:
        layer.close()


def test_layer_ui_port_serves_metrics():
    cfg = kmeans_config("inproc://ui-test", extra="ui.port = 0")
    layer = SpeedLayer(cfg)
    layer.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{layer.ui_port}/metrics", timeout=5) as r:
            body = json.loads(r.read())
        assert body["layer"]["name"] == "speed"
        assert body["layer"]["stopped"] is False
    finally:
        layer.close()


def test_speed_batch_continues_input_trace_and_feeds_freshness():
    loc = "inproc://speed-trace"
    broker = bus.get_broker(loc)
    cfg = kmeans_config(loc)
    layer = SpeedLayer(cfg)
    layer.init_topics()
    tracing.reset()
    tracing.configure(sample_rate=1.0)
    try:
        with broker.producer("OryxUpdate") as p:
            p.send("MODEL", model_message(cfg))
        layer.start()
        assert wait_until(lambda: layer.manager.model is not None)
        ctx = tracing.TraceContext("ab" * 16, "cd" * 8, True)
        origin_ms = int(time.time() * 1000) - 3000  # ingested 3 s ago
        records, extra = tracing.with_header([(None, "0.5,0.5"), (None, "9,9")], ctx, origin_ms)
        assert extra == 1
        with broker.producer("OryxInput") as p:
            p.send_many(records)
        tail = broker.consumer("OryxUpdate")
        fresh = metrics.registry.histogram("speed.freshness.seconds")
        fresh0 = fresh.count
        assert layer.run_one_batch() == 2
        block = tail.poll_block(max_records=10, timeout=2.0)
        assert len(block) == 2
        info = tracing.parse_header(block.trace)
        assert info is not None and info.ingest_ms == origin_ms
        assert info.ctx is not None and info.ctx.trace_id == ctx.trace_id
        names = {s["name"] for s in tracing.spans(ctx.trace_id)}
        assert {"speed.parse", "speed.fold", "speed.publish", "speed.batch"} <= names
        (batch_span,) = [s for s in tracing.spans(ctx.trace_id) if s["name"] == "speed.batch"]
        assert batch_span["parent"] == ctx.span_id
        assert batch_span["attrs"] == {"events": 2, "updates": 2}
        assert fresh.count > fresh0
        assert fresh.snapshot()["max"] >= 2.0
    finally:
        tracing.reset()
        layer.close()


# -- the port's refusals ---------------------------------------------------------------


@pytest.mark.parametrize("extra,error,match", [
    ('model-manager-class = "oryx_tpu.app.kmeans.speed:KMeansSpeedModelManager"', ValueError,
     "oryx_tpu_torch"),
])
def test_speed_layer_refuses_what_is_not_ported(extra, error, match):
    with pytest.raises(error, match=match):
        SpeedLayer(kmeans_config("inproc://refused", extra=extra))


def test_speed_layer_traces_with_profile_dir(tmp_path):
    """``speed.compute.profile-dir``, once refused, starts on both
    packages: a micro-batch writes one ``speed-batch-<ms>`` trace
    directory and emits the JAX package's UP deltas."""
    from oryx_tpu import bus as jax_bus

    lines = seeded_lines(50, 1)
    got = {}
    for name, layer_cls, conf, pkg in (
        ("port", SpeedLayer, C, "oryx_tpu_torch"),
        ("jax", JaxSpeedLayer, jconfig, "oryx_tpu"),
    ):
        loc = f"inproc://speed-prof-{name}"
        broker = (bus if name == "port" else jax_bus).get_broker(loc)
        extra = f'compute.profile-dir = "{tmp_path}/{name}"'
        layer = layer_cls(kmeans_config(loc, extra=extra, pkg=pkg, conf=conf))
        layer.init_topics()
        with broker.producer("OryxUpdate") as p:
            p.send("MODEL", model_message(kmeans_config(loc)))
        layer.start()
        try:
            assert wait_until(lambda: layer.manager.model is not None)
            with broker.producer("OryxInput") as p:
                p.send_many((None, line) for line in lines)
            tail = broker.consumer("OryxUpdate")  # latest: skip the seeded model
            assert layer.run_one_batch() == 3
            got[name] = ups_of(tail.poll(max_records=100, timeout=2.0))
        finally:
            layer.close()
        (target,) = (tmp_path / name).iterdir()
        assert target.name.startswith("speed-batch-")
    assert got["port"] == got["jax"]
    trace = json.loads((next((tmp_path / "port").iterdir()) / "trace.json").read_text())
    assert any(e.get("name") == "speed-batch" for e in trace["traceEvents"])


def test_als_speed_layer_constructs():
    """The ALS speed manager is ported: a speed layer that names it starts
    and folds nothing until a model arrives."""
    from oryx_tpu_torch.app.als.speed import ALSSpeedModelManager

    layer = SpeedLayer(kmeans_config(
        "inproc://als-speed",
        extra='model-manager-class = "oryx_tpu_torch.app.als.speed:ALSSpeedModelManager"',
    ))
    try:
        assert isinstance(layer.manager, ALSSpeedModelManager)
        assert layer.manager.model is None
        assert list(layer.manager.build_updates([KeyMessage(None, "u1,i1,1.0,1")])) == []
    finally:
        layer.close()


def test_cli_speed_command():
    from oryx_tpu_torch import cli

    args = cli._build_parser().parse_args(["speed", "--conf", "x.conf", "--device", "cpu"])
    assert args.command == "speed" and args.device == "cpu"
    assert cli._build_parser().parse_args(["batch"]).device == "cuda"
    assert set(cli.COMMANDS) == {"batch", "speed", "serving", "bus-setup", "bus-serve",
                                 "bus-tail", "bus-input", "trace", "config", "health",
                                 "models", "experiments", "lint", "repair", "tenants"}


def test_packaged_default_buses_are_the_file_bus(monkeypatch):
    """The three layers' packaged brokers are file: buses, which the port
    now resolves (it used to raise for them)."""
    from oryx_tpu_torch.bus import filebus

    made = []
    monkeypatch.setattr(filebus, "FileBroker", lambda path: made.append(path) or path)
    cfg = C.get_default()
    for key in ("oryx.input-topic.broker", "oryx.update-topic.broker"):
        loc = cfg.get_string(key)
        assert loc.startswith("file:")
        assert bus.get_broker(loc) == loc[len("file:"):]
    assert len(made) == 2


# -- tests/lambda_/test_speed_pipeline.py ---------------------------------------------


def test_handoff_queue_bounded_put_blocks_until_get():
    q = HandoffQueue(1)
    assert q.put("a")
    done = []
    t = threading.Thread(target=lambda: done.append(q.put("b")))
    t.start()
    time.sleep(0.1)
    assert not done
    assert q.get() == "a"
    t.join(timeout=5)
    assert done == [True]
    assert q.get() == "b"


def test_handoff_queue_get_times_out_empty():
    q = HandoffQueue(2)
    t0 = time.monotonic()
    assert q.get(timeout=0.05) is None
    assert time.monotonic() - t0 >= 0.04


def test_handoff_queue_unget_returns_to_head():
    q = HandoffQueue(2)
    q.put("a")
    q.put("b")
    q.unget(q.get())
    assert q.get() == "a"
    assert q.get() == "b"


def test_handoff_queue_put_aborts_on_stop():
    q = HandoffQueue(1)
    q.put("a")
    stop = threading.Event()
    stop.set()
    assert q.put("b", stop) is False


def pipeline_config(loc, extra=""):
    return kmeans_config(
        loc, extra=f"pipeline.enabled = true\npipeline.min-batch-ms = 50\n{extra}", interval=1
    )


@pytest.fixture(params=["inproc", "file"])
def pipe_bus(request, tmp_path):
    return "inproc://pipe-it" if request.param == "inproc" else f"file:{tmp_path}/bus"


def test_pipeline_end_to_end_kmeans_manager(pipe_bus):
    """The pipeline publishes the updates the monolithic path would, and
    commits the input offsets once they are on the bus."""
    broker = bus.get_broker(pipe_bus)
    cfg = pipeline_config(pipe_bus)
    layer = SpeedLayer(cfg)
    assert layer.pipeline_enabled
    layer.init_topics()
    with broker.producer("OryxUpdate") as p:
        p.send("MODEL", model_message(cfg))
    tail = broker.consumer("OryxUpdate")
    layer.start()
    try:
        assert layer._pipeline is not None and layer._batch_thread is None
        assert wait_until(lambda: layer.manager.model is not None)
        with broker.producer("OryxInput") as p:
            p.send(None, "1.0,1.0")
        assert wait_until(lambda: layer.batch_count >= 1)
        ups = ups_of(tail.poll(timeout=2.0))
        assert [json.loads(u)[0] for u in ups] == [0] and json.loads(ups[0])[2] == 5
        assert wait_until(
            lambda: sum(broker.get_offsets(layer.group_id, "OryxInput").values()) >= 1
        )
    finally:
        layer.close()


class _Exploding:
    def __init__(self, fails=None):
        self.calls = []
        self.fails = fails  # None: always

    def consume(self, it):
        for _ in it:
            pass

    def consume_blocks(self, it):
        for _ in it:
            pass

    def build_updates(self, new_data):
        self.calls.append(1)
        if self.fails is None or len(self.calls) <= self.fails:
            raise RuntimeError("boom")
        return [f"{km_.message},1" for km_ in new_data]

    def close(self):
        pass


def test_pipeline_fold_failure_retries_then_drops():
    loc = "inproc://pipe-fail"
    broker = bus.get_broker(loc)
    layer = SpeedLayer(pipeline_config(loc))
    layer.manager = _Exploding()
    layer.init_topics()
    dropped0 = metrics.registry.counter("speed.pipeline.fold-dropped").value
    layer.start()
    try:
        with broker.producer("OryxInput") as p:
            p.send(None, "1,2")
        assert wait_until(
            lambda: metrics.registry.counter("speed.pipeline.fold-dropped").value >= dropped0 + 1
        )
        assert len(layer.manager.calls) == 3  # the try and two retries, then dropped
        assert layer.batch_count == 0
        assert all(t.is_alive() for t in layer._pipeline.threads)
    finally:
        layer.close()


def test_sharded_pipeline_fold_failure_restarts_without_lost_offsets(pipe_bus):
    """A shard's fold dying once is retried in order, and its offsets are
    committed once the retried fold publishes; every partition is
    committed to the end and every event is published once."""
    broker = bus.get_broker(pipe_bus)
    layer = SpeedLayer(pipeline_config(pipe_bus, "pipeline.shards = 2"))
    layer.manager = _Exploding(fails=1)
    layer.init_topics()
    tail = broker.consumer("OryxUpdate")
    retries0 = metrics.registry.counter("speed.pipeline.fold-retries").value
    layer.start()
    try:
        assert layer._pipeline.shards == 2
        with broker.producer("OryxInput") as p:
            for j in range(8):
                p.send(f"k{j}", f"e{j}")
        latest = broker.latest_offsets("OryxInput")
        assert len(latest) == layer.input_partitions > 2 and sum(latest.values()) == 8
        assert wait_until(
            lambda: broker.get_offsets(layer.group_id, "OryxInput") == latest, timeout=30.0
        )
        assert metrics.registry.counter("speed.pipeline.fold-retries").value > retries0
        assert all(t.is_alive() for t in layer._pipeline.threads)
        ups = []
        assert wait_until(lambda: ups.extend(ups_of(tail.poll(timeout=0.2))) or len(ups) >= 8)
        assert sorted(ups) == sorted(f"e{j},1" for j in range(8))
    finally:
        layer.close()


# -- tests/app/kmeans/test_kmeans.py::test_speed_manager_drift_and_updates ----------------


def two_clusters_config():
    return C.get_default().with_overlay(
        'oryx.input-schema { num-features = 2, numeric-features = ["0", "1"] }'
    )


def test_speed_manager_drift_and_updates():
    cfg = two_clusters_config()
    mgr = KMeansSpeedModelManager(cfg)
    clusters = [
        km.ClusterInfo(0, np.array([0.0, 0.0]), 4),
        km.ClusterInfo(1, np.array([10.0, 10.0]), 4),
    ]
    model_msg = pmml_io.to_string(km.clusters_to_pmml(clusters, InputSchema(cfg)))
    mgr.consume(iter([KeyMessage("MODEL", model_msg)]))
    ups = list(mgr.build_updates([
        KeyMessage(None, "1.0,1.0"),
        KeyMessage(None, "1.0,0.0"),
        KeyMessage(None, "9.0,11.0"),
    ]))
    assert len(ups) == 2
    by_id = {json.loads(u)[0]: json.loads(u) for u in ups}
    np.testing.assert_allclose(by_id[0][1], [2 / 6, 1 / 6], atol=1e-9)
    assert by_id[0][2] == 6
    np.testing.assert_allclose(by_id[1][1], [(40 + 9) / 5, (40 + 11) / 5])
    # its own UPs set clusters when replayed; a bad line is skipped
    mgr.consume(iter([KeyMessage("UP", json.dumps([1, [5.0, 5.0], 9]))]))
    assert mgr.model.get_cluster(1).count == 9
    assert list(mgr.build_updates([KeyMessage(None, "not,a,point")])) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speed_manager_updates_equal_jax(seed):
    """Both managers on the same MODEL and the same seeded micro-batches
    (and their own UPs replayed between them) emit identical UPs."""
    cfg = kmeans_config("inproc://unused")
    jcfg = kmeans_config("inproc://unused", pkg="oryx_tpu", conf=jconfig)
    port, ref = KMeansSpeedModelManager(cfg), JaxKMeansSpeedManager(jcfg)
    msg = model_message(cfg)
    port.consume(iter([KeyMessage("MODEL", msg)]))
    ref.consume(iter([JaxKeyMessage("MODEL", msg)]))
    for batch in range(3):
        lines = seeded_lines(200, seed * 10 + batch) + ["garbage"]
        got = list(port.build_updates([KeyMessage(None, line) for line in lines]))
        want = list(ref.build_updates([JaxKeyMessage(None, line) for line in lines]))
        assert got == want and got
        port.consume(iter([KeyMessage("UP", u) for u in got]))
        ref.consume(iter([JaxKeyMessage("UP", u) for u in want]))


# -- the k-means lambda loop on a file: bus ---------------------------------------


def http(method, url, body=None):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def served_count(serving, cid):
    return {c.id: c.count for c in serving.model_manager.get_model().clusters()}[cid]


def test_kmeans_three_layers_on_a_file_bus(tmp_path):
    """tests/app/kmeans/test_kmeans_e2e.py at 2 features, k = 3, on a
    file: bus; then the speed layer is closed and a new one resumes from
    its committed offsets and replays the update topic: counts grow by
    exactly the points posted."""
    from oryx_tpu_torch.lambda_.batch import BatchLayer
    from oryx_tpu_torch.serving.layer import ServingLayer

    loc = f"file:{tmp_path}/bus"
    cfg = C.get_default().with_overlay(
        f"""
        oryx {{
          id = "KME2E"
          input-topic.broker = "{loc}"
          update-topic.broker = "{loc}"
          input-schema {{ num-features = 2, numeric-features = ["0", "1"] }}
          kmeans.hyperparams.k = 3
          batch {{
            streaming.generation-interval-sec = 3600
            update-class = "oryx_tpu_torch.app.kmeans.update:KMeansUpdate"
            storage {{ data-dir = "{tmp_path}/data/", model-dir = "{tmp_path}/model/" }}
          }}
          speed {{
            streaming.generation-interval-sec = 3600
            model-manager-class = "oryx_tpu_torch.app.kmeans.speed:KMeansSpeedModelManager"
          }}
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.kmeans.serving:KMeansServingModelManager"
            application-resources = "oryx_tpu_torch.app.kmeans.serving"
          }}
          ml.eval {{ candidates = 1, test-fraction = 0 }}
        }}
        """
    )
    batch = BatchLayer(cfg)
    batch.prepare()
    speed = SpeedLayer(cfg)
    speed.start()
    serving = ServingLayer(cfg)
    serving.start()
    base = f"http://127.0.0.1:{serving.port}"
    try:
        gen = np.random.default_rng(4)
        centers = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 10.0]])
        lines = [
            f"{p[0]:.3f},{p[1]:.3f}"
            for c in centers for p in c + 0.5 * gen.standard_normal((40, 2))
        ]
        assert http("POST", f"{base}/add", "\n".join(lines).encode())[0] == 204
        assert speed.run_one_batch() == 0  # no model yet: the speed layer lets them pass
        batch.run_one_generation(timestamp_ms=777)
        assert (tmp_path / "model" / "777" / "model.pmml").exists()
        assert wait_until(lambda: http("GET", f"{base}/ready")[0] == 200)
        a0 = json.loads(http("GET", f"{base}/assign/0.1,0.2")[1])
        a1 = json.loads(http("GET", f"{base}/assign/9.8,10.1")[1])
        a2 = json.loads(http("GET", f"{base}/assign/-9.9,9.9")[1])
        assert len({json.dumps(a0), json.dumps(a1), json.dumps(a2)}) == 3
        assert wait_until(lambda: speed.manager.model is not None)
        counts0 = {c.id: c.count for c in speed.manager.model.clusters()}

        far = "\n".join("0.4,0.4" for _ in range(30))
        assert http("POST", f"{base}/add", far.encode())[0] == 204
        assert speed.run_one_batch() > 0
        assert wait_until(
            lambda: json.loads(http("GET", f"{base}/assign/0.3,0.3")[1]) == a0
            and served_count(serving, int(a0)) == counts0[int(a0)] + 30
        )
        speed.close()

        # a new speed layer: resumes after the 30 points, replays the UPs
        speed = SpeedLayer(cfg)
        speed.start()
        assert wait_until(
            lambda: speed.manager.model is not None
            and speed.manager.model.get_cluster(int(a0)).count == counts0[int(a0)] + 30
        )
        more = "\n".join("0.2,0.2" for _ in range(10))
        assert http("POST", f"{base}/add", more.encode())[0] == 204
        assert speed.run_one_batch() == 1
        assert speed.manager.model.get_cluster(int(a0)).count == counts0[int(a0)] + 40
        assert wait_until(lambda: served_count(serving, int(a0)) == counts0[int(a0)] + 40)
    finally:
        serving.close()
        speed.close()
        batch.close()


def test_kmeans_lambda_as_three_processes_on_the_cpu():
    """chip_smoke's kmeans-lambda phase at a small size, its three layers
    started as ``python -m oryx_tpu_torch ... --device cpu``: every check
    of the phase holds; on the CPU the batch process runs the sweep's
    plain version, which counts no launch."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    out = chip_smoke.phase_kmeans_lambda(7, scale=0.01, device="cpu", batch_interval=8)
    assert out["batch_launches"] == {"kmeans_sweep.tc": 0}
    assert out["wave2_folded"] and out["wave3_folded"]
    assert out["batch_generation_s"]["count"] == 1
