"""The port's buses under chaos, on the CPU.

The port's counterpart of tests/lambda_/test_resilience_e2e.py (a poison
update dead-lettered, the wordcount pipeline converging under seeded
drop and delay, /readyz across an outage; the netbus case is in
test_torch_netbus.py), of tests/bus/test_trace_propagation.py (the
``@trc`` header over every transport and under chaos) and of
tests/bus/test_kafkabus.py (which skips without kafka-python); the
torn-write injectors of ``common/corruption.py`` against the JAX
package's, byte for byte; and the layers' repairs under a ``fault+``
bus: a generation or a speed micro-batch drains its input to the end
past polls lost in flight, a generation that fails is drained again,
where the JAX package's loses its records, and ALS publishes every row
under the publish retry.
"""

import json
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from oryx_tpu_torch import bus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus import faultbus
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as C
from oryx_tpu_torch.common import corruption, metrics, tracing
from oryx_tpu_torch.common.tracing import TraceContext

CTX = TraceContext("ab" * 16, "cd" * 8, True)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    faultbus.reset()
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    faultbus.reset()


def wait_until(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _modules(pkg):
    """(bus, SpeedLayer, ServingLayer, config, faultbus, class prefix) of a package."""
    if pkg == "jax":
        from oryx_tpu import bus as bus_mod
        from oryx_tpu.bus import faultbus as fb
        from oryx_tpu.common import config as cfg
        from oryx_tpu.lambda_.speed import SpeedLayer
        from oryx_tpu.serving.layer import ServingLayer
        return bus_mod, SpeedLayer, ServingLayer, cfg, fb, "oryx_tpu"
    from oryx_tpu_torch.lambda_.speed import SpeedLayer
    from oryx_tpu_torch.serving.layer import ServingLayer
    return bus, SpeedLayer, ServingLayer, C, faultbus, "oryx_tpu_torch"


def speed_config(broker_loc, pkg="port", extra=""):
    cfg, prefix = _modules(pkg)[3], _modules(pkg)[5]
    return cfg.get_default().with_overlay(
        f"""
        oryx {{
          id = "ResilienceIT"
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          speed {{
            streaming.generation-interval-sec = 3600
            model-manager-class = "{prefix}.example.speed:ExampleSpeedModelManager"
            retry {{
              max-attempts = 50
              initial-backoff-ms = 5
              max-backoff-ms = 20
              jitter = 0
            }}
          }}
          {extra}
        }}
        """
    )


def serving_config(broker_loc, pkg="port"):
    cfg, prefix = _modules(pkg)[3], _modules(pkg)[5]
    return cfg.get_default().with_overlay(
        f"""
        oryx {{
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          serving {{
            model-manager-class = "{prefix}.example.serving:ExampleServingModelManager"
            application-resources = "{prefix}.example.serving"
            api.port = 0
            retry {{
              max-attempts = 1000
              initial-backoff-ms = 10
              max-backoff-ms = 50
              jitter = 0
            }}
          }}
        }}
        """
    )


# -- tests/lambda_/test_resilience_e2e.py ----------------------------------------


def test_poison_update_lands_in_dead_letter_topic():
    from oryx_tpu_torch.lambda_.speed import SpeedLayer

    broker_loc = "inproc://dlq-it"
    broker = bus.get_broker(broker_loc)
    layer = SpeedLayer(speed_config(broker_loc))
    layer.init_topics()
    with broker.producer("OryxUpdate") as p:
        p.send("POISON", "unparseable")
    layer.start()
    try:
        assert layer.dead_letter_topic == "OryxUpdate.dead-letter"
        assert wait_until(lambda: broker.topic_exists("OryxUpdate.dead-letter"))
        dl = broker.consumer("OryxUpdate.dead-letter", from_beginning=True)
        got = []
        assert wait_until(lambda: got.extend(dl.poll(timeout=0.05)) or got)
        assert (got[0].key, got[0].message) == ("POISON", "unparseable")
        dl.close()
        with broker.producer("OryxUpdate") as p:
            p.send("MODEL", json.dumps({"a": 7}))
        assert wait_until(lambda: layer.manager._counts.get("a") == 7)
        assert layer.healthy()
    finally:
        layer.close()


# disjoint word sets per line: the final counts are batching-independent
LINES = [f"w{3 * i} w{3 * i + 1} w{3 * i + 2}" for i in range(40)]
EXPECTED = {f"w{j}": 2 for j in range(120)}


def _run_pipeline(pkg, locator):
    """Speed + serving of package ``pkg`` over ``locator``, one send per
    input line (each a fault roll, retried as a client would). Returns the
    serving layer's converged model counts."""
    bus_mod, speed_cls, serving_cls, _, _, _ = _modules(pkg)
    speed = speed_cls(speed_config(locator, pkg))
    speed.init_topics()
    serving = serving_cls(serving_config(locator, pkg))
    speed.start()
    serving.start()
    try:
        with bus_mod.get_broker(locator).producer("OryxInput") as p:
            for line in LINES:
                deadline = time.monotonic() + 10
                while True:
                    try:
                        p.send(None, line)
                        break
                    except ConnectionError:
                        if time.monotonic() >= deadline:
                            raise

        def all_folded():
            try:
                speed.run_one_batch()
            except Exception:
                pass
            return speed.manager._counts == EXPECTED

        assert wait_until(all_folded, timeout=30.0), speed.manager._counts

        def serving_converged():
            model = serving.model_manager.get_model()
            return model is not None and model.get_words() == EXPECTED

        assert wait_until(serving_converged, timeout=30.0)
        return serving.model_manager.get_model().get_words()
    finally:
        speed.close()
        serving.close()
        assert speed.healthy()
        assert not speed._consume_thread.is_alive()
        assert not speed._batch_thread.is_alive()
        assert not serving._consume_thread.is_alive()


def test_wordcount_pipeline_converges_under_seeded_drop_and_delay():
    """The fault-free run, the run under drop=0.1&delay_ms=20&seed=5 and the
    JAX package's run under the same locator reach the same model."""
    chaos_loc = "fault+inproc://conv-chaos?drop=0.1&delay_ms=20&seed=5"
    leaked_before = metrics.registry.counter("layer.threads.leaked").value
    clean = _run_pipeline("port", "inproc://conv-clean")
    faultbus.reset()
    chaos = _run_pipeline("port", chaos_loc)
    state = faultbus.get_state(chaos_loc)
    assert state.rolls > 0 and state.injected_errors + state.dropped_records > 0
    jax_faultbus = _modules("jax")[4]
    jax_faultbus.reset()
    ref = _run_pipeline("jax", chaos_loc)
    assert clean == chaos == ref == EXPECTED
    assert metrics.registry.counter("layer.threads.leaked").value == leaked_before


def _http_status(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_readyz_flips_across_injected_outage(pkg):
    """/readyz 200 -> 503 -> 200 across set_outage, /healthz degraded but
    alive meanwhile, in the port's serving layer as in the JAX package's."""
    bus_mod, _, serving_cls, _, fb, _ = _modules(pkg)
    loc = "fault+inproc://ready-chaos?seed=0"
    inner = bus_mod.get_broker("inproc://ready-chaos")
    inner.create_topic("OryxUpdate", 1)
    with inner.producer("OryxUpdate") as p:
        p.send("MODEL", json.dumps({"a": 1}))
    layer = serving_cls(serving_config(loc, pkg))
    layer.start()
    try:
        port = layer.port
        assert wait_until(lambda: _http_status(port, "/readyz")[0] == 200)
        fb.set_outage(loc, True)
        assert wait_until(lambda: _http_status(port, "/readyz")[0] == 503)
        status, body = _http_status(port, "/readyz")
        assert body == {"model_ready": True, "stream_ok": False, "draining": False}
        status, body = _http_status(port, "/healthz")
        assert status == 200 and body["degraded"] is True
        assert layer.model_manager.get_model().get_words() == {"a": 1}
        fb.set_outage(loc, False)
        assert wait_until(lambda: _http_status(port, "/readyz")[0] == 200)
        status, body = _http_status(port, "/healthz")
        assert status == 200 and body["degraded"] is False
    finally:
        layer.close()


# -- the batch layer on a fault+ bus ---------------------------------------------


def _batch_layer(loc, tmp_path, update_class="oryx_tpu_torch.example.batch:ExampleBatchLayerUpdate",
                 extra="", update_loc=None):
    from oryx_tpu_torch.lambda_.batch import BatchLayer

    return BatchLayer(C.get_default().with_overlay(f"""
        oryx {{
          id = "ChaosBatch"
          input-topic.broker = "{loc}"
          update-topic.broker = "{update_loc or loc}"
          batch {{
            streaming.generation-interval-sec = 3600
            update-class = "{update_class}"
            storage {{ data-dir = "{tmp_path}/data/", model-dir = "{tmp_path}/model/" }}
            retry {{ max-attempts = 50, initial-backoff-ms = 1, max-backoff-ms = 5 }}
          }}
          {extra}
        }}"""))


def _stored(tmp_path):
    from oryx_tpu_torch.lambda_ import data as data_store

    return [m if isinstance(m, str) else m.decode() for block in
            data_store.FileRecords(str(tmp_path / "data")).blocks() for m in block.messages]


def test_generation_drains_to_the_end_past_lost_polls(tmp_path):
    """At drop=0.5 about every other poll is lost in flight; one generation
    still drains every record (the JAX package's stops at the first)."""
    loc = "fault+inproc://drain?drop=0.5&seed=2"
    layer = _batch_layer(loc, tmp_path, update_loc="inproc://drain")
    layer.prepare()
    try:
        inner = bus.get_broker("inproc://drain")
        with inner.producer("OryxInput") as p:
            p.send_many([(None, f"w{j} x{j}") for j in range(25_000)])
        layer.run_one_generation()
        assert faultbus.get_state(loc).dropped_records > 0
        assert sorted(_stored(tmp_path)) == sorted(f"w{j} x{j}" for j in range(25_000))
        assert inner.get_offsets(layer.group_id, "OryxInput") == inner.latest_offsets("OryxInput")
    finally:
        layer.close()


def test_speed_micro_batch_drains_to_the_end_past_lost_polls():
    """A micro-batch of the monolithic speed path takes every record on
    the topic past polls lost in flight (the JAX package's ends at the
    first and folds the rest an interval later)."""
    from oryx_tpu_torch.lambda_.speed import SpeedLayer

    loc = "fault+inproc://sdrain?drop=0.5&seed=2"
    layer = SpeedLayer(speed_config(loc))
    layer.init_topics()
    layer.start()
    try:
        inner = bus.get_broker("inproc://sdrain")
        with inner.producer("OryxInput") as p:
            p.send_many([(None, f"w{j} x{j}") for j in range(30_000)])
        assert layer.run_one_batch() > 0
        assert faultbus.get_state(loc).dropped_records > 0
        assert wait_until(lambda: inner.get_offsets(layer.group_id, "OryxInput")
                          == inner.latest_offsets("OryxInput"))
        assert layer.run_one_batch() == 0
    finally:
        layer.close()


def test_failed_generation_is_drained_again(tmp_path):
    """The update's publish fails (an outage on the update side): the
    generation raises and the records it drained come again to the next."""
    loc = "fault+inproc://again?seed=1"
    layer = _batch_layer("inproc://again", tmp_path, update_loc=loc)
    layer.prepare()
    try:
        inner = bus.get_broker("inproc://again")
        with inner.producer("OryxInput") as p:
            p.send_many([(None, f"a{j} b{j}") for j in range(50)])
        faultbus.set_levers(loc, drop=1.0)
        with pytest.raises(ConnectionError):
            layer.run_one_generation()
        assert _stored(tmp_path) == []
        faultbus.set_levers(loc, drop=0.0)
        layer.run_one_generation()
        assert sorted(_stored(tmp_path)) == sorted(f"a{j} b{j}" for j in range(50))
        models = inner.consumer("OryxUpdate", from_beginning=True).poll(10, 1.0)
        assert [km.key for km in models] == ["MODEL"]
        assert len(json.loads(models[0].message)) == 100
    finally:
        layer.close()


def test_als_generation_publishes_every_row_under_drops(tmp_path):
    """ALS's UP rows go out under the publish retry: at drop=0.4 the
    generation publishes its MODEL and every X and Y row."""
    loc = "fault+inproc://als-drop?drop=0.4&seed=2"
    layer = _batch_layer(loc, tmp_path, "oryx_tpu_torch.app.als.update:ALSUpdate",
                         "als.hyperparams.features = 4\nals.iterations = 2")
    layer.prepare()
    try:
        inner = bus.get_broker("inproc://als-drop")
        gen = np.random.default_rng(0)
        with inner.producer("OryxInput") as p:
            p.send_many([(None, f"u{gen.integers(30)},i{gen.integers(20)},1,{t}")
                         for t in range(600)])
        layer.run_one_generation()
        assert faultbus.get_state(loc).injected_errors > 0
        got = []
        c = inner.consumer("OryxUpdate", from_beginning=True)
        while True:
            batch = c.poll(10_000, 0.2)
            if not batch:
                break
            got.extend(batch)
        keys = [km.key for km in got]
        assert keys.count("MODEL") == 1
        ups = {tuple(json.loads(km.message)[:2]) for km in got if km.key == "UP"}
        assert {w for w, _ in ups} == {"X", "Y"}
        assert len([u for w, u in ups if w == "X"]) >= 25
    finally:
        layer.close()


# -- common/corruption.py against the JAX package's --------------------------------

INJECTORS = [
    ("tear_tail", lambda m, d: m.tear_tail(d / "bus" / "T" / "partition-0.log", cut=5)),
    ("truncate_to", lambda m, d: m.truncate_to(d / "bus" / "T" / "partition-0.log", 17)),
    ("append_garbage", lambda m, d: m.append_garbage(d / "bus" / "T" / "partition-0.log")),
    ("flip_byte", lambda m, d: m.flip_byte(d / "bus" / "T" / "partition-0.log", 9, 3)),
    ("litter_tmp", lambda m, d: m.litter_tmp(d / "bus" / "T")),
    ("tear_filebus_partition", lambda m, d: m.tear_filebus_partition(d / "bus", "T")),
    ("garble_filebus_ledger", lambda m, d: m.garble_filebus_ledger(d / "bus", "g")),
    ("garble_shm_frame", lambda m, d: m.garble_shm_frame(d / "shm" / "T" / "partition-0.ring")),
    ("garble_shm_header", lambda m, d: m.garble_shm_header(d / "shm" / "T" / "partition-0.ring")),
]


def _corrupted_tree(mod, root):
    """A file bus and an shm ring with the same records, then one injector."""
    broker = bus.get_broker(f"file:{root}/bus")
    broker.create_topic("T", 1)
    with broker.producer("T") as p:
        p.send_many([(f"k{j}", f"message {j}") for j in range(12)])
    c = broker.consumer("T", group="g", from_beginning=True)
    c.poll(5, 1.0)
    c.commit()
    c.close()
    shm = bus.get_broker(f"shm:{root}/shm?ring_bytes={1 << 16}")
    shm.create_topic("T", 1)
    with shm.producer("T") as p:
        for start in (0, 8):
            u = np.arange(start, start + 8, dtype=np.int32)
            p.send_interactions(u, u, u.astype(np.float32))
    return root


@pytest.mark.parametrize("name,inject", INJECTORS, ids=[n for n, _ in INJECTORS])
def test_corruption_injectors_match_the_jax_package(tmp_path, name, inject):
    from oryx_tpu.common import corruption as jax_corruption

    base = _corrupted_tree(corruption, tmp_path / "base")
    ours, ref = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(base, ours)
    shutil.copytree(base, ref)
    said = inject(corruption, ours)
    said_ref = inject(jax_corruption, ref)
    assert said.replace(str(ours), "") == said_ref.replace(str(ref), "")
    files = sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    for rel in files:
        assert (ours / rel).read_bytes() == (ref / rel).read_bytes(), rel
    assert files != sorted(p.relative_to(base) for p in base.rglob("*") if p.is_file()) or any(
        (ours / rel).read_bytes() != (base / rel).read_bytes() for rel in files)


# -- tests/bus/test_kafkabus.py ------------------------------------------------------

try:
    import kafka  # noqa: F401

    _HAS_KAFKA_LIB = True
except ImportError:
    _HAS_KAFKA_LIB = False


@pytest.mark.skipif(_HAS_KAFKA_LIB, reason="kafka-python installed; absence path not testable")
def test_kafka_locator_without_library_raises_helpfully():
    from oryx_tpu import bus as jax_bus

    with pytest.raises(RuntimeError, match="kafka-python") as ours:
        bus.get_broker("kafka://localhost:9092")
    with pytest.raises(RuntimeError, match="kafka-python") as ref:
        jax_bus.get_broker("kafka://localhost:9092")
    assert str(ours.value) == str(ref.value)


@pytest.mark.skipif(not _HAS_KAFKA_LIB, reason="needs kafka-python and a Kafka broker "
                    "(ORYX_KAFKA_BOOTSTRAP), as tests/bus/test_kafkabus.py does")
def test_kafka_roundtrip_with_group_resume():
    import os
    import uuid

    bootstrap = os.environ.get("ORYX_KAFKA_BOOTSTRAP")
    if not bootstrap:
        pytest.skip("ORYX_KAFKA_BOOTSTRAP not set")
    broker = bus.get_broker(f"kafka://{bootstrap}")
    topic = f"oryx-it-{uuid.uuid4().hex[:10]}"
    broker.create_topic(topic, 1)
    try:
        with broker.producer(topic) as p:
            p.send_many((None, f"m{j}") for j in range(10))
        c = broker.consumer(topic, group="g", from_beginning=True)
        got = []
        deadline = time.time() + 20
        while len(got) < 10 and time.time() < deadline:
            got.extend(c.poll(timeout=2.0))
        c.close()
        assert [km.message for km in got] == [f"m{j}" for j in range(10)]
    finally:
        broker.delete_topic(topic)


# -- tests/bus/test_trace_propagation.py ---------------------------------------------


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracing.reset()
    tracing.configure(sample_rate=1.0)
    yield
    tracing.reset()


@pytest.fixture(params=["inproc", "file", "shm"])
def trace_locator(request, tmp_path):
    if request.param == "inproc":
        return "inproc://trace-prop"
    return f"{request.param}:{tmp_path}/bus"


def _produce_all(producer, records, timeout=10.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            return producer.send_many(records)
        except ConnectionError:
            if time.monotonic() >= deadline:
                raise


def test_header_round_trips_and_is_stripped(trace_locator):
    broker = bus.get_broker(trace_locator)
    broker.create_topic("T", 1)
    records, extra = tracing.with_header(
        [("k1", "v1"), (None, "v2")], CTX, ingest_ms=4242
    )
    assert extra == 1
    with broker.producer("T") as p:
        assert p.send_many(records) == 3  # header occupies a topic offset
    c = broker.consumer("T", from_beginning=True)
    block = c.poll_block(max_records=10, timeout=1.0)
    # the control record is stripped from the delivered payload...
    assert len(block) == 2
    assert [m for m in block.messages] == [b"v1", b"v2"]
    # ...and surfaced, raw, as block.trace
    info = tracing.parse_header(block.trace)
    assert info.ctx == CTX and info.ingest_ms == 4242
    c.close()


def test_untraced_batch_has_no_header(trace_locator):
    broker = bus.get_broker(trace_locator)
    broker.create_topic("T", 1)
    records, extra = tracing.with_header([(None, "plain")])
    assert extra == 0  # nothing to carry: hot path stays header-free
    with broker.producer("T") as p:
        assert p.send_many(records) == 1
    c = broker.consumer("T", from_beginning=True)
    block = c.poll_block(timeout=1.0)
    assert len(block) == 1 and block.trace is None
    c.close()


def test_columnar_frames_carry_ambient_trace(tmp_path):
    """The shm columnar path (send_interactions -> KIND_TRACE frame):
    the producer's ambient context rides next to the typed columns."""
    broker = bus.get_broker(f"shm:{tmp_path}/bus")
    broker.create_topic("T", 1)
    users = np.arange(50, dtype=np.int32)
    with broker.producer("T") as p, tracing.use(CTX):
        assert p.send_interactions(users, users, users.astype(np.float32)) == 50
    c = broker.consumer("T", from_beginning=True)
    block = c.poll_block(max_records=100, timeout=1.0)
    assert len(block) == 50
    info = tracing.parse_header(block.trace)
    assert info is not None and info.ctx is not None
    assert info.ctx.trace_id == CTX.trace_id
    # materialize() must not lose the trace
    assert block.materialize().trace == block.trace
    c.close()


def test_trace_survives_shm_crc_resync(tmp_path):
    """A torn columnar frame is CRC-rejected and resynced past; the trace
    frame of the NEXT batch still parses."""
    from oryx_tpu_torch.bus import shmbus

    broker = bus.get_broker(f"shm:{tmp_path}/bus")
    broker.create_topic("T", 1)
    u1 = np.arange(10, dtype=np.int32)
    u2 = np.arange(10, 15, dtype=np.int32)
    with broker.producer("T") as p:
        p.send_interactions(u1, u1, u1.astype(np.float32))
        with tracing.use(CTX):
            p.send_interactions(u2, u2, u2.astype(np.float32))
    ring_path = tmp_path / "bus" / "T" / "partition-0.ring"
    with open(ring_path, "r+b") as f:
        f.seek(shmbus._HEADER_PAGE + shmbus.blockcodec.HEADER_BYTES + 8)
        f.write(b"\xff\xff\xff\xff")
    resyncs0 = metrics.registry.counter("bus.shm.crc-resyncs").value
    c = broker.consumer("T", from_beginning=True)
    block = c.poll_block(max_records=100, timeout=1.0)
    assert block is not None and len(block) == 5
    np.testing.assert_array_equal(block.users, u2)
    info = tracing.parse_header(block.trace)
    assert info is not None and info.ctx.trace_id == CTX.trace_id
    assert metrics.registry.counter("bus.shm.crc-resyncs").value > resyncs0
    c.close()


def test_trace_header_at_least_once_under_chaos(tmp_path):
    """drop + delay levers on: every payload AND every batch's trace id
    eventually arrives (at-least-once holds for control records too)."""
    loc = f"fault+file:{tmp_path}/bus?drop=0.4&delay_ms=2&seed=11"
    broker = bus.get_broker(loc)
    broker.create_topic("T", 1)
    want_traces = set()
    with broker.producer("T") as p:
        for i in range(8):
            ctx = TraceContext(f"{i + 1:032x}", f"{i + 1:016x}", True)
            want_traces.add(ctx.trace_id)
            records, _ = tracing.with_header([(None, f"m{i}")], ctx, ingest_ms=i)
            _produce_all(p, records)
    c = broker.consumer("T", from_beginning=True)
    got_msgs: set = set()
    got_traces: set = set()
    deadline = time.monotonic() + 20.0
    while (
        len(got_msgs) < 8 or not want_traces.issubset(got_traces)
    ) and time.monotonic() < deadline:
        # raw poll: a wide poll_block would coalesce batches and keep only
        # the last header, so inspect every control record individually
        for km in c.poll(100, timeout=0.05):
            if km.key in (tracing.TRACE_KEY, tracing.TRACE_KEY.encode()):
                info = tracing.parse_header(km.message)
                if info is not None and info.ctx is not None:
                    got_traces.add(info.ctx.trace_id)
            else:
                m = km.message
                got_msgs.add(m.decode() if isinstance(m, bytes) else m)
    assert got_msgs == {f"m{i}" for i in range(8)}
    assert want_traces.issubset(got_traces)
    c.close()


def test_duplicate_delivery_same_trace_fresh_span(tmp_path):
    """dup lever at 1.0: the batch (header included) is delivered more
    than once. Both deliveries carry the SAME trace id — and
    `continue_from` mints a distinct span id per delivery, so each
    delivery's spans are separable in the ring."""
    loc = f"fault+file:{tmp_path}/bus?dup=1.0&seed=5"
    broker = bus.get_broker(loc)
    broker.create_topic("T", 1)
    records, _ = tracing.with_header([(None, "payload")], CTX, ingest_ms=7)
    with broker.producer("T") as p:
        _produce_all(p, records)
    c = broker.consumer("T", from_beginning=True)
    headers: list = []
    deadline = time.monotonic() + 10.0
    while len(headers) < 2 and time.monotonic() < deadline:
        for km in c.poll(100, timeout=0.05):
            if km.key in (tracing.TRACE_KEY, tracing.TRACE_KEY.encode()):
                headers.append(km.message)
    assert len(headers) >= 2, "dup lever never duplicated the delivery"
    infos = [tracing.parse_header(h) for h in headers]
    assert {i.ctx.trace_id for i in infos} == {CTX.trace_id}
    kids = [tracing.continue_from(i.ctx) for i in infos]
    assert len({k.span_id for k in kids}) == len(kids)
    assert {k.trace_id for k in kids} == {CTX.trace_id}
    c.close()
