"""The port's ALS apps (oryx_tpu_torch/app/als/{update,speed,data}.py,
native/store.py) against the JAX package's, on the CPU.

- ``ALSUpdate``: the same input lines give the same PMML and factors
  within the reference's factor bar (rtol 2e-2, atol 2e-3), the same
  evaluation, split and UP messages.
- Read-across: a model the port trained serves in the JAX package's ALS
  serving model, and the reverse.
- ``ALSSpeedModelManager``: the same update messages as the JAX
  manager's, compared as parsed values (the port writes ``json.dumps``
  vectors, the JAX package's native library ``%.9g``), and the ALS
  cases of tests/lambda_/test_speed_pipeline.py (staged parse/fold, the
  typed-block fast path).
- The ALS lambda loop, batch + speed + serving on one bus, in one
  process.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from oryx_tpu import bus as jbus
from oryx_tpu.app import pmml as japp_pmml
from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu.app.als import update as jupdate
from oryx_tpu.app.als.speed import ALSSpeedModel as JaxSpeedModel
from oryx_tpu.app.als.speed import ALSSpeedModelManager as JaxSpeedManager
from oryx_tpu.bus.core import KeyMessage as JaxKeyMessage
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import rng as jrng
from oryx_tpu_torch import NotYetPortedError, bus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app import pmml as app_pmml
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.app.als import update as tupdate
from oryx_tpu_torch.app.als.speed import ALSSpeedModel, ALSSpeedModelManager
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as C
from oryx_tpu_torch.common import rng as trng
from oryx_tpu_torch.common import tracing
from oryx_tpu_torch.common.records import BlockRecords, InteractionBlock
from oryx_tpu_torch.native import store

FACTORS = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    trng.use_test_seed()
    jrng.use_test_seed()
    yield
    trng.clear_test_seed()
    port_device.set_device(None)
    InProcessBroker.reset_all()


def update_config(conf, implicit=True, test_fraction=0.0, extra=""):
    return conf.get_default().with_overlay(
        f"""
        oryx {{
          ml.eval {{ candidates = 1, test-fraction = {test_fraction} }}
          als {{
            implicit = {str(implicit).lower()}
            iterations = 8
            hyperparams {{ features = 5, lambda = 0.01, alpha = 2.0 }}
          }}
          {extra}
        }}
        """
    )


def interaction_lines(implicit=True, num_users=30, num_items=20, per_user=6, seed=5):
    """Two taste groups; implicit strengths 1-3, explicit ratings 1-5;
    every line timestamped."""
    gen = np.random.default_rng(seed)
    group_u = gen.integers(0, 2, num_users)
    group_i = gen.integers(0, 2, num_items)
    lines, ts = [], 0
    for u in range(num_users):
        liked = np.nonzero(group_i == group_u[u])[0]
        for i in gen.choice(liked, size=min(per_user, len(liked)), replace=False):
            ts += 1
            value = 1.0 + 2.0 * gen.random() if implicit else float(gen.integers(1, 6))
            lines.append(f"U{u},I{i},{value:.3f},{ts}")
    return lines


def build_both(tmp_path, implicit=True):
    lines = interaction_lines(implicit)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_up = jupdate.ALSUpdate(update_config(jconfig, implicit))
    port_up = tupdate.ALSUpdate(update_config(C, implicit))
    jax_pmml = jax_up.build_model([JaxKeyMessage(None, m) for m in lines], [5, 0.01, 2.0], jax_dir)
    port_pmml = port_up.build_model([KeyMessage(None, m) for m in lines], [5, 0.01, 2.0], port_dir)
    return lines, (jax_up, jax_pmml, jax_dir), (port_up, port_pmml, port_dir)


# -- ALSUpdate -----------------------------------------------------------------


@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "explicit"])
def test_build_model_matches_jax(tmp_path, implicit):
    _, (_, jax_pmml, jax_dir), (_, port_pmml, port_dir) = build_both(tmp_path, implicit)
    for name in ("X", "Y", "features", "lambda", "implicit", "alpha"):
        assert app_pmml.get_extension_value(port_pmml, name) == japp_pmml.get_extension_value(
            jax_pmml, name
        )
    for name in ("XIDs", "YIDs"):
        assert app_pmml.get_extension_content(port_pmml, name) == japp_pmml.get_extension_content(
            jax_pmml, name
        )
    for side in ("X", "Y"):
        want_ids, want = jupdate._load_features(jax_dir / side)
        got_ids, got = tupdate._load_features(port_dir / side)
        assert got_ids == want_ids
        np.testing.assert_allclose(got, want, **FACTORS)
        # either package reads the other's artifacts to the same values
        np.testing.assert_array_equal(jupdate._load_features(port_dir / side)[1], got)


@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "explicit"])
def test_evaluate_matches_jax(tmp_path, implicit):
    """Both evaluate the JAX package's model on the same test lines: AUC
    (same seeded negatives) within 1e-3, or the same negated RMSE."""
    lines, (jax_up, jax_pmml, jax_dir), (port_up, _, _) = build_both(tmp_path, implicit)
    test = lines[:40]
    jrng.use_test_seed()
    trng.use_test_seed()
    want = jax_up.evaluate(jax_pmml, jax_dir, [JaxKeyMessage(None, m) for m in test], [])
    got = port_up.evaluate(jax_pmml, jax_dir, [KeyMessage(None, m) for m in test], [])
    assert got == pytest.approx(want, abs=1e-3 if implicit else 1e-5)
    assert (0.5 < got <= 1.0) if implicit else (-1.0 < got <= 0.0)


def test_time_ordered_split_matches_jax():
    lines = [f"u,i,1.0,{ts}" for ts in [30, 10, 40, 20, 50, 0]]
    jax_up = jupdate.ALSUpdate(update_config(jconfig, test_fraction=0.25))
    port_up = tupdate.ALSUpdate(update_config(C, test_fraction=0.25))
    want = jax_up.split_new_data_to_train_test([JaxKeyMessage(None, m) for m in lines])
    got = port_up.split_new_data_to_train_test([KeyMessage(None, m) for m in lines])
    assert [[r.message for r in part] for part in got] == [
        [r.message for r in part] for part in want
    ]


def test_mesh_raises():
    with pytest.raises(NotYetPortedError, match="mesh"):
        tupdate.ALSUpdate(update_config(C, extra='batch.compute.mesh = "data:1"'))


def test_warm_start_carries_the_champion_factors(tmp_path):
    """A previous generation's Y seeds the items it shares with this one;
    new items get the random init (as the JAX package's ALSUpdate)."""
    lines, _, (port_up, _, port_dir) = build_both(tmp_path)
    ids_y, y_prev = tupdate._load_features(port_dir / "Y")
    port_up.previous_model_dir = str(port_dir)
    port_up.previous_generation_id = "1"
    rm = port_up._prepare([KeyMessage(None, m) for m in lines + ["U0,Inew,1.0,999"]])
    init = port_up._warm_start_init_y(rm, 5)
    rows = {i: n for n, i in enumerate(rm.item_ids)}
    for n, item in enumerate(ids_y):
        np.testing.assert_array_equal(init[rows[item]], y_prev[n])
    assert np.isfinite(init[rows["Inew"]]).all() and init.shape == (len(rm.item_ids), 5)
    assert port_up._warm_start_init_y(rm, 6) is None  # feature count changed


def _run_update(pkg, tmp_path, lines):
    """run_update of one package's ALSUpdate onto its own in-proc update
    topic; the MODEL and UP messages it published, in order."""
    if pkg == "jax":
        up, km, broker = jupdate.ALSUpdate(update_config(jconfig)), JaxKeyMessage, jbus
    else:
        up, km, broker = tupdate.ALSUpdate(update_config(C)), KeyMessage, bus
    b = broker.get_broker(f"inproc://als-app-{pkg}")
    b.create_topic("OryxUpdate", 1)
    tail = b.consumer("OryxUpdate", from_beginning=True)
    with b.producer("OryxUpdate") as producer:
        up.run_update(1000, [km(None, m) for m in lines], [], str(tmp_path / pkg), producer)
    msgs = [m for m in tail.poll(max_records=100_000, timeout=2.0) if m.key != tracing.TRACE_KEY]
    return [(m.key, m.message) for m in msgs]


def test_published_updates_match_jax(tmp_path):
    """MODEL, then every Y row, then every X row with its known items:
    the same ids and known lists, the vectors within the factor bar."""
    lines = interaction_lines()
    want = _run_update("jax", tmp_path, lines)
    got = _run_update("torch", tmp_path, lines)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert got[0][0] == "MODEL"
    g_ups = [json.loads(m) for k, m in got if k == "UP"]
    w_ups = [json.loads(m) for k, m in want if k == "UP"]
    assert [u[0] for u in g_ups] == [u[0] for u in w_ups]
    kinds = [u[0] for u in g_ups]
    assert kinds.index("X") > kinds.index("Y") and "Y" not in kinds[kinds.index("X"):]
    for g, w in zip(g_ups, w_ups):
        assert g[1] == w[1] and g[3:] == w[3:]
        np.testing.assert_allclose(g[2], w[2], **FACTORS)


def _served(sm, conf, km, messages):
    """A package's ALS serving model fed ``messages`` (key, text)."""
    manager = sm.ALSServingModelManager(conf.get_default())
    manager.consume(iter(km(k, m) for k, m in messages))
    return manager.get_model()


@pytest.mark.parametrize("trained_by", ["torch", "jax"])
def test_read_across(tmp_path, trained_by):
    """A model one package trains and publishes serves in the other's
    ALS serving model: the same vectors, the same known items, and the
    exact top-5 of each user's float64 scores (known items excluded)."""
    lines = interaction_lines()
    messages = _run_update(trained_by, tmp_path, lines)
    if trained_by == "torch":
        model = _served(jsm, jconfig, JaxKeyMessage, messages)
    else:
        model = _served(tsm, C, KeyMessage, messages)
    ups = [json.loads(m) for k, m in messages if k == "UP"]
    x = {u[1]: np.asarray(u[2], np.float32) for u in ups if u[0] == "X"}
    y = {u[1]: np.asarray(u[2], np.float32) for u in ups if u[0] == "Y"}
    known = {u[1]: set(u[3]) for u in ups if u[0] == "X"}
    item_ids = sorted(y)
    ymat = np.stack([y[i] for i in item_ids]).astype(np.float64)
    for user in sorted(x)[:10]:
        np.testing.assert_array_equal(model.get_user_vector(user), x[user])
        assert model.get_known_items(user) == known[user]
        scores = ymat @ x[user].astype(np.float64)
        order = [item_ids[j] for j in np.argsort(-scores, kind="stable") if item_ids[j] not in known[user]]
        got = model.top_n(x[user], 5, exclude=known[user])
        assert [r[0] for r in got] == order[:5]


def test_known_items_with_spaced_separators():
    """ALSUpdate publishes each user's known items with json.dumps, whose
    list separator is '", "'. The serving model's UP fast path took only
    '","', and read ["I0", "I1"] as the one id 'I0", "I1'."""
    from oryx_tpu_torch.common import pmml as pmml_io

    manager = tsm.ALSServingModelManager(C.get_default())
    root = pmml_io.build_skeleton_pmml()
    app_pmml.add_extension(root, "features", 2)
    app_pmml.add_extension(root, "implicit", "true")
    app_pmml.add_extension_content(root, "XIDs", ["U0", "U1"])
    app_pmml.add_extension_content(root, "YIDs", ["I0", "I1", "I2"])
    manager.consume(iter([KeyMessage("MODEL", pmml_io.to_string(root))]))
    lines = [
        b'["Y","I0",[1.0, 0.0]]', b'["Y","I1",[0.0, 1.0]]', b'["Y","I2",[0.5, 0.5]]',
        b'["X","U0",[1.0, 0.0],["I0", "I1"]]', b'["X","U1",[0.0, 1.0],["I2","I1"]]',
    ]
    manager._apply_up_batch(lines)
    model = manager.get_model()
    assert model.get_known_items("U0") == {"I0", "I1"}
    assert model.get_known_items("U1") == {"I1", "I2"}
    assert [r[0] for r in model.top_n(np.array([1.0, 0.0], np.float32), 3,
                                      exclude=model.get_known_items("U0"))] == ["I2"]


# -- native/store.py -------------------------------------------------------------


def test_store_formats_read_back_to_the_same_float32():
    gen = np.random.default_rng(3)
    mat = gen.standard_normal((4, 3)).astype(np.float32)
    mat[0, 1] = np.nan
    rows = [json.loads(s) for s in store.format_vectors_json(mat)]
    want = np.nan_to_num(mat, nan=0.0)
    np.testing.assert_array_equal(np.asarray(rows, np.float32), want)
    msgs = store.format_update_messages_multi(mat[:2], ["u\"1", "u2"], [["i1", "i2"], []], "X")
    assert [json.loads(m)[:2] for m in msgs] == [["X", 'u"1'], ["X", "u2"]]
    assert [json.loads(m)[3] for m in msgs] == [["i1", "i2"], []]
    plain = store.format_update_messages(mat[2:], ["a", "b"], [], "Y", False)
    assert [len(json.loads(m)) for m in plain] == [3, 3]
    known = store.format_update_messages(mat[2:], ["a", "b"], ["x", "y"], "Y")
    assert [json.loads(m)[3] for m in known] == [["x"], ["y"]]
    assert type(store.make_feature_vectors()).__name__ == "FeatureVectors"


# -- ALSSpeedModelManager ----------------------------------------------------------


def speed_managers(implicit=True, backend="host"):
    """The port's and the JAX package's manager on the same two-feature
    model."""
    extra = f'oryx.als.implicit = {str(implicit).lower()}\noryx.speed.fold-in-backend = "{backend}"'
    out = []
    for conf, mgr_cls, model_cls in ((C, ALSSpeedModelManager, ALSSpeedModel),
                                     (jconfig, JaxSpeedManager, JaxSpeedModel)):
        mgr = mgr_cls(conf.get_default().with_overlay(extra))
        mgr.model = model_cls(2, implicit, set(), set())
        mgr.model.set_user_vectors(["u1", "u2"], np.array([[1.0, 0.1], [0.2, 1.0]], np.float32))
        mgr.model.set_item_vectors(["i1", "i2"], np.array([[0.9, 0.3], [0.4, 0.8]], np.float32))
        out.append(mgr)
    return out


def assert_same_updates(got, want):
    g, w = [json.loads(m) for m in got], [json.loads(m) for m in want]
    assert [u[:2] + u[3:] for u in g] == [u[:2] + u[3:] for u in w]
    for gu, wu in zip(g, w):
        np.testing.assert_allclose(gu[2], wu[2], rtol=1e-4, atol=1e-5)


EVENTS = ["u1,i2,3.0,1", "u2,i1,2.0,2", "u1,i2,1.5,3", "u3,i1,1.0,4", "u2,i9,-1.0,5"]


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "explicit"])
def test_build_updates_match_jax(implicit, backend):
    port, jax = speed_managers(implicit, backend)
    got = port.build_updates([KeyMessage(None, e) for e in EVENTS])
    want = jax.build_updates([JaxKeyMessage(None, e) for e in EVENTS])
    assert got and len(got) == len(want)
    assert_same_updates(got, want)
    # self-apply: the published vectors are the model's now
    for msg in got:
        which, id_, vec = json.loads(msg)[:3]
        store_ = port.model.x if which == "X" else port.model.y
        np.testing.assert_array_equal(store_.get_vector(id_), np.asarray(vec, np.float32))


@pytest.mark.parametrize("implicit", [True, False])
def test_als_staged_api_matches_build_updates(implicit):
    """parse_batch |> fold_parsed == build_updates, message for message,
    and equal to the JAX manager's staged output."""
    whole = list(speed_managers(implicit)[0].build_updates([KeyMessage(None, e) for e in EVENTS]))
    port, jax = speed_managers(implicit)
    staged = list(port.fold_parsed(port.parse_batch([KeyMessage(None, e) for e in EVENTS])))
    assert staged == whole
    want = jax.fold_parsed(jax.parse_batch([JaxKeyMessage(None, e) for e in EVENTS]))
    assert_same_updates(staged, want)


@pytest.mark.parametrize("implicit", [True, False])
def test_als_typed_block_fast_path_matches_text(implicit):
    """A typed InteractionBlock batch folds to exactly the messages the
    equivalent text batch produces."""
    users = np.array([1, 2, 1], np.int32)
    items = np.array([2, 1, 2], np.int32)
    values = np.array([3.0, 2.0, 1.5], np.float32)
    ts = np.array([1, 2, 3], np.int64)
    text = [f"u{u},i{i},{v:.9g},{t}" for u, i, v, t in
            zip(users.tolist(), items.tolist(), values.tolist(), ts.tolist())]
    whole = list(speed_managers(implicit)[0].build_updates([KeyMessage(None, e) for e in text]))
    mgr = speed_managers(implicit)[0]
    staged = list(mgr.fold_parsed(mgr.parse_batch(BlockRecords([InteractionBlock(users, items, values, ts)]))))
    assert sorted(staged) == sorted(whole)


def test_als_parse_batch_empty_and_gated():
    mgr = speed_managers()[0]
    assert mgr.parse_batch([]) is None
    assert mgr.fold_parsed(None) == []
    rm = mgr.parse_batch([KeyMessage(None, "u1,i2,1.0,1")])
    mgr.model = None
    assert mgr.fold_parsed(rm) == []


def test_min_model_load_fraction_gate():
    mgr = ALSSpeedModelManager(C.get_default().with_overlay("oryx.speed.min-model-load-fraction = 0.9"))
    mgr.model = ALSSpeedModel(2, True, {"u1", "u2", "u3"}, {"i1", "i2", "i3"})
    mgr.model.set_user_vectors(["u1"], np.array([[1.0, 0.1]], np.float32))
    mgr.model.set_item_vectors(["i1"], np.array([[0.9, 0.3]], np.float32))
    assert mgr.build_updates([KeyMessage(None, "u1,i1,1.0,1")]) == []
    mgr.model.set_user_vectors(["u2", "u3"], np.ones((2, 2), np.float32))
    mgr.model.set_item_vectors(["i2", "i3"], np.ones((2, 2), np.float32))
    assert mgr.build_updates([KeyMessage(None, "u1,i1,1.0,1")])


def test_consume_model_and_updates_match_jax(tmp_path):
    """Both managers replay the same MODEL and UP stream to the same
    speed model; a second MODEL rotates, keeping recent writes."""
    messages = _run_update("jax", tmp_path, interaction_lines())
    port = ALSSpeedModelManager(C.get_default())
    jax = JaxSpeedManager(jconfig.get_default())
    port.consume(iter(KeyMessage(k, m) for k, m in messages))
    jax.consume(iter(JaxKeyMessage(k, m) for k, m in messages))
    assert port.model.features == jax.model.features == 5
    assert port.model.get_fraction_loaded() == jax.model.get_fraction_loaded() == 1.0
    for side in ("x", "y"):
        p, j = getattr(port.model, side), getattr(jax.model, side)
        assert sorted(p.ids()) == sorted(j.ids())
        for id_ in p.ids():
            np.testing.assert_array_equal(p.get_vector(id_), j.get_vector(id_))
    port.consume(iter([KeyMessage("UP", '["X","Unew",[1,2,3,4,5]]')]))
    port.consume(iter(KeyMessage(k, m) for k, m in messages[:1]))
    assert port.model.x.get_vector("Unew") is not None


def test_configure_sharding_retires_the_self_pending_queue():
    mgr = speed_managers()[0]
    mgr.build_updates([KeyMessage(None, e) for e in EVENTS])
    assert mgr._self_pending
    mgr.configure_sharding(4)
    assert not mgr._self_pending and mgr._self_pending_cap == 0
    assert mgr.fold_parsed(mgr.parse_batch([KeyMessage(None, e) for e in EVENTS]), shard=3)


def test_native_parse_setting_takes_the_python_parser(caplog):
    with caplog.at_level("INFO"):
        mgr = ALSSpeedModelManager(C.get_default().with_overlay("oryx.speed.parse.native = true"))
    assert "Python parser" in caplog.text
    assert mgr.parse_batch([KeyMessage(None, "u1,i2,1.0,1")]) is not None


@pytest.mark.parametrize("shards", [1, 2])
def test_pipelined_speed_layer_folds_als(tmp_path, shards):
    """oryx.speed.pipeline.enabled with the ALS manager on a file: bus: the
    staged parse -> fold -> publish chains publish, for every event's user
    and item, the update the monolithic build_updates computes from the
    same model (one shard: the same messages), and commit the input."""
    from oryx_tpu_torch.lambda_.speed import SpeedLayer

    loc = f"file:{tmp_path}/bus"
    cfg = C.get_default().with_overlay(
        f"""
        oryx {{
          id = "ALSPipe"
          input-topic.broker = "{loc}"
          update-topic.broker = "{loc}"
          speed {{
            streaming.generation-interval-sec = 1
            model-manager-class = "oryx_tpu_torch.app.als.speed:ALSSpeedModelManager"
            pipeline {{ enabled = true, min-batch-ms = 50, shards = {shards} }}
          }}
        }}
        """
    )
    messages = _run_update("torch", tmp_path, interaction_lines())
    broker = bus.get_broker(loc)
    layer = SpeedLayer(cfg)
    assert layer.pipeline_enabled
    layer.init_topics()
    with broker.producer("OryxUpdate") as p:
        p.send_many(messages)
    tail = broker.consumer("OryxUpdate")
    events = [f"U{j % 30},I{(7 * j) % 20},{1 + j % 3}.0,{100 + j}" for j in range(60)]
    want_mgr = ALSSpeedModelManager(C.get_default())
    want_mgr.consume(iter(KeyMessage(k, m) for k, m in messages))
    want = want_mgr.build_updates([KeyMessage(None, e) for e in events])
    layer.start()
    try:
        assert wait_for(lambda: layer.manager.model is not None
                        and layer.manager.model.get_fraction_loaded() == 1.0)
        with broker.producer("OryxInput") as p:
            # one shard: one partition, so the batch is one append and one
            # micro-batch; two: keyed by user over the partitions
            p.send_many([(e.split(",")[0] if shards > 1 else None, e) for e in events])
        got: list[str] = []
        assert wait_for(lambda: got.extend(
            m.message for m in tail.poll(timeout=0.2) if m.key == "UP"
        ) or {tuple(json.loads(m)[:2]) for m in got} >= {tuple(json.loads(m)[:2]) for m in want})
        if shards == 1:
            assert_same_updates(sorted(got), sorted(want))
        assert wait_for(
            lambda: sum(broker.get_offsets(layer.group_id, "OryxInput").values()) == len(events)
        )
    finally:
        layer.close()


# -- the lambda loop in one process ----------------------------------------------


def http(method, url, body=None):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("broker", ["inproc", "file"])
def test_full_als_pipeline(tmp_path, broker):
    """tests/app/als/test_als_e2e.py's loop on the port: ingest through
    serving, one batch generation, /recommend without known items, a
    /pref folded by the speed layer into the serving model."""
    from oryx_tpu_torch.lambda_.batch import BatchLayer
    from oryx_tpu_torch.lambda_.speed import SpeedLayer
    from oryx_tpu_torch.serving.layer import ServingLayer

    loc = "inproc://als-e2e" if broker == "inproc" else f"file:{tmp_path}/bus"
    cfg = C.get_default().with_overlay(
        f"""
        oryx {{
          id = "ALSE2E"
          input-topic.broker = "{loc}"
          update-topic.broker = "{loc}"
          batch {{
            streaming.generation-interval-sec = 3600
            update-class = "oryx_tpu_torch.app.als.update:ALSUpdate"
            storage {{ data-dir = "{tmp_path}/data/", model-dir = "{tmp_path}/model/" }}
          }}
          speed {{
            streaming.generation-interval-sec = 3600
            model-manager-class = "oryx_tpu_torch.app.als.speed:ALSSpeedModelManager"
          }}
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"
            application-resources = "oryx_tpu_torch.app.als.endpoints"
          }}
          ml.eval {{ candidates = 1, test-fraction = 0 }}
          als {{ implicit = true, iterations = 6,
                 hyperparams {{ features = 4, lambda = 0.01, alpha = 2.0 }} }}
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
        gen = np.random.default_rng(0)
        lines, ts = [], 0
        for u in range(12):
            for i in range(8):
                if (u < 6) == (i < 4) or gen.random() < 0.2:
                    ts += 1
                    lines.append(f"u{u},i{i},{1.0 + 2.0 * gen.random():.2f},{ts}")
        assert http("POST", f"{base}/ingest", "\n".join(lines).encode())[0] == 204
        batch.run_one_generation(timestamp_ms=12345)
        assert (tmp_path / "model" / "12345" / "model.pmml").exists()
        assert wait_for(lambda: http("GET", f"{base}/ready")[0] == 200)
        assert wait_for(lambda: http("GET", f"{base}/recommend/u0")[0] == 200)
        time.sleep(0.3)  # let the device cache refresh past its window
        known = set(json.loads(http("GET", f"{base}/knownItems/u0")[1]))
        assert known and all(k in {f"i{j}" for j in range(8)} for k in known)
        recs = [r["id"] for r in json.loads(http("GET", f"{base}/recommend/u0")[1])]
        assert recs and not (set(recs) & known)
        assert http("POST", f"{base}/pref/u0/i7", b"5.0")[0] == 204
        assert speed.run_one_batch() > 0
        assert wait_for(
            lambda: "i7" in json.loads(http("GET", f"{base}/knownItems/u0")[1] or "[]")
        )
        assert speed.manager.model.x.get_vector("u0") is not None
        metrics = json.loads(http("GET", f"{base}/metrics")[1])
        assert metrics["kernels.topn_scan.tc.launches"]["value"] == 0  # the CPU's plain scan
    finally:
        serving.close()
        speed.close()
        batch.close()


def test_als_lambda_as_three_processes_on_the_cpu():
    """chip_smoke's als-lambda phase at a small size, its layers started as
    ``python -m oryx_tpu_torch ... --device cpu``: every check of the phase
    holds (exact float32 top-10, int8 recall, the float64 fold-in of each
    new user's events, a speed restart between the waves); on the CPU the
    serving processes scan with the plain versions and count no launch."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    out = chip_smoke.phase_als_lambda(7, scale=0.02, device="cpu", batch_interval=10)
    assert out["batch_generation_s"]["count"] == 1
    assert out["int8_recall_at_10"] >= 0.99
    assert out["wave1_fold_max_rel_err"] <= 1e-4 and out["wave2_fold_max_rel_err"] <= 1e-4
    assert not any(out["serving_launches"].values())
