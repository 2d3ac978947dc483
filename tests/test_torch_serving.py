"""The ALS serving slice as a whole: the port's ServingLayer against the
JAX package's, on the CPU, fed the same MODEL/UP messages.

- The model and HTTP cases of tests/app/als/test_als_serving.py run on
  both packages. With the default float32 scores the response bodies of
  the hand-built model are byte-identical.
- On a seeded random model (5,000 items, 16 features) the ids come back
  in the same order and the values agree within rtol 1e-5: the two CPU
  dot products may sum in another order.
- The index-submit freshness contract holds on the port.
- Settings the port does not serve yet raise instead of serving
  something else; a declared tenant and an A/B split start and serve.
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
from oryx_tpu.bus.core import KeyMessage as JaxKeyMessage
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as jpmml
from oryx_tpu.serving.layer import ServingLayer as JaxServingLayer
from oryx_tpu_torch import bus as tbus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app import pmml as tapp_pmml
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as tpmml
from oryx_tpu_torch.common import rng as trng
from oryx_tpu_torch.common.text import join_json
from oryx_tpu_torch.serving.layer import ServingLayer

USER_VECS = {"U0": [1.0, 0.0], "U1": [0.0, 1.0], "U2": [0.7, 0.7]}
ITEM_VECS = {"I0": [1.0, 0.0], "I1": [0.0, 1.0], "I2": [0.9, 0.1], "I3": [0.5, 0.5]}
KNOWN = {"U0": ["I0"], "U1": ["I1", "I3"]}

PACKAGES = {
    "jax": (jsm, jconfig, jpmml, japp_pmml, jbus, JaxServingLayer, "oryx_tpu"),
    "torch": (tsm, tconfig, tpmml, tapp_pmml, tbus, ServingLayer, "oryx_tpu_torch"),
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    trng.use_test_seed()
    yield
    trng.clear_test_seed()
    port_device.set_device(None)
    InProcessBroker.reset_all()


def build_model(sm, refresh_sec=0.0):
    m = sm.ALSServingModel(2, implicit=True, refresh_sec=refresh_sec)
    for u, v in USER_VECS.items():
        m.set_user_vector(u, np.asarray(v, dtype=np.float32))
    for i, v in ITEM_VECS.items():
        m.set_item_vector(i, np.asarray(v, dtype=np.float32))
    for u, items in KNOWN.items():
        m.add_known_items(u, items)
    return m


def model_message(pkg, x_ids, y_ids, features=2):
    _, _, pmml_io, app_pmml, _, _, _ = PACKAGES[pkg]
    root = pmml_io.build_skeleton_pmml()
    app_pmml.add_extension(root, "features", features)
    app_pmml.add_extension(root, "implicit", "true")
    app_pmml.add_extension_content(root, "XIDs", list(x_ids))
    app_pmml.add_extension_content(root, "YIDs", list(y_ids))
    return pmml_io.to_string(root)


def serving_config(pkg, broker_loc, extra=""):
    _, config, _, _, _, _, name = PACKAGES[pkg]
    return config.get_default().with_overlay(
        f"""
        oryx {{
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          serving {{
            api.port = 0
            model-manager-class = "{name}.app.als.serving_model:ALSServingModelManager"
            application-resources = "{name}.app.als.endpoints"
          }}
          {extra}
        }}
        """
    )


# -- model unit cases, both packages -----------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_top_n_excludes_and_orders(pkg):
    m = build_model(PACKAGES[pkg][0])
    res = m.top_n(np.asarray([1.0, 0.0], dtype=np.float32), 2)
    assert [r[0] for r in res] == ["I0", "I2"]
    res2 = m.top_n(np.asarray([1.0, 0.0], dtype=np.float32), 2, exclude={"I0"})
    assert [r[0] for r in res2] == ["I2", "I3"]


def test_top_n_values_identical_across_packages():
    # no exact ties: the two packages' vector stores may pack ids in
    # another order, and a tie goes to the lower packed row
    q = np.asarray([0.6, 0.8], dtype=np.float32)
    got = build_model(tsm).top_n(q, 4, exclude={"I1"})
    want = build_model(jsm).top_n(q, 4, exclude={"I1"})
    assert got == want and len(got) == 3


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_top_n_reflects_updates_after_refresh(pkg):
    m = build_model(PACKAGES[pkg][0])
    m.top_n(np.asarray([1.0, 0.0], dtype=np.float32), 1)
    m.set_item_vector("I9", np.asarray([5.0, 0.0], dtype=np.float32))
    assert m.top_n(np.asarray([1.0, 0.0], dtype=np.float32), 1)[0][0] == "I9"


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_fraction_loaded_against_expected(pkg):
    m = PACKAGES[pkg][0].ALSServingModel(2, True)
    m.set_expected({"U0", "U1"}, {"I0", "I1"})
    assert m.get_fraction_loaded() == 0.0
    m.set_user_vector("U0", np.zeros(2, dtype=np.float32))
    m.set_item_vector("I0", np.zeros(2, dtype=np.float32))
    assert m.get_fraction_loaded() == pytest.approx(0.5)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_yty_solver_invalidated_on_write(pkg):
    m = build_model(PACKAGES[pkg][0])
    s1 = m.get_yty_solver()
    assert m.get_yty_solver() is s1
    m.set_item_vector("I5", np.asarray([0.3, 0.3], dtype=np.float32))
    assert m.get_yty_solver() is not s1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_manager_consume_and_known_items(pkg):
    sm = PACKAGES[pkg][0]
    mgr = sm.ALSServingModelManager(serving_config(pkg, "inproc://unused1"))
    km = KeyMessage if pkg == "torch" else JaxKeyMessage
    mgr.consume(iter([
        km("MODEL", model_message(pkg, ["U0"], ["I0"])),
        km("UP", join_json(["Y", "I0", [1.0, 0.0]])),
        km("UP", join_json(["X", "U0", [1.0, 0.0], ["I0"]])),
    ]))
    model = mgr.get_model()
    assert model.get_fraction_loaded() == 1.0
    assert model.get_known_items("U0") == {"I0"}
    mgr.close()


# -- HTTP: both serving layers, same messages --------------------------------


def http(method, url, body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _start(pkg, broker_loc, items, users, known, features, extra=""):
    *_, bus, layer_cls, _ = PACKAGES[pkg]
    broker = bus.get_broker(broker_loc)
    layer = layer_cls(serving_config(pkg, broker_loc, extra))
    layer.start()
    with broker.producer("OryxUpdate") as p:
        p.send("MODEL", model_message(pkg, list(users), list(items), features))
        for i, v in items.items():
            p.send("UP", join_json(["Y", i, [float(x) for x in v]]))
        for u, v in users.items():
            p.send("UP", join_json(["X", u, [float(x) for x in v], known.get(u, [])]))
    base = f"http://127.0.0.1:{layer.port}"
    deadline = time.monotonic() + 20
    while http("GET", f"{base}/ready")[0] != 200:
        assert time.monotonic() < deadline, f"{pkg} layer never became ready"
        time.sleep(0.05)
    # let the serving model's refresh window elapse so Y is current
    time.sleep(0.3)
    return layer, base, broker


@pytest.fixture(scope="module")
def servers():
    port_device.set_device("cpu")
    started = {
        pkg: _start(pkg, f"inproc://als-serve-{pkg}", ITEM_VECS, USER_VECS, KNOWN, 2)
        for pkg in PACKAGES
    }
    yield {pkg: (base, broker) for pkg, (_, base, broker) in started.items()}
    for layer, _, _ in started.values():
        layer.close()
    port_device.set_device(None)


# every GET of the reference's HTTP cases; bodies must match byte for byte
GET_CASES = [
    ("/recommend/U0", "application/json"),
    ("/recommend/U0?considerKnownItems=true&howMany=2", "application/json"),
    ("/recommend/U0?howMany=1&offset=1", "application/json"),
    ("/recommend/NOPE", "application/json"),
    ("/recommend/U0", "text/csv"),
    ("/recommendToMany/U0/U1", "application/json"),
    ("/recommendToAnonymous/I0=2.0/I2", "application/json"),
    ("/recommendToAnonymous/NOPE", "application/json"),
    ("/similarity/I0/I1", "application/json"),
    ("/similarityToItem/I0/I2/I1", "application/json"),
    ("/estimate/U0/I0/I1/I2", "application/json"),
    ("/estimateForAnonymous/I2/I0=1.0", "application/json"),
    ("/because/U1/I3", "application/json"),
    ("/knownItems/U1", "application/json"),
    ("/mostSurprising/U1", "application/json"),
    ("/mostActiveUsers", "application/json"),
    ("/mostPopularItems", "application/json"),
    ("/item/allIDs", "application/json"),
    ("/user/allIDs", "application/json"),
    ("/ready", "application/json"),
]


@pytest.mark.parametrize("path,accept", GET_CASES)
def test_get_bodies_identical(servers, path, accept):
    got = http("GET", servers["torch"][0] + path, headers={"Accept": accept})
    want = http("GET", servers["jax"][0] + path, headers={"Accept": accept})
    assert got[0] == want[0]
    assert got[2].get("Content-Type") == want[2].get("Content-Type")
    if got[0] == 200:
        assert got[1] == want[1]


def test_recommend_semantics(servers):
    """The reference's own assertions, on the port."""
    base = servers["torch"][0]
    recs = json.loads(http("GET", base + "/recommend/U0")[1])
    ids = [r["id"] for r in recs]
    assert "I0" not in ids and ids[0] == "I2"
    status, body, headers = http("GET", base + "/recommend/U0", headers={"Accept": "text/csv"})
    assert headers["Content-Type"] == "text/csv"
    assert body.decode().splitlines()[0].split(",")[0] == "I2"
    sims = json.loads(http("GET", base + "/similarity/I0/I1")[1])
    assert sims[0]["id"] == "I3"
    vals = json.loads(http("GET", base + "/estimate/U0/I0/I1/I2")[1])
    assert vals[0] == pytest.approx(1.0, abs=1e-5) and vals[1] == pytest.approx(0.0, abs=1e-5)
    rep = http("GET", base + "/popularRepresentativeItems")
    assert rep[0] == 200 and json.loads(rep[1])


def _input_messages(broker, send):
    tail = broker.consumer("OryxInput", from_beginning=True)
    seen = {m.message for m in tail.poll(max_records=100, timeout=0.2)}
    send()
    msgs = []
    deadline = time.monotonic() + 5
    while len(msgs) < 4 and time.monotonic() < deadline:
        msgs += [m.message for m in tail.poll(max_records=100, timeout=0.2)
                 if m.message not in seen]
    tail.close()
    return sorted(msgs)


def test_pref_and_ingest_write_the_same_input(servers):
    def writes(base):
        def send():
            assert http("POST", f"{base}/pref/U0/I1", body=b"2.5")[0] == 204
            assert http("DELETE", f"{base}/pref/U0/I0")[0] == 204
            assert http("POST", f"{base}/ingest", body=b"U9,I9,1.0\nU8,I8,2.0\n")[0] == 204
        return send

    got = _input_messages(servers["torch"][1], writes(servers["torch"][0]))
    want = _input_messages(servers["jax"][1], writes(servers["jax"][0]))
    assert got == want == ["U0,I0,", "U0,I1,2.5", "U8,I8,2.0", "U9,I9,1.0"]
    assert http("POST", servers["torch"][0] + "/pref/U0/I1", body=b"abc")[0] == 400


# -- a seeded random model ----------------------------------------------------


@pytest.fixture(scope="module")
def random_servers():
    port_device.set_device("cpu")
    gen = np.random.default_rng(21)
    items = {f"i{j}": v for j, v in enumerate(gen.standard_normal((5000, 16), dtype=np.float32))}
    users = {f"u{j}": v for j, v in enumerate(gen.standard_normal((64, 16), dtype=np.float32))}
    known = {f"u{j}": [f"i{j}", f"i{j + 1}"] for j in range(0, 64, 3)}
    started = {
        pkg: _start(pkg, f"inproc://als-random-{pkg}", items, users, known, 16)
        for pkg in PACKAGES
    }
    yield {pkg: base for pkg, (_, base, _) in started.items()}
    for layer, _, _ in started.values():
        layer.close()
    port_device.set_device(None)


@pytest.mark.parametrize("path", [
    "/recommend/u{u}?howMany=20",
    "/recommend/u{u}?howMany=5&considerKnownItems=true",
    "/recommendToAnonymous/i{u}=1.5/i7?howMany=10",
    "/similarity/i{u}?howMany=10",
])
def test_random_model_answers_agree(random_servers, path):
    for u in (0, 3, 17, 63):
        got = json.loads(http("GET", random_servers["torch"] + path.format(u=u))[1])
        want = json.loads(http("GET", random_servers["jax"] + path.format(u=u))[1])
        assert [r["id"] for r in got] == [r["id"] for r in want]
        np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want],
                                   rtol=1e-5)


def test_random_model_concurrent_recommends_agree(random_servers):
    """Concurrent requests coalesce in the batcher and still answer each
    user exactly as the JAX package does."""
    from concurrent.futures import ThreadPoolExecutor

    paths = [f"/recommend/u{u}?howMany=10" for u in range(64)]
    with ThreadPoolExecutor(16) as pool:
        got = list(pool.map(lambda p: http("GET", random_servers["torch"] + p), paths))
    for p, (status, body, _) in zip(paths, got):
        assert status == 200
        want = json.loads(http("GET", random_servers["jax"] + p)[1])
        assert [r["id"] for r in json.loads(body)] == [r["id"] for r in want]


# -- index submit and freshness (port) ---------------------------------------


def test_top_n_for_user_index_submit_and_freshness(monkeypatch):
    calls = {"indexed": 0, "vector": 0}
    orig_i, orig_v = tsm.score_indexed_default, tsm.score_default

    def indexed(*a, **k):
        calls["indexed"] += 1
        return orig_i(*a, **k)

    def vector(*a, **k):
        calls["vector"] += 1
        return orig_v(*a, **k)

    monkeypatch.setattr(tsm, "score_indexed_default", indexed)
    monkeypatch.setattr(tsm, "score_default", vector)
    gen = np.random.default_rng(2)
    m = tsm.ALSServingModel(4, True, refresh_sec=0.0)
    m.set_user_vectors([f"u{i}" for i in range(20)], gen.standard_normal((20, 4)).astype(np.float32))
    m.set_item_vectors([f"i{i}" for i in range(50)], gen.standard_normal((50, 4)).astype(np.float32))
    # the first request starts the background restage and takes the vector path
    m.top_n_for_user("u3", 5)
    assert calls == {"indexed": 0, "vector": 1}
    m._x_restage_thread.join(30)
    r_idx = m.top_n_for_user("u3", 5)
    assert calls == {"indexed": 1, "vector": 1}
    r_vec = m.top_n(m.get_user_vector("u3"), 5)
    assert [i for i, _ in r_idx] == [i for i, _ in r_vec]
    np.testing.assert_allclose([v for _, v in r_idx], [v for _, v in r_vec], rtol=1e-5)
    assert m.top_n_for_user("nobody", 3) is None

    # a user updated after the last X refresh must not be served stale
    m2 = tsm.ALSServingModel(4, True, refresh_sec=999.0)
    m2.set_user_vectors([f"u{i}" for i in range(5)], gen.standard_normal((5, 4)).astype(np.float32))
    m2.set_item_vectors([f"i{i}" for i in range(9)], gen.standard_normal((9, 4)).astype(np.float32))
    m2.top_n_for_user("u1", 3)
    m2._x_restage_thread.join(30)
    base = dict(calls)
    fresh_vec = gen.standard_normal(4).astype(np.float32)
    m2.set_user_vector("u1", fresh_vec)
    r_after = m2.top_n_for_user("u1", 3)
    assert calls["vector"] == base["vector"] + 1
    assert [i for i, _ in r_after] == [i for i, _ in m2.top_n(fresh_vec, 3)]
    m2.top_n_for_user("u2", 3)  # an untouched user still rides the staged matrix
    assert calls["indexed"] == base["indexed"] + 1
    m.close()
    m2.close()


def test_first_request_builds_on_a_freshly_booted_host(monkeypatch):
    """A monotonic clock that reads below refresh_sec (a host up for less
    than it) must not hold back the first card build: refresh_sec only
    throttles rebuilds."""
    real_monotonic = time.monotonic
    offset = real_monotonic() - 5.0
    monkeypatch.setattr(tsm.time, "monotonic", lambda: real_monotonic() - offset)
    assert tsm.time.monotonic() < 6.0
    calls = {"indexed": 0}
    orig = tsm.score_indexed_default

    def indexed(*a, **k):
        calls["indexed"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tsm, "score_indexed_default", indexed)
    gen = np.random.default_rng(3)
    m = tsm.ALSServingModel(4, True, refresh_sec=999.0)
    try:
        m.set_user_vectors([f"u{i}" for i in range(5)], gen.standard_normal((5, 4)).astype(np.float32))
        m.set_item_vectors([f"i{i}" for i in range(9)], gen.standard_normal((9, 4)).astype(np.float32))
        first = m.top_n_for_user("u1", 3)
        assert first  # not [] for the first refresh_sec after boot
        assert m._x_restage_thread is not None
        m._x_restage_thread.join(30)
        assert not m._x_restage_thread.is_alive()
        assert m.top_n_for_user("u2", 3)
        assert calls["indexed"] == 1  # the staged user matrix serves it
    finally:
        m.close()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_index_and_vector_paths_agree_with_jax(dtype):
    """Both packages' models, same factors: index-submitted answers equal
    the JAX package's (float32 exactly in order; int8 against the JAX
    vector path, whose scan the port's two-plane rescore reproduces)."""
    gen = np.random.default_rng(5)
    xs = gen.standard_normal((30, 8), dtype=np.float32)
    ys = gen.standard_normal((400, 8), dtype=np.float32)
    models = {}
    for pkg in PACKAGES:
        m = PACKAGES[pkg][0].ALSServingModel(8, True, refresh_sec=0.0, score_dtype="float32")
        m.set_user_vectors([f"u{i}" for i in range(30)], xs)
        m.set_item_vectors([f"i{i}" for i in range(400)], ys)
        models[pkg] = m
    port = tsm.ALSServingModel(8, True, refresh_sec=0.0, score_dtype=dtype)
    port.set_user_vectors([f"u{i}" for i in range(30)], xs)
    port.set_item_vectors([f"i{i}" for i in range(400)], ys)
    port.top_n_for_user("u0", 10)
    port._x_restage_thread.join(30)
    for u in ("u1", "u9", "u29"):
        got = port.top_n_for_user(u, 10)
        want = models["jax"].top_n_for_user(u, 10)
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                                   rtol=1e-5 if dtype == "float32" else 2.0**-8, atol=1e-6)
    for m in (*models.values(), port):
        m.close()


# -- what is not ported yet raises -------------------------------------------


@pytest.mark.parametrize("extra", [
    "als.serving.shard-items = true",
])
def test_unported_settings_raise(extra):
    with pytest.raises(tsm.NotYetPortedError):
        tsm.ALSServingModelManager(serving_config("torch", "inproc://unused2", extra))


def test_compile_cache_dir_is_refused_as_the_batch_layer_refuses_it(tmp_path):
    """``oryx.compute.compile-cache-dir`` names the JAX package's XLA cache,
    which the port does not have: the serving layer refuses it, as the
    batch layer does, rather than serve without it."""
    from oryx_tpu_torch.lambda_.batch import BatchLayer

    extra = f'compute.compile-cache-dir = "{tmp_path}/cache"'
    with pytest.raises(tsm.NotYetPortedError, match="compile-cache-dir"):
        ServingLayer(serving_config("torch", "inproc://compile-cache", extra))
    cfg = serving_config("torch", "inproc://compile-cache", extra).with_overlay(
        f'oryx.batch.storage {{ data-dir = "{tmp_path}/data/", model-dir = "{tmp_path}/model/" }}'
    )
    with pytest.raises(tsm.NotYetPortedError, match="compile-cache-dir"):
        BatchLayer(cfg)


def test_start_after_a_partial_start_raises_the_jax_packages_message():
    """A start() retried after one that left its HTTP thread behind (and
    nothing else) is refused, with the JAX package's message, before it
    could overwrite and leak the live thread."""
    import threading

    messages = {}
    for pkg in sorted(PACKAGES):
        layer = PACKAGES[pkg][5](serving_config(pkg, f"inproc://partial-{pkg}"))
        left = threading.Thread(target=lambda: None)
        layer._server_thread = left  # what a start() that raised later leaves
        try:
            with pytest.raises(RuntimeError, match="retried after a partial start") as e:
                layer.start()
            messages[pkg] = str(e.value)
            assert layer._server_thread is left
        finally:
            layer._server_thread = None
            layer.close()
    assert messages["torch"] == messages["jax"]


def test_lsh_sample_rate_serves_on_both_packages():
    """``als.sample-rate = 0.5``, once refused, starts on both packages:
    the model a MODEL record makes prunes with LSH, and /recommend answers
    the same ids."""
    from oryx_tpu.common import rng as jrng

    answers = {}
    for pkg in PACKAGES:
        (jrng if pkg == "jax" else trng).use_test_seed()  # the same hash vectors
        layer, base, _ = _start(pkg, f"inproc://lsh-{pkg}", ITEM_VECS, USER_VECS, KNOWN, 2,
                                extra="als.sample-rate = 0.5")
        try:
            assert layer.model_manager.get_model().lsh is not None
            status, body, _ = http("GET", f"{base}/recommend/U2?howMany=3")
            assert status == 200
            answers[pkg] = [r["id"] for r in json.loads(body)]
        finally:
            layer.close()
    assert answers["torch"] == answers["jax"] and answers["torch"]


def _construct(pkg, extra):
    """What constructing each package's layer with ``extra`` gives: "starts",
    or the error's type and message."""
    layer_cls = PACKAGES[pkg][5]
    try:
        layer = layer_cls(serving_config(pkg, f"inproc://tls-{pkg}", extra))
    except ValueError as e:
        return "ValueError", str(e)
    layer.close()
    return "starts", None


@pytest.mark.parametrize("key", [
    "keystore-file", "key-file", "keystore-password", "user-name", "password",
])
def test_tls_and_auth_settings_match_jax(key):
    """Each TLS or auth key alone, once refused by the port, has the JAX
    package's outcome: a key file without its pair and a user without a
    password are ValueErrors, a lone password or keystore password starts."""
    extra = f'serving.api.{key} = "secret"'
    got = _construct("torch", extra)
    assert got == _construct("jax", extra)
    want = "starts" if key in ("keystore-password", "password") else "ValueError"
    assert got[0] == want


def _tenant_layer(pkg, broker_loc, enabled):
    """A layer whose config declares one ALS tenant, ``shop``, fed the
    hand-built model on the tenant's update topic when tenancy is on (on
    the shared one otherwise)."""
    *_, bus, layer_cls, name = PACKAGES[pkg]
    tenants = (
        "tenancy { enabled = %s, tenants { shop { app = \"als\", weight = 2.0 } } }"
        % ("true" if enabled else "false")
    )
    layer = layer_cls(serving_config(pkg, broker_loc, tenants))
    layer.start()
    topic = "OryxUpdate.shop" if enabled else "OryxUpdate"
    broker = bus.get_broker(broker_loc)
    broker.create_topic(topic, 1)
    with broker.producer(topic) as p:
        p.send("MODEL", model_message(pkg, list(USER_VECS), list(ITEM_VECS)))
        for i, v in ITEM_VECS.items():
            p.send("UP", join_json(["Y", i, v]))
        for u, v in USER_VECS.items():
            p.send("UP", join_json(["X", u, v, KNOWN.get(u, [])]))
    base = f"http://127.0.0.1:{layer.port}"
    deadline = time.monotonic() + 20
    while http("GET", f"{base}/ready")[0] != 200:
        assert time.monotonic() < deadline, f"{pkg} tenant layer never became ready"
        time.sleep(0.05)
    time.sleep(0.3)  # the serving model's refresh window
    return layer, base


def test_declared_tenants_start_and_serve():
    """A config that declares an enabled ALS tenant starts the port's
    layer and serves the tenant under ``/t/shop/`` exactly as the JAX
    package does (the answers, the tenant's live generation on /healthz,
    404 for an undeclared tenant); the same block left disabled is
    ignored by both packages, which serve untenanted."""
    bodies = {}
    for pkg in sorted(PACKAGES):
        for enabled in (True, False):
            layer, base = _tenant_layer(pkg, f"inproc://tenants-{pkg}-{enabled}", enabled)
            try:
                prefix = "/t/shop" if enabled else ""
                status, body, _ = http("GET", f"{base}{prefix}/recommend/U0?howMany=3")
                assert status == 200, (pkg, enabled, body)
                bodies[pkg, enabled] = body
                health = json.loads(http("GET", f"{base}/healthz")[1])
                if enabled:
                    assert sorted(health["tenants"]) == ["shop"]
                    assert http("GET", f"{base}/t/nope/recommend/U0")[0] == 404
                    # the default tenant is unset: an untenanted data-plane
                    # request finds no model
                    assert http("GET", f"{base}/recommend/U0")[0] == 503
                else:
                    assert "tenants" not in health
                    assert layer.tenants is None
            finally:
                layer.close()
    assert bodies["torch", True] == bodies["jax", True] == bodies["torch", False]


def test_ab_fraction_starts_and_serves(tmp_path):
    """A config that splits traffic to a challenger
    (``oryx.serving.ab.fraction = 0.1``) starts the port's layer with an
    experiment coordinator when a model dir is set, and without one when
    it is unset, as the JAX package does; /recommend is served either way
    and GET /experiments reports the split (no challenger yet: inactive)."""
    reports = {}
    for pkg in sorted(PACKAGES):
        for with_registry in (True, False):
            model_dir = (
                f'batch.storage.model-dir = "{tmp_path}/{pkg}/model/"'
                if with_registry
                else "batch.storage.model-dir = null"
            )
            extra = "serving.ab.fraction = 0.1\n" + model_dir
            *_, layer_cls, _ = PACKAGES[pkg]
            broker_loc = f"inproc://ab-{pkg}-{with_registry}"
            layer, base, _ = _start(pkg, broker_loc, ITEM_VECS, USER_VECS, KNOWN, 2, extra)
            try:
                assert (layer.experiments is not None) == with_registry
                status, body, headers = http("GET", f"{base}/recommend/U0")
                assert status == 200
                # no challenger: no arm is assigned, no header stamped
                assert "X-Oryx-Experiment-Arm" not in headers
                report = json.loads(http("GET", f"{base}/experiments")[1])
                reports[pkg, with_registry] = report
            finally:
                layer.close()
    for with_registry in (True, False):
        got, want = reports["torch", with_registry], reports["jax", with_registry]
        assert got.keys() == want.keys()
        if with_registry:
            assert got["enabled"] and got["fraction"] == 0.1 and not got["active"]
            assert got["online_gate"] == want["online_gate"]
        else:
            assert got == want == {"enabled": False, "active": False}


def test_batcher_queue_bound_raises_past_it():
    """TopNBatcher(max_queue=...) as tests/serving/test_overload.py holds
    the JAX package's: past the bound an entry raises at once, counted,
    and is no closed-batcher retry."""
    from oryx_tpu_torch.common import metrics
    from oryx_tpu_torch.serving.batcher import (
        BatcherClosedError,
        BatcherOverloadedError,
        TopNBatcher,
    )

    rejected = metrics.registry.counter("serving.batcher.queue.rejected")
    before = rejected.value
    b = TopNBatcher(max_queue=0)  # every enqueue is over the bound
    try:
        with pytest.raises(BatcherOverloadedError, match="full"):
            b.score(None, np.zeros(4, dtype=np.float32), 3)
    finally:
        b.close()
    assert rejected.value == before + 1
    assert not issubclass(BatcherOverloadedError, BatcherClosedError)


def test_max_queue_default_reaches_the_batcher(monkeypatch):
    from oryx_tpu_torch.serving import batcher

    monkeypatch.setattr(batcher, "_default_init", {})
    ServingLayer(serving_config("torch", "inproc://unused8"))
    assert batcher._default_init["max_queue"] == 2048


def test_full_batcher_queue_answers_429(monkeypatch):
    """oryx.serving.overload.max-queue bounds the serving batcher: a
    /recommend that finds the queue full is shed at once with 429 and
    Retry-After, as the JAX package's layer answers."""
    from oryx_tpu_torch.serving import batcher

    # a process-wide batcher of this layer's own, built with its bound
    monkeypatch.setattr(batcher, "_default", None)
    monkeypatch.setattr(batcher, "_default_refs", 0)
    monkeypatch.setattr(batcher, "_default_init", {})
    layer, base, _ = _start("torch", "inproc://overload", ITEM_VECS, USER_VECS, KNOWN, 2,
                            extra="serving.overload.max-queue = 0")
    try:
        status, body, headers = http("GET", f"{base}/recommend/U0")
        assert status == 429
        assert headers["Retry-After"] == "1"
        assert json.loads(body) == {"error": "overloaded", "retry_after_s": 1}
        assert http("GET", f"{base}/ready")[0] == 200  # the rest still answers
    finally:
        layer.close()


def test_kafka_locator_without_kafka_python_raises():
    # every bus locator resolves to a port broker; kafka:// needs the
    # optional kafka-python, and without it raises the JAX package's error
    try:
        import kafka  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("kafka-python installed; absence path not testable")
    with pytest.raises(RuntimeError, match="kafka-python"):
        tbus.get_broker("kafka://localhost:1")


def test_layer_refuses_jax_package_classes():
    cfg = serving_config("jax", "inproc://unused4")
    with pytest.raises(ValueError, match="oryx_tpu_torch"):
        ServingLayer(tconfig.get_default().with_overlay(cfg.serialize()))


def test_cli_serving_config_layers(tmp_path, monkeypatch):
    from oryx_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    conf = tmp_path / "my.conf"
    conf.write_text("oryx.serving.api.port = 9191\n")
    monkeypatch.delenv("ORYX_CONF", raising=False)
    cfg = cli.load_config(str(conf), ["oryx.als.serving.score-dtype=int8"])
    assert cfg.get_int("oryx.serving.api.port") == 9191
    assert cfg.get_string("oryx.als.serving.score-dtype") == "int8"
    assert cli._build_parser().parse_args(["serving", "--conf", str(conf)]).command == "serving"
