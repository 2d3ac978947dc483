"""The port's tenancy (oryx_tpu_torch/tenancy, the batcher's fair queue,
the serving layer's tenant wiring) against the JAX package's, on the CPU.

- ``TenantRegistry`` and ``tenant_config`` parse the same HOCON into the
  same identities: ids, weights, knobs, namespaced topics, dirs, ids and
  restage dirs, the same class names less the package prefix.
- ``_FairQueue``: tests/tenancy/test_drr.py's seven cases, each one case
  of a parametrised test that feeds both packages' queues the same entry
  sequence and requires the same dequeue order (exact: the order is
  integer arithmetic on credits).
- tests/tenancy/test_pipelines.py's three apps on one fleet, on both
  packages from the same seeded lines and test seeds (k-means with random
  initialisation, whose draws both packages take from one numpy stream):
  the same /assign and /predict answers (exact), and ALS top-10 lists
  (known items considered) that agree within the factor bar of
  tests/test_torch_als_app.py (rtol 2e-2, atol 2e-3): equal values
  within it, and an id may change place only with one whose score is
  within it.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.common import metrics as jmetrics
from oryx_tpu.common import rng as jrng
from oryx_tpu.serving import batcher as jbatcher
from oryx_tpu.serving.layer import ServingLayer as JaxServingLayer
from oryx_tpu.tenancy import TenantRegistry as JaxTenantRegistry
from oryx_tpu.tenancy import tenant_config as jax_tenant_config
from oryx_tpu.tenancy.pipelines import TenantPipelines as JaxTenantPipelines
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import metrics as tmetrics
from oryx_tpu_torch.common import rng as trng
from oryx_tpu_torch.serving import batcher as tbatcher
from oryx_tpu_torch.serving.layer import ServingLayer
from oryx_tpu_torch.tenancy import TenantRegistry, TenantSpec, tenant_config
from oryx_tpu_torch.tenancy.context import tenant_scope
from oryx_tpu_torch.tenancy.mux import TenantInputMux, TenantServingMux
from oryx_tpu_torch.tenancy.pipelines import TenantPipelines

FACTORS = dict(rtol=2e-2, atol=2e-3)  # tests/test_torch_als_app.py's bar

PACKAGES = {
    "jax": (jconfig, JaxTenantRegistry, jax_tenant_config, JaxTenantPipelines,
            JaxServingLayer, jmetrics, "oryx_tpu"),
    "torch": (tconfig, TenantRegistry, tenant_config, TenantPipelines,
              ServingLayer, tmetrics, "oryx_tpu_torch"),
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    trng.use_test_seed()
    jrng.use_test_seed()
    yield
    trng.clear_test_seed()
    jrng.clear_test_seed()
    port_device.set_device(None)
    InProcessBroker.reset_all()


# -- TenantRegistry / tenant_config ------------------------------------------------

SPEC_BLOCKS = {
    "three-apps": """
        tenants = {
          movies  = { app = als, weight = 2 }
          sensors = { app = kmeans, slo = { p99-ms = 250 } }
          churn   = { app = rdf, quota-qps = 50 }
        }
    """,
    "default-and-knobs": """
        default-tenant = movies
        fair-share = { enabled = false, quantum = 3 }
        tenants = {
          movies = { app = als, weight = 0.5, input-topic = "SharedIn" }
          probe  = { app = probe, update-topic = "ProbeUp", registry-root = "/r/probe" }
        }
    """,
    "overlay": """
        tenants = {
          t = { app = kmeans, config { oryx { input-schema { num-features = 2 }
                                               kmeans.hyperparams.k = 7 } } }
        }
    """,
}


def spec_config(pkg: str, block: str, oryx_id: str | None):
    C = PACKAGES[pkg][0]
    ident = f'oryx.id = "{oryx_id}"' if oryx_id else ""
    return C.get_default().with_overlay(
        f"""
        {ident}
        oryx.serving.restage-dir = "/stage/"
        oryx.tenancy = {{
          enabled = true
          {block}
        }}
        """
    )


def identity(pkg, cfg, spec) -> dict:
    """What tenant_config derives for one tenant, with the package prefix
    of class names taken off."""
    tcfg = PACKAGES[pkg][2](cfg, spec)
    prefix = PACKAGES[pkg][6] + "."

    def strip(v):
        if isinstance(v, str) and v.startswith(prefix):
            return v[len(prefix):]
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v

    keys = (
        "oryx.id", "oryx.input-topic.message.topic", "oryx.update-topic.message.topic",
        "oryx.batch.storage.data-dir", "oryx.batch.storage.model-dir",
        "oryx.batch.update-class", "oryx.speed.model-manager-class",
        "oryx.serving.model-manager-class", "oryx.serving.application-resources",
        "oryx.serving.restage-dir", "oryx.input-schema.num-features",
        "oryx.kmeans.hyperparams.k",
    )
    return {k: strip(tcfg.get(k, None)) for k in keys}


@pytest.mark.parametrize("oryx_id", [None, "Prod"])
@pytest.mark.parametrize("case", sorted(SPEC_BLOCKS))
def test_registry_and_tenant_config_match_jax(case, oryx_id):
    regs = {pkg: PACKAGES[pkg][1].from_config(spec_config(pkg, SPEC_BLOCKS[case], oryx_id))
            for pkg in PACKAGES}
    got, want = regs["torch"], regs["jax"]
    assert got.ids() == want.ids()
    assert got.weights() == want.weights()
    assert (got.default_tenant, got.fair_share, got.quantum) == (
        want.default_tenant, want.fair_share, want.quantum)
    assert [m.replace("oryx_tpu_torch.", "") for m in got.resource_modules()] == [
        m.replace("oryx_tpu.", "") for m in want.resource_modules()]
    for tid in got.ids():
        gs, ws = got.require(tid), want.require(tid)
        for field in ("app", "weight", "quota_qps", "slo_p99_ms", "slo_error_rate",
                      "slo_min_full_quality", "input_topic", "update_topic", "registry_root"):
            assert getattr(gs, field) == getattr(ws, field), (tid, field)
        gi = identity("torch", spec_config("torch", SPEC_BLOCKS[case], oryx_id), gs)
        wi = identity("jax", spec_config("jax", SPEC_BLOCKS[case], oryx_id), ws)
        assert gi == wi, tid
        assert gi["oryx.serving.restage-dir"] == f"/stage/{tid}"


def test_disabled_or_empty_tenancy_is_none_in_both():
    for pkg in PACKAGES:
        C, Reg = PACKAGES[pkg][:2]
        assert Reg.from_config(C.get_default()) is None
        assert Reg.from_config(
            C.get_default().with_overlay("oryx.tenancy { enabled = true, tenants = {} }")
        ) is None


@pytest.mark.parametrize("kwargs, match", [
    (dict(tenant_id="a.b", app="als"), "invalid tenant id"),
    (dict(tenant_id="a/b", app="als"), "invalid tenant id"),
    (dict(tenant_id="ok", app="resnet"), "unknown app"),
    (dict(tenant_id="ok", app="als", weight=0), "weight"),
])
def test_invalid_specs_raise_in_both(kwargs, match):
    from oryx_tpu.tenancy import TenantSpec as JaxTenantSpec

    for cls in (TenantSpec, JaxTenantSpec):
        with pytest.raises(ValueError, match=match):
            cls(**kwargs)


def test_tenant_naming_a_jax_class_is_refused():
    """A tenant block's class override under ``oryx_tpu`` would load the
    JAX package into the port's process: refused at parse time."""
    cfg = tconfig.get_default().with_overlay(
        """oryx.tenancy { enabled = true, tenants { m { app = als,
           serving-manager = "oryx_tpu.app.als.serving_model.ALSServingModelManager" } } }"""
    )
    with pytest.raises(ValueError, match="names the JAX package"):
        TenantRegistry.from_config(cfg)


# -- the batcher's DRR queue: tests/tenancy/test_drr.py's cases --------------------


def _entry(mod, tenant=None):
    e = mod._Entry(uploaded=None, query=None, k=1, cosine=False)
    e.tenant = tenant
    return e


def _drain(q, n):
    return [q.get_nowait().tenant for _ in range(n)]


def drr_untenanted_fifo(mod):
    q = mod._FairQueue()
    entries = [_entry(mod) for _ in range(5)]
    for e in entries:
        q.put(e)
    order = [entries.index(q.get_nowait()) for _ in range(5)]
    try:
        q.get_nowait()
        empty = False
    except Exception:
        empty = True
    assert order == [0, 1, 2, 3, 4] and empty
    return order


def drr_sentinel_drains_then_stops(mod):
    q = mod._FairQueue()
    q.put(_entry(mod, "a"))
    q.put(None)
    q.put(_entry(mod, "b"))
    got = [q.get_nowait().tenant, q.get_nowait().tenant]
    assert set(got) == {"a", "b"}
    assert q.get_nowait() is None and q.get(timeout=0.1) is None
    return got


def drr_qsize_and_depths(mod):
    q = mod._FairQueue()
    for t in ("a", "a", "b", None):
        q.put(_entry(mod, t))
    assert q.qsize() == 4 and q.depth("a") == 2 and q.depth("b") == 1
    assert q.tenant_depths() == {"a": 2, "b": 1}
    return [q.qsize(), q.tenant_depths()]


def drr_equal_weights_under_skew(mod):
    q = mod._FairQueue(weights={"noisy": 1.0, "victim": 1.0}, quantum=8)
    for _ in range(1000):
        q.put(_entry(mod, "noisy"))
    for _ in range(10):
        q.put(_entry(mod, "victim"))
    order = _drain(q, 200)
    assert order.count("victim") == 10
    assert max(i for i, t in enumerate(order) if t == "victim") < 40
    return order


def drr_weights_skew_ratio(mod):
    q = mod._FairQueue(weights={"gold": 3.0, "bronze": 1.0}, quantum=8)
    for _ in range(600):
        q.put(_entry(mod, "gold"))
        q.put(_entry(mod, "bronze"))
    order = _drain(q, 400)
    assert order.count("gold") / order.count("bronze") == pytest.approx(3.0, rel=0.15)
    return order


def drr_idle_tenant_costs_nothing(mod):
    q = mod._FairQueue(weights={"a": 1.0, "idle": 100.0}, quantum=8)
    for _ in range(20):
        q.put(_entry(mod, "a"))
    order = _drain(q, 20)
    assert order == ["a"] * 20
    return order


def drr_share_limit_and_over_share(mod):
    q = mod._FairQueue(weights={"a": 1.0, "b": 3.0}, quantum=8)
    trace = [q.share_limit("a", 100), q.share_limit("b", 100)]
    for _ in range(30):
        q.put(_entry(mod, "a"))
    trace.append(q.over_share("a", 100))
    q.put(_entry(mod, "b"))
    trace += [q.over_share("a", 100), q.over_share("b", 100)]
    assert trace == [25, 75, False, True, False]
    return trace


DRR_CASES = {f.__name__: f for f in (
    drr_untenanted_fifo, drr_sentinel_drains_then_stops, drr_qsize_and_depths,
    drr_equal_weights_under_skew, drr_weights_skew_ratio, drr_idle_tenant_costs_nothing,
    drr_share_limit_and_over_share,
)}


@pytest.mark.parametrize("case", sorted(DRR_CASES))
def test_fair_queue_matches_jax(case):
    assert DRR_CASES[case](tbatcher) == DRR_CASES[case](jbatcher)


def test_batcher_snapshots_the_tenant_at_enqueue():
    """The request thread's tenant rides the entry to the dispatcher: with
    the queue bounded, a tenant holding its weighted share while another
    tenant queues is refused at once, as in the JAX package."""
    queue_ = tbatcher._FairQueue(weights={"a": 1.0, "b": 1.0})
    b = tbatcher.TopNBatcher(max_queue=4, tenant_weights={"a": 1.0, "b": 1.0})
    drained = b._queue  # the dispatcher waits on this one
    try:
        b._queue = queue_  # a queue nobody drains: entries stay put
        queue_.put(_entry(tbatcher, "b"))
        queue_.put(_entry(tbatcher, "a"))
        queue_.put(_entry(tbatcher, "a"))
        rejected = tmetrics.registry.counter("serving.batcher.queue.rejected.tenant.a")
        before = rejected.value
        with tenant_scope("a"), pytest.raises(tbatcher.BatcherOverloadedError,
                                              match="tenant a over fair queue share"):
            b.score(None, np.zeros(2, dtype=np.float32), 1)
        assert rejected.value == before + 1
    finally:
        b._queue = drained
        b.close()


def test_fairness_and_depths_reach_the_default_batcher():
    tbatcher.close_default_batcher()
    tbatcher.configure_fairness({"x": 2.0, "y": 1.0}, quantum=4)
    try:
        b = tbatcher.get_default_batcher()
        assert b._queue._weights == {"x": 2.0, "y": 1.0} and b._queue._quantum == 4
        assert tbatcher.default_tenant_depths() == {}
    finally:
        tbatcher.close_default_batcher()
        tbatcher.configure_fairness(None)


# -- the mux -----------------------------------------------------------------------


class _Manager:
    def __init__(self, model):
        self.model = model
        self.closed = False

    def get_model(self):
        return self.model

    def close(self):
        self.closed = True

    def helper(self):
        return f"helper of {self.model}"


class _Producer:
    def __init__(self):
        self.sent = []

    def send(self, key, value):
        self.sent.append((key, value))

    def close(self):
        pass


def test_mux_resolves_the_tenant_in_scope():
    from oryx_tpu_torch.tenancy.mux import TenantRuntime

    class _Health:
        def __init__(self, gen):
            self.live_generation = gen

    spec = TenantSpec(tenant_id="a", app="als")
    rts = {
        tid: TenantRuntime(TenantSpec(tenant_id=tid, app="als"), None, _Manager(f"m-{tid}"),
                           _Health(f"g-{tid}"), None)
        for tid in ("a", "b")
    }
    assert spec.tenant_id == "a"
    mux = TenantServingMux(rts, default_tenant="a")
    assert mux.get_model() == "m-a"  # the default tenant
    with tenant_scope("b"):
        assert mux.get_model() == "m-b"
        assert mux.helper() == "helper of m-b"  # forwarded to the tenant's manager
    assert mux.tenant_models() == {"a": "m-a", "b": "m-b"}
    assert mux.live_generations() == {"a": "g-a", "b": "g-b"}
    with pytest.raises(AttributeError, match="no tenant in scope"):
        TenantServingMux(rts).helper()
    mux.close()
    assert all(rt.manager.closed for rt in rts.values())

    producers = {"a": _Producer(), "b": _Producer()}
    inputs = TenantInputMux(producers)
    with tenant_scope("b"):
        inputs.send(None, "line")
    assert producers["b"].sent == [(None, "line")] and not producers["a"].sent
    with pytest.raises(RuntimeError, match="no tenant in scope"):
        inputs.send(None, "x")
    with tenant_scope("zz"), pytest.raises(RuntimeError, match="no input topic"):
        inputs.send(None, "x")


# -- three apps on one fleet: tests/tenancy/test_pipelines.py on both packages -------


def fleet_config(pkg, tmp_path, broker_loc):
    C = PACKAGES[pkg][0]
    return C.get_default().with_overlay(
        f"""
        oryx {{
          id = "MT"
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          batch {{
            streaming.generation-interval-sec = 3600
            storage {{ data-dir = "{tmp_path}/{pkg}/data/"
                      model-dir = "{tmp_path}/{pkg}/model/" }}
          }}
          serving.api.port = 0
          ml.eval {{ candidates = 1, test-fraction = 0 }}
          tenancy {{
            enabled = true
            tenants {{
              movies = {{
                app = als
                weight = 2
                config {{
                  oryx.als {{
                    implicit = true
                    iterations = 4
                    hyperparams {{ features = 4, lambda = 0.01, alpha = 2.0 }}
                  }}
                }}
              }}
              sensors = {{
                app = kmeans
                config {{
                  oryx {{
                    input-schema {{ num-features = 2
                                    numeric-features = ["0", "1"] }}
                    kmeans.hyperparams.k = 3
                    kmeans.initialization-strategy = "random"
                  }}
                }}
              }}
              churn = {{
                app = rdf
                config {{
                  oryx {{
                    input-schema {{ num-features = 3
                                    numeric-features = ["0", "1"]
                                    target-feature = "2" }}
                    rdf {{ num-trees = 5
                           hyperparams {{ max-depth = 4, impurity = "entropy" }} }}
                  }}
                }}
              }}
            }}
          }}
        }}
        """
    )


def http(method, url, body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def als_lines():
    gen = np.random.default_rng(0)
    lines, ts = [], 0
    for u in range(12):
        for i in range(8):
            if ((u < 6) == (i < 4)) or gen.random() < 0.2:
                ts += 1
                lines.append(f"u{u},i{i},{1.0 + 2.0 * gen.random():.2f},{ts}")
    return "\n".join(lines)


def kmeans_lines():
    gen = np.random.default_rng(4)
    lines = []
    for c in np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 10.0]]):
        for _ in range(40):
            p = c + 0.5 * gen.standard_normal(2)
            lines.append(f"{p[0]:.3f},{p[1]:.3f}")
    return "\n".join(lines)


def rdf_lines():
    gen = np.random.default_rng(8)
    lines = []
    for _ in range(150):
        x, y = float(gen.uniform(-5, 5)), float(gen.uniform(-5, 5))
        lines.append(f"{x:.3f},{y:.3f},{'pos' if x > 0 else 'neg'}")
    return "\n".join(lines)


ASSIGN_POINTS = ["0.1,0.2", "9.8,10.1", "-9.5,10.4", "0,5", "-4,8"]
PREDICT_ROWS = ["3.5,0.0,", "-3.5,0.0,", "0.7,4.0,", "-0.4,-2.0,", "4.9,4.9,"]


def run_fleet(pkg, tmp_path) -> dict:
    _, Reg, _, Pipelines, Layer, metrics_mod, _ = PACKAGES[pkg]
    broker_loc = f"inproc://mt-pipelines-{pkg}"
    cfg = fleet_config(pkg, tmp_path, broker_loc)
    tenants = Reg.from_config(cfg)
    assert tenants.ids() == ["churn", "movies", "sensors"]
    serving = Layer(cfg)
    serving.start()
    base = f"http://127.0.0.1:{serving.port}"
    batch = Pipelines(cfg, tenants, "batch")
    out = {}
    try:
        assert sorted(serving.tenant_mux.ids()) == ["churn", "movies", "sensors"]
        batch.start()
        assert http("POST", f"{base}/t/movies/ingest", als_lines().encode())[0] == 204
        assert http("POST", f"{base}/t/sensors/add", kmeans_lines().encode())[0] == 204
        assert http("POST", f"{base}/t/churn/train", rdf_lines().encode())[0] == 204
        assert http("GET", f"{base}/t/nope/recommend/u0")[0] == 404
        assert batch.run_round() == {"churn": 1, "movies": 1, "sensors": 1}
        assert all(c == 1 for c in batch.generation_counts().values())
        for tid in ("movies", "sensors", "churn"):
            gens = list((tmp_path / pkg / "model" / tid).iterdir())
            assert any((g / "model.pmml").exists() for g in gens), (pkg, tid)
            assert metrics_mod.registry.counter(f"batch.generations.tenant.{tid}").value >= 1
        assert wait_for(lambda: http("GET", f"{base}/ready")[0] == 200), pkg
        time.sleep(0.3)  # the ALS serving model's refresh window
        out["assign"] = [json.loads(http("GET", f"{base}/t/sensors/assign/{p}")[1])
                         for p in ASSIGN_POINTS]
        out["predict"] = [json.loads(http("GET", f"{base}/t/churn/predict/{r}")[1])
                          for r in PREDICT_ROWS]
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/predict/3.5,0.0,", headers={"X-Oryx-Tenant": "churn"}), timeout=10) as r:
            out["header_predict"] = json.loads(r.read())
        out["recommend"] = {}
        for u in range(12):
            # known items considered: the JAX package's UP fast path reads
            # json.dumps's '", "' known-item lists as one id (fixed in the
            # port, tests/test_torch_als_app.py::
            # test_known_items_with_spaced_separators), so only the full
            # ranking is the same function in both
            status, body = http(
                "GET", f"{base}/t/movies/recommend/u{u}?howMany=10&considerKnownItems=true"
            )
            assert status == 200, (pkg, u, body)
            out["recommend"][u] = [(r["id"], r["value"]) for r in json.loads(body)]
        health = json.loads(http("GET", f"{base}/healthz")[1])
        assert sorted(health["tenants"]) == ["churn", "movies", "sensors"]
        assert all(g is not None for g in health["tenants"].values()), health
        snap = serving.instance_metrics.snapshot()
        for tid in ("movies", "sensors", "churn"):
            assert snap[f"serving.requests.tenant.{tid}"]["value"] > 0, (pkg, tid)
    finally:
        serving.close()
        batch.close()
    return out


def same_ranking(got, want, rtol, atol) -> None:
    """Two ranked (id, value) lists agree within the tolerance: the values
    place by place, and an id may sit elsewhere only among ids whose
    reference scores are within the tolerance of each other."""
    assert len(got) == len(want)
    gv = np.array([v for _, v in got])
    wv = np.array([v for _, v in want])
    np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol)
    score = dict(want)
    for (gid, _), (wid, wval) in zip(got, want):
        if gid != wid:
            assert gid in score, (gid, want)
            assert abs(score[gid] - wval) <= atol + rtol * abs(wval), (got, want)


def test_three_apps_one_fleet_match_jax(tmp_path):
    got = run_fleet("torch", tmp_path)
    want = run_fleet("jax", tmp_path)
    assert got["assign"] == want["assign"]
    assert len(set(got["assign"][:3])) == 3  # three blobs, three clusters
    assert got["predict"] == want["predict"]
    assert got["predict"][:2] == ["pos", "neg"] and got["header_predict"] == "pos"
    for u in range(12):
        same_ranking(got["recommend"][u], want["recommend"][u], **FACTORS)
