"""The port's online experiments (oryx_tpu_torch/experiments, the
serving layer's arm, the probe app of registry/testing.py) against the
JAX package's, on the CPU.

- ``bucket_of`` and the arm are equal for 10,000 users (exact: both are
  the same blake2b hash), and ``ArmRouter.user_of`` extracts the same
  unit from the same paths and headers.
- The evaluator: tests/experiments/test_evaluator.py's cases, each one
  case of a parametrised test run on both packages' evaluators under a
  fake clock, whose ``snapshot()`` bodies must be equal (exact, less
  ``started_at``, the wall clock at construction).
- The coordinator with the probe app, one ``ServingLayer`` per package on
  an inproc bus: generation A is the champion, B the online challenger;
  200 users each ask ``/probe/recommend`` and then interact, the
  challenger arm with its first served item and the champion arm with
  an item outside its list (or the other way round). Both packages give
  each user the same arm, record the same decision (promote, or refuse)
  in B's manifest, move CHAMPION alike, and end with the same evidence
  (resolved, hits and pair counts equal, exact).
- The ALS manager is not generation-aware in either package: a
  challenger MODEL replaces the live ALS model for both arms (ported as
  it is). ALS's id-value answers join interactions in the port only:
  the JAX package's online join reads them as no items (repaired in the
  port).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from oryx_tpu import bus as jbus
from oryx_tpu.bus.core import KeyMessage as JaxKeyMessage
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as jpmml
from oryx_tpu.app import pmml as japp_pmml
from oryx_tpu.experiments import evaluator as jevaluator
from oryx_tpu.experiments import routing as jrouting
from oryx_tpu.registry import manifest as jmanifest
from oryx_tpu.registry.store import RegistryStore as JaxRegistryStore
from oryx_tpu.registry.testing import ScriptedMetricUpdate as JaxScriptedMetricUpdate
from oryx_tpu.serving.layer import ServingLayer as JaxServingLayer
from oryx_tpu_torch import bus as tbus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app import pmml as tapp_pmml
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as tpmml
from oryx_tpu_torch.common.text import join_json
from oryx_tpu_torch.experiments import evaluator as tevaluator
from oryx_tpu_torch.experiments import routing as trouting
from oryx_tpu_torch.registry import manifest as tmanifest
from oryx_tpu_torch.registry.store import RegistryStore
from oryx_tpu_torch.registry.testing import ScriptedMetricUpdate, probe_items
from oryx_tpu_torch.serving.layer import ServingLayer

PACKAGES = {
    "jax": dict(name="oryx_tpu", config=jconfig, bus=jbus, km=JaxKeyMessage, pmml=jpmml,
                app_pmml=japp_pmml, evaluator=jevaluator, routing=jrouting,
                manifest=jmanifest, store=JaxRegistryStore, update=JaxScriptedMetricUpdate,
                layer=JaxServingLayer),
    "torch": dict(name="oryx_tpu_torch", config=tconfig, bus=tbus, km=KeyMessage, pmml=tpmml,
                  app_pmml=tapp_pmml, evaluator=tevaluator, routing=trouting,
                  manifest=tmanifest, store=RegistryStore, update=ScriptedMetricUpdate,
                  layer=ServingLayer),
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


# -- routing -----------------------------------------------------------------------


@pytest.mark.parametrize("salt", ["oryx-ab", "exp-7"])
@pytest.mark.parametrize("fraction", [0.1, 0.5])
def test_bucket_and_arm_match_jax_for_10000_users(fraction, salt):
    users = [f"u{i}" for i in range(10_000)]
    routers = {pkg: PACKAGES[pkg]["routing"].ArmRouter(
        PACKAGES[pkg]["routing"].ABConfig(fraction=fraction, salt=salt)) for pkg in PACKAGES}
    tb = [trouting.bucket_of(u, salt) for u in users]
    assert tb == [jrouting.bucket_of(u, salt) for u in users]
    arms = [routers["torch"].assign(u) for u in users]
    assert arms == [routers["jax"].assign(u) for u in users]
    share = arms.count(trouting.ARM_CHALLENGER) / len(users)
    assert abs(share - fraction) < 0.02
    if salt == "oryx-ab":  # tests/experiments/test_routing.py's pinned values
        assert trouting.bucket_of("u1", salt) == pytest.approx(0.0179041451, abs=1e-9)
        assert trouting.bucket_of("u2", salt) == pytest.approx(0.5502204657, abs=1e-9)


@pytest.mark.parametrize("path, headers", [
    ("/recommend/u7", None),
    ("/api/recommend/u7?howMany=3", None),
    ("/probe/recommendToMany/u9", None),
    ("/metrics", None),
    ("/recommend/u7", {"X-Oryx-User": "alice"}),
    ("/recommend/u7", {"x-oryx-user": "alice"}),
    ("/recommend/u7", {"X-Oryx-User": ""}),
])
def test_user_extraction_matches_jax(path, headers):
    got = trouting.ArmRouter(trouting.ABConfig()).user_of(path, headers)
    assert got == jrouting.ArmRouter(jrouting.ABConfig()).user_of(path, headers)


def test_abconfig_and_generation_override_match_jax():
    for text in ("", "oryx.serving.ab { fraction = 0.25, salt = s, join-window-s = 3 }"):
        got = trouting.ABConfig.from_config(tconfig.get_default().with_overlay(text))
        want = jrouting.ABConfig.from_config(jconfig.get_default().with_overlay(text))
        assert got.__dict__ == want.__dict__
    assert trouting.requested_generation() is None
    with trouting.serve_generation("123"):
        assert trouting.requested_generation() == "123"
        with trouting.serve_generation("456"):
            assert trouting.requested_generation() == "456"
        assert trouting.requested_generation() == "123"
    assert trouting.requested_generation() is None
    assert trouting.ARM_HEADER == jrouting.ARM_HEADER == "X-Oryx-Experiment-Arm"


# -- the evaluator: tests/experiments/test_evaluator.py's cases ---------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def ev_join_within_window(ev, clock, champ, chal):
    ev.observe_serve("u1", champ, "100", ["i1", "i2", "i3"])
    clock.t += 1.0
    assert ev.observe_event("u1,i2") is True  # rank 2: outcome 0.5


def ev_unserved_item_is_joined_miss(ev, clock, champ, chal):
    ev.observe_serve("u1", champ, "100", ["i1", "i2"])
    assert ev.observe_event("u1,i99") is True


def ev_window_expiry(ev, clock, champ, chal):
    ev.observe_serve("u1", chal, "200", ["i1"])
    clock.t += 11.0
    ev.tick()
    assert ev.observe_event("u1,i1") is False


def ev_oldest_pending_first(ev, clock, champ, chal):
    ev.observe_serve("u1", champ, "100", ["i1"])
    clock.t += 1.0
    ev.observe_serve("u1", champ, "100", ["i2"])
    assert ev.observe_event("u1,i2") is True
    assert ev.observe_event("u1,i2") is True


def ev_itemless_serves(ev, clock, champ, chal):
    ev.observe_serve("u1", champ, "100", [], latency_s=0.01, shed_stage="deadline")
    assert ev.observe_event("u1,i1") is False


def ev_lru_eviction(ev, clock, champ, chal):
    for i in range(53):  # three past max-tracked-users = 50
        ev.observe_serve(f"u{i}", champ, "100", ["i1"])


def ev_pair_counts(ev, clock, champ, chal):
    for arm, item_lists, events in (
        (champ, [["a"], ["b"]], ["a", "x"]),
        (chal, [["a"], ["b"], ["c"]], ["a", "b", "x"]),
    ):
        for i, (items, event_item) in enumerate(zip(item_lists, events)):
            user = f"{arm}-u{i}"
            ev.observe_serve(user, arm, "g", items, latency_s=0.001 * (i + 1))
            ev.observe_event(f"{user},{event_item}")
    assert ev.pair_counts() == (1, 0, 1)


def ev_mixed_stream(ev, clock, champ, chal):
    """A longer seeded stream: serves in both arms, joined hits and
    misses, malformed lines, expiries and LRU evictions."""
    gen = np.random.default_rng(5)
    for step in range(400):
        user = f"u{gen.integers(0, 150)}"
        if gen.random() < 0.55:
            arm = chal if gen.random() < 0.5 else champ
            items = [f"i{j}" for j in gen.integers(0, 30, size=gen.integers(0, 4))]
            ev.observe_serve(user, arm, "g", items, latency_s=float(gen.random()),
                             shed_stage="stale" if gen.random() < 0.05 else None)
        elif gen.random() < 0.1:
            ev.observe_event("free text, not an event,")
            ev.observe_event("noise")
        else:
            ev.observe_event(f"{user},i{gen.integers(0, 30)},1.0")
        clock.t += float(gen.random())
        if step % 50 == 0:
            ev.tick()


EVALUATOR_CASES = {f.__name__: f for f in (
    ev_join_within_window, ev_unserved_item_is_joined_miss, ev_window_expiry,
    ev_oldest_pending_first, ev_itemless_serves, ev_lru_eviction, ev_pair_counts,
    ev_mixed_stream,
)}


def run_evaluator(pkg, case):
    mods = PACKAGES[pkg]
    clock = FakeClock()
    ev = mods["evaluator"].ExperimentEvaluator(
        mods["routing"].ABConfig(fraction=0.1, join_window_s=10.0, max_tracked_users=50),
        clock=clock,
    )
    EVALUATOR_CASES[case](ev, clock, mods["routing"].ARM_CHAMPION, mods["routing"].ARM_CHALLENGER)
    snap = ev.snapshot()
    json.dumps(snap)  # it is the /experiments body
    snap.pop("started_at")
    return snap


@pytest.mark.parametrize("case", sorted(EVALUATOR_CASES))
def test_evaluator_snapshot_matches_jax(case):
    got = run_evaluator("torch", case)
    assert got == run_evaluator("jax", case)
    if case == "ev_join_within_window":
        arm = got["arms"]["champion"]
        assert (arm["serves"], arm["resolved"], arm["hits"], arm["mrr"]) == (1, 1, 1, 0.5)
    if case == "ev_lru_eviction":
        assert got["arms"]["champion"]["resolved"] == 3 and got["pending_serves"] == 50


@pytest.mark.parametrize("line", ["u1,i5", "u1,i5,4.5", " u1 , i5 ", "not-an-event", "u1,", ""])
def test_parse_event_matches_jax(line):
    assert tevaluator.parse_event(line) == jevaluator.parse_event(line)


# -- the coordinator with the probe app, through each package's layer ---------------

MIN_SAMPLES = 20
USERS = 200


def probe_config(pkg, tmp_path, broker_loc, metric=1.0, extra=""):
    name = PACKAGES[pkg]["name"]
    return PACKAGES[pkg]["config"].get_default().with_overlay(
        f"""
        oryx {{
          id = "Exp"
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          batch.storage {{ data-dir = "{tmp_path}/{pkg}/data/"
                           model-dir = "{tmp_path}/{pkg}/model/" }}
          serving {{
            api.port = 0
            model-manager-class = "{name}.registry.testing.PMMLProbeServingModelManager"
            application-resources = "{name}.registry.testing"
            ab {{ fraction = 0.5, join-window-s = 60 }}
          }}
          ml {{
            eval {{ candidates = 1, test-fraction = 0.5 }}
            gate.max-regression = 0.05
            gate.online {{ enabled = true, min-samples = {MIN_SAMPLES}, min-lift = 0.0,
                          max-harm = 0.05, confidence = 0.9, check-interval-s = 0.1 }}
          }}
          test.scripted-metric = {metric}
          {extra}
        }}
        """
    )


def http(method, url, body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def run_generation(pkg, tmp_path, broker_loc, timestamp_ms, metric):
    """One batch generation through each package's MLUpdate harness."""
    mods = PACKAGES[pkg]
    update = mods["update"](probe_config(pkg, tmp_path, broker_loc, metric))
    broker = mods["bus"].get_broker(broker_loc)
    broker.create_topic("OryxUpdate", 1)
    data = [mods["km"](None, f"r{i}") for i in range(6)]
    with broker.producer("OryxUpdate") as producer:
        update.run_update(timestamp_ms, data, [], str(tmp_path / pkg / "model"), producer)


def run_experiment(pkg, tmp_path, challenger_better: bool) -> dict:
    mods = PACKAGES[pkg]
    broker_loc = f"inproc://exp-{pkg}-{challenger_better}"
    store = mods["store"](str(tmp_path / pkg / "model"))
    layer = mods["layer"](probe_config(pkg, tmp_path, broker_loc))
    layer.start()
    base = f"http://127.0.0.1:{layer.port}"
    out = {}
    try:
        run_generation(pkg, tmp_path, broker_loc, 1000, 0.90)
        assert store.champion_id() == "1000"
        assert wait_for(lambda: layer.health.live_generation == "1000")
        # the tracker names the challenger before the coordinator resets
        # the evaluator for it: a serve sent in between would be wiped, so
        # the requests wait for the reset itself
        evidence_before = layer.experiments.evaluator.arms
        run_generation(pkg, tmp_path, broker_loc, 2000, 0.92)
        assert store.champion_id() == "1000"  # the online gate holds the pointer
        assert store.read_manifest("2000").online_status == mods["manifest"].ONLINE_PENDING
        assert wait_for(lambda: layer.health.challenger_generation == "2000")
        assert wait_for(lambda: layer.experiments.active)
        assert wait_for(lambda: layer.experiments.evaluator.arms is not evidence_before)
        arms, events = {}, []
        for i in range(USERS):
            user = f"u{i}"
            status, body, headers = http("GET", f"{base}/probe/recommend/{user}")
            assert status == 200, body
            arm = headers["X-Oryx-Experiment-Arm"]
            arms[user] = arm
            served = json.loads(body)
            want_gen = "2000" if arm == "challenger" else "1000"
            assert served["generation_id"] == want_gen  # the probe manager honours the arm
            assert served["items"] == probe_items(want_gen, user)
            hit = (arm == "challenger") == challenger_better
            events.append(f"{user},{served['items'][0] if hit else 'nope'}")
        # sticky: a second request keeps the arm
        for user in list(arms)[:20]:
            assert http("GET", f"{base}/probe/recommend/{user}")[2][
                "X-Oryx-Experiment-Arm"] == arms[user]
        with mods["bus"].get_broker(broker_loc).producer("OryxInput") as p:
            for line in events:
                p.send(None, line)

        def concluded():
            m = store.read_manifest("2000")
            return m is not None and m.online_status in (
                mods["manifest"].ONLINE_PROMOTED, mods["manifest"].ONLINE_REFUSED)

        assert wait_for(concluded), layer.experiments.report()
        # the registry records the decision before the tracker applies it:
        # read the layer's generations once it serves the registry's champion
        assert wait_for(lambda: layer.health.challenger_generation is None
                        and layer.health.live_generation == store.champion_id())
        assert wait_for(lambda: layer.experiments.evaluator.events_seen >= USERS)
        manifest = store.read_manifest("2000")
        report = layer.experiments.report()
        out.update(
            arms=arms,
            status=manifest.online_status,
            champion=store.champion_id(),
            lift_sign=np.sign(manifest.online_lift),
            samples_ok=min(manifest.online_samples.values()) >= MIN_SAMPLES,
            live=layer.health.live_generation,
            challenger=layer.health.challenger_generation,
            verdict=report["decision"]["verdict"],
            evidence={
                arm: {k: v for k, v in stats.items() if k in ("serves", "resolved", "hits")}
                for arm, stats in report["report"]["arms"].items()
            },
            pairs=report["report"]["pairs"],
        )
        status, body, _ = http("GET", f"{base}/experiments")
        assert status == 200 and json.loads(body)["fraction"] == 0.5
    finally:
        layer.close()
    return out


@pytest.mark.parametrize("challenger_better", [True, False], ids=["promote", "refuse"])
def test_coordinator_decisions_match_jax(tmp_path, challenger_better):
    got = run_experiment("torch", tmp_path, challenger_better)
    want = run_experiment("jax", tmp_path, challenger_better)
    assert got["arms"] == want["arms"]
    assert {trouting.ArmRouter(trouting.ABConfig(fraction=0.5)).assign(u) for u in got["arms"]} \
        == set(got["arms"].values())
    assert got == want
    if challenger_better:
        assert got["status"] == "promoted" and got["champion"] == "2000"
        assert got["verdict"] == "promote" and got["lift_sign"] > 0
        assert got["live"] == "2000" and got["challenger"] is None
    else:
        assert got["status"] == "refused" and got["champion"] == "1000"
        assert got["verdict"] == "refuse" and got["lift_sign"] < 0
        assert got["live"] == "1000" and got["challenger"] is None
    assert got["samples_ok"]


# -- ALS under an experiment: the manager is not generation-aware -------------------


def als_config(pkg, model_dir, broker_loc):
    name = PACKAGES[pkg]["name"]
    return PACKAGES[pkg]["config"].get_default().with_overlay(
        f"""
        oryx {{
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          batch.storage.model-dir = "{model_dir}"
          serving {{
            api.port = 0
            model-manager-class = "{name}.app.als.serving_model:ALSServingModelManager"
            application-resources = "{name}.app.als.endpoints"
            ab.fraction = 0.5
          }}
        }}
        """
    )


def als_model(pkg, generation, users, items):
    mods = PACKAGES[pkg]
    root = mods["pmml"].build_skeleton_pmml()
    mods["app_pmml"].add_extension(root, "features", 2)
    mods["app_pmml"].add_extension(root, "implicit", "true")
    mods["app_pmml"].add_extension(root, "generation", generation)
    mods["app_pmml"].add_extension_content(root, "XIDs", users)
    mods["app_pmml"].add_extension_content(root, "YIDs", items)
    return mods["pmml"].to_string(root)


def publish_als(producer, pkg, generation, prefix):
    users = ["U0", "U1", "U2", "U3"]
    items = [f"{prefix}{j}" for j in range(4)]
    producer.send("MODEL", als_model(pkg, generation, users, items))
    for j, item in enumerate(items):
        producer.send("UP", join_json(["Y", item, [1.0 + j, 1.0]]))
    for u in users:
        producer.send("UP", join_json(["X", u, [1.0, 0.5], []]))


def start_als_experiment(pkg, tmp_path):
    """A package's ALS layer with CHAMPION on generation 1000, serving
    1000 and then tracking 2000 as the challenger."""
    mods = PACKAGES[pkg]
    model_dir = tmp_path / pkg / "model"
    mods["store"](str(model_dir)).set_champion("1000")
    broker_loc = f"inproc://als-exp-{pkg}"
    layer = mods["layer"](als_config(pkg, model_dir, broker_loc))
    layer.start()
    base = f"http://127.0.0.1:{layer.port}"
    broker = mods["bus"].get_broker(broker_loc)
    with broker.producer("OryxUpdate") as p:
        publish_als(p, pkg, "1000", "I")
    assert wait_for(lambda: http("GET", f"{base}/ready")[0] == 200)
    assert wait_for(lambda: layer.health.live_generation == "1000")
    with broker.producer("OryxUpdate") as p:
        publish_als(p, pkg, "2000", "J")
    assert wait_for(lambda: layer.health.challenger_generation == "2000")
    time.sleep(0.3)  # the serving model's refresh window
    return layer, base, broker


def test_als_challenger_model_replaces_the_live_als_model_in_both(tmp_path):
    """Only the probe manager reads ``consuming_challenger()``: the ALS
    manager swaps in every MODEL it is given. With CHAMPION on generation
    1000, generation 2000's MODEL is tracked as the challenger (the
    champion stays live on /healthz), yet both arms are answered from
    2000's items. The JAX package does the same; ported as it is."""
    answers = {}
    for pkg in PACKAGES:
        layer, base, _ = start_als_experiment(pkg, tmp_path)
        try:
            by_arm = {}
            for u in ("U0", "U1", "U2", "U3"):
                assert wait_for(lambda u=u: http("GET", f"{base}/recommend/{u}")[1]
                                .decode().count('"J') == 4)
                status, body, headers = http("GET", f"{base}/recommend/{u}")
                by_arm[headers["X-Oryx-Experiment-Arm"]] = json.loads(body)
            assert set(by_arm) == {"champion", "challenger"}
            # the champion arm is answered with the challenger's items (J*,
            # published by 2000 alone) from the one model both arms share
            assert by_arm["champion"] == by_arm["challenger"]
            assert {"J0", "J1", "J2", "J3"} <= {r["id"] for r in by_arm["champion"]}
            assert layer.health.live_generation == "1000"
            answers[pkg] = by_arm
        finally:
            layer.close()
    assert answers["torch"] == answers["jax"]


def test_als_serves_join_interactions_in_the_port_only(tmp_path):
    """ALS's /recommend answers id-value records, which the JAX package's
    online join reads as no items: its ALS serves never pend, an
    interaction joins nothing, and the gate can never conclude. The port
    reads their ids (``layer._served_items``), so the same interaction
    resolves the serve as a hit."""
    joined = {}
    for pkg in PACKAGES:
        layer, base, broker = start_als_experiment(pkg, tmp_path)
        try:
            status, body, headers = http("GET", f"{base}/recommend/U0")
            assert status == 200
            arm = headers["X-Oryx-Experiment-Arm"]
            first = json.loads(body)[0]["id"]
            with broker.producer("OryxInput") as p:
                p.send(None, f"U0,{first},1")
            ev = layer.experiments.evaluator
            assert wait_for(lambda: ev.events_seen >= 1)
            stats = ev.snapshot()["arms"][arm]
            joined[pkg] = (stats["serves"], stats["resolved"], stats["hits"], ev.events_joined)
        finally:
            layer.close()
    assert joined["jax"] == (1, 0, 0, 0)
    assert joined["torch"] == (1, 1, 1, 1)
