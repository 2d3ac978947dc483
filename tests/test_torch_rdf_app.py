"""The port's random-decision-forest application (``oryx_tpu_torch/app/rdf``)
against the JAX package's, on the CPU.

Same CSV lines, same schema and, where the trainer draws random numbers,
the same test seed in both packages. Bars: encodings, bin edges and
binned matrices bit for bit; PMML byte for byte below the Header (which
names the application and its run's timestamp) for the same forest; an
RDFUpdate generation publishes the same trees (importances and
regression's leaf means within a stated tolerance, see its test); the
speed layer's UP messages equal as strings; serving answers what the
published forest predicts. Then the
JAX package's RDF lambda test on the port, over ``inproc:`` and
``file:``, and chip_smoke's rdf-lambda phase at a small size.
"""

import contextlib
import importlib.util
import json
import re
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from oryx_tpu.app.rdf import encode as jencode
from oryx_tpu.app.rdf import forest_pmml as jfp
from oryx_tpu.app.rdf import speed as jspeed
from oryx_tpu.app.rdf import update as jupdate
from oryx_tpu.app.schema import InputSchema as JaxInputSchema
from oryx_tpu.bus.core import KeyMessage as JaxKeyMessage
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as jpmml
from oryx_tpu.common import rng as jrng
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.rdf import encode as tencode
from oryx_tpu_torch.app.rdf import forest_pmml as tfp
from oryx_tpu_torch.app.rdf import speed as tspeed
from oryx_tpu_torch.app.rdf import tree as ttree
from oryx_tpu_torch.app.rdf import update as tupdate
from oryx_tpu_torch.app.schema import InputSchema as TorchInputSchema
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as tpmml
from oryx_tpu_torch.common import rng as trng
from oryx_tpu_torch.ops import forest as tforest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    trng.use_test_seed()
    yield
    trng.clear_test_seed()
    port_device.set_device(None)
    InProcessBroker.reset_all()


SCHEMA = """
oryx.input-schema {
  feature-names = ["uid", "color", "x", "y", "size", "result"]
  id-features = ["uid"]
  categorical-features = ["color", "size", "result"]
  target-feature = "result"
}
"""

REGRESSION_SCHEMA = """
oryx.input-schema {
  feature-names = ["uid", "color", "x", "y", "size", "result"]
  id-features = ["uid"]
  categorical-features = ["color", "size"]
  target-feature = "result"
}
"""


def _lines(n, seed, regression=False):
    gen = np.random.default_rng(seed)
    colors = np.array(["red", "green", "blue", "dark grey"])
    sizes = np.array(["S", "M", "L"])
    out = []
    for j in range(n):
        c = gen.integers(0, 4)
        x, y = gen.normal(0, 2), gen.normal(1, 3)
        s = gen.integers(0, 3)
        if regression:
            target = f"{x * 1.5 + (c == 2) * 4.0 + gen.normal(0, 0.5):.4f}"
        else:
            label = int(x > 0) + 2 * int(c == 2) if gen.random() > 0.1 else gen.integers(0, 4)
            target = ["no", "yes", "maybe", "never"][int(label)]
        out.append(f"u{j},{colors[c]},{x:.3f},{y:.3f},{sizes[s]},{target}")
    return out


def _config(cfg_mod, schema=SCHEMA, extra=""):
    return cfg_mod.get_default().with_overlay(
        schema + f"""
        oryx {{
          rdf {{ num-trees = 4, hyperparams {{ max-depth = 4, min-node-size = 2 }} }}
          {extra}
        }}
        """
    )


def _strip_header(xml: str) -> str:
    return re.sub(r"<(\w+:)?Header.*?</(\w+:)?Header>|<(\w+:)?Header[^>]*/>", "", xml, flags=re.S)


def _both_schemas(schema=SCHEMA):
    return (JaxInputSchema(_config(jconfig, schema)), TorchInputSchema(_config(tconfig, schema)))


@pytest.mark.parametrize("schema", [SCHEMA, REGRESSION_SCHEMA], ids=["classification", "regression"])
@pytest.mark.parametrize("candidates", [3, 100])
def test_encodings_and_bins_bit_identical(schema, candidates):
    """build_encodings, parse_examples, build_binning (distinct-value cuts
    below max-split-candidates, quantile cuts above) and bin_features."""
    regression = schema is REGRESSION_SCHEMA
    lines = _lines(500, 1, regression)
    js, ts = _both_schemas(schema)
    jenc, tenc = jencode.build_encodings(lines, js), tencode.build_encodings(lines, ts)
    for i in range(js.num_features):
        if js.is_categorical(i):
            assert jenc.category_count(i) == tenc.category_count(i)
            assert [jenc.value_for(i, k) for k in range(jenc.category_count(i))] == [
                tenc.value_for(i, k) for k in range(tenc.category_count(i))
            ]
    jf, jt = jencode.parse_examples(lines, js, jenc)
    tf, tt = tencode.parse_examples(lines, ts, tenc)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tt, jt)
    jb = jencode.build_binning(jf, jt, js, candidates, not regression)
    tb = tencode.build_binning(tf, tt, ts, candidates, not regression)
    assert tb.num_bins == jb.num_bins
    for name in ("numeric_cuts", "category_rank", "rank_to_category"):
        got, want = getattr(tb, name), getattr(jb, name)
        assert sorted(got) == sorted(want)
        for j in want:
            assert got[j].dtype == want[j].dtype
            np.testing.assert_array_equal(got[j], want[j])
    binned = tencode.bin_features(tf, tb)
    assert binned.dtype == np.int32
    np.testing.assert_array_equal(binned, jencode.bin_features(jf, jb))
    # skip_unknown drops malformed lines alike
    bad = lines[:5] + ["u9,purple,1.0,2.0,S,yes", "u9,red,notanumber,2.0,S,yes", "short"]
    jf2, _ = jencode.parse_examples(bad, js, jenc, skip_unknown=True)
    tf2, _ = tencode.parse_examples(bad, ts, tenc, skip_unknown=True)
    np.testing.assert_array_equal(tf2, jf2)


def _trained(regression=False, seed=3):
    """A forest trained by the JAX package on _lines: (its ForestArrays,
    binning, importances, schema pair, encodings pair, lines)."""
    schema = REGRESSION_SCHEMA if regression else SCHEMA
    lines = _lines(400, seed, regression)
    js, ts = _both_schemas(schema)
    jenc, tenc = jencode.build_encodings(lines, js), tencode.build_encodings(lines, ts)
    feats, targets = jencode.parse_examples(lines, js, jenc)
    binning = jencode.build_binning(feats, targets, js, 16, not regression)
    binned = jencode.bin_features(feats, binning)
    from oryx_tpu.ops import forest as jops

    tfi = js.target_feature_index
    arrays = jops.train_forest(
        binned, targets if regression else targets.astype(np.int32), num_bins=binning.num_bins,
        num_classes=None if regression else jenc.category_count(tfi), num_trees=3,
        max_depth=4, impurity="variance" if regression else "entropy", seed=2,
        exclude_features={js.feature_to_predictor_index(tfi)},
    )
    imp = jops.feature_importances(arrays, feats.shape[1])
    return arrays, binning, imp, (js, ts), (jenc, tenc), lines


def _port_arrays(a):
    return tforest.ForestArrays(a.split_feature, a.split_bin, a.node_stats, a.node_counts,
                                a.gains, a.num_classes)


@pytest.mark.parametrize("regression", [False, True], ids=["classification", "regression"])
def test_forest_pmml_identical_and_read_both_ways(regression):
    arrays, binning, imp, (js, ts), (jenc, tenc), lines = _trained(regression)
    jforest = jupdate.arrays_to_forest(arrays, binning, imp)
    tforest_ = tupdate.arrays_to_forest(_port_arrays(arrays), binning, imp)
    jdoc = jpmml.to_string(jfp.forest_to_pmml(jforest, js, jenc))
    tdoc = tpmml.to_string(tfp.forest_to_pmml(tforest_, ts, tenc))
    assert "Header" in tdoc and "oryx_tpu_torch" in tdoc
    assert _strip_header(tdoc) == _strip_header(jdoc)
    # each package reads the other's document to a forest that predicts alike
    back_t, _ = tfp.pmml_to_forest(tpmml.from_string(jdoc), ts)
    back_j, _ = jfp.pmml_to_forest(jpmml.from_string(tdoc), js)
    feats, _ = tencode.parse_examples(lines, ts, tenc)
    for row in feats[:60]:
        got, want = back_t.predict(row), back_j.predict(row)
        if regression:
            assert got.prediction == want.prediction
        else:
            np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(back_t.feature_importances, imp)
    # and the port's own document reads back to itself
    again = tpmml.to_string(tfp.forest_to_pmml(
        tfp.pmml_to_forest(tpmml.from_string(tdoc), ts)[0], ts, tenc))
    assert _strip_header(again) == _strip_header(tdoc)


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "pmml_goldens", ROOT / "tests" / "app" / "test_pmml_goldens.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rdf_classification_golden_on_the_port():
    """tests/app/test_pmml_goldens.py:171-215's forest, built from the
    port's tree classes: the reference-shaped golden, and back."""
    goldens = _golden_module()
    T = ttree
    schema = TorchInputSchema(tconfig.get_default().with_overlay(
        """
        oryx.input-schema {
          feature-names = ["uid", "color", "size", "result"]
          id-features = ["uid"]
          categorical-features = ["color", "result"]
          target-feature = "result"
        }
        """
    ))
    from oryx_tpu_torch.app.schema import CategoricalValueEncodings

    encodings = CategoricalValueEncodings({1: ["red", "green", "blue"], 3: ["yes", "no"]})
    tree0 = T.DecisionTree(
        T.DecisionNode(
            "r",
            T.NumericDecision(1, 2.5),
            negative=T.DecisionNode(
                "r-",
                T.CategoricalDecision(0, frozenset({0, 2})),
                negative=T.TerminalNode("r--", T.CategoricalPrediction([4.0, 0.0])),
                positive=T.TerminalNode("r-+", T.CategoricalPrediction([0.0, 2.0])),
                record_count=6,
            ),
            positive=T.TerminalNode("r+", T.CategoricalPrediction([3.0, 1.0])),
            record_count=10,
        )
    )
    tree1 = T.DecisionTree(T.TerminalNode("r", T.CategoricalPrediction([5.0, 5.0])))
    forest = T.DecisionForest([tree0, tree1], [1.0, 1.0], np.array([0.6, 0.4, 0.0]))
    doc = tpmml.to_string(tfp.forest_to_pmml(forest, schema, encodings))
    goldens.assert_matches_golden(doc, goldens.RDF_CLASSIFICATION_GOLDEN)
    # the JAX package's document for its own copy of the fixture, byte for byte
    jforest, jschema, jenc = goldens._rdf_classification_fixture()
    assert _strip_header(doc) == _strip_header(
        jpmml.to_string(jfp.forest_to_pmml(jforest, jschema, jenc)))
    back, _ = tfp.pmml_to_forest(tpmml.from_string(goldens.RDF_CLASSIFICATION_GOLDEN), schema)
    assert [t.root.id for t in back.trees] == ["r", "r"]
    leaf = back.trees[0].find_by_id("r-+")
    np.testing.assert_array_equal(leaf.prediction.counts, [0.0, 2.0])
    assert back.trees[0].root.decision.threshold == 2.5


def _importances(xml: str) -> np.ndarray:
    attrs = re.findall(r' importance="([^"]+)"', xml)
    ext = re.search(r'<Extension name="importances">(.*?)</Extension>', xml).group(1).split()
    assert len(attrs) >= 4 and len(ext) >= len(attrs)
    return np.asarray([float(v) for v in attrs + ext])


def _scores(xml: str) -> np.ndarray:
    return np.asarray([float(v) for v in re.findall(r' score="([^"]+)"', xml)])


def _without_numbers(xml: str) -> str:
    """The document less its importances and leaf means."""
    xml = re.sub(r'<Extension name="importances">.*?</Extension>', "", xml)
    return re.sub(r' (importance|score)="[^"]+"', "", xml)


def _generation(pkg_update, cfg_mod, km_cls, lines, schema, tmp):
    cfg = _config(cfg_mod, schema)
    update = pkg_update.RDFUpdate(cfg)
    data = [km_cls(None, line) for line in lines]
    model = update.build_model(data[:320], [16, 4, "entropy" if schema is SCHEMA else "variance"],
                               tmp)
    score = update.evaluate(model, tmp, data[320:], data[:320])
    return model, score


@pytest.mark.parametrize("regression", [False, True], ids=["classification", "regression"])
def test_rdf_update_generation_matches_jax(regression, tmp_path):
    """RDFUpdate.build_model + evaluate on the same lines and test seed:
    the same trees (PMML byte for byte below the Header but for the
    importances and regression's leaf means) and the same score. The
    importances sum node count x gain, and the gains carry the last bit of
    each package's ``log`` (or its float32 variance), so they agree within
    rtol 1e-5, not bit for bit. Under this suite's 8 virtual CPU devices
    the JAX package's RDFUpdate trains over its mesh (``mesh_from_config``),
    whose psum adds regression's float32 (w, w*y) sums in another order
    than the port's host bincounts: its leaf means agree within rtol 1e-6
    (classification counts are exact either way)."""
    lines = _lines(400, 5, regression)
    schema = REGRESSION_SCHEMA if regression else SCHEMA
    jrng.use_test_seed()
    try:
        jmodel, jscore = _generation(jupdate, jconfig, JaxKeyMessage, lines, schema, tmp_path)
    finally:
        jrng.clear_test_seed()
    trng.use_test_seed()
    tmodel, tscore = _generation(tupdate, tconfig, KeyMessage, lines, schema, tmp_path)
    got, want = (_strip_header(pmml_mod.to_string(doc))
                 for pmml_mod, doc in ((tpmml, tmodel), (jpmml, jmodel)))
    np.testing.assert_allclose(_importances(got), _importances(want), rtol=1e-5)
    np.testing.assert_allclose(_scores(got), _scores(want), rtol=1e-6 if regression else 0)
    assert _without_numbers(got) == _without_numbers(want)
    assert tscore == (pytest.approx(jscore, rel=1e-6) if regression else jscore)
    if regression:
        assert tscore < 0  # negated RMSE
    else:
        assert 0.5 < tscore <= 1.0


def test_rdf_update_trains_over_a_mesh_as_the_jax_package(tmp_path):
    """``oryx.batch.compute.mesh``, once refused: RDFUpdate over eight CPU
    shards against the JAX package's over its eight virtual devices, on
    the same lines and test seed: the same trees and the same score (the
    classification histograms are exact sums on either mesh)."""
    from oryx_tpu_torch.parallel.mesh import device_scope

    lines = _lines(400, 5, False)
    extra = "batch.compute.mesh { data = 8 }"
    models = {}
    for name, upd, cfg_mod, km_cls, rng in (("jax", jupdate, jconfig, JaxKeyMessage, jrng),
                                            ("torch", tupdate, tconfig, KeyMessage, trng)):
        rng.use_test_seed()
        try:
            update = upd.RDFUpdate(_config(cfg_mod, SCHEMA, extra))
            data = [km_cls(None, line) for line in lines]
            with device_scope(["cpu"] * 8) if name == "torch" else contextlib.nullcontext():
                model = update.build_model(data[:320], [16, 4, "entropy"], tmp_path / name)
            models[name] = (model, update.evaluate(model, tmp_path / name, data[320:], data[:320]))
        finally:
            rng.clear_test_seed()
    (tmodel, tscore), (jmodel, jscore) = models["torch"], models["jax"]
    got, want = (_strip_header(pmml_mod.to_string(doc))
                 for pmml_mod, doc in ((tpmml, tmodel), (jpmml, jmodel)))
    np.testing.assert_allclose(_importances(got), _importances(want), rtol=1e-5)
    assert _without_numbers(got) == _without_numbers(want)
    assert tscore == jscore and 0.5 < tscore <= 1.0


@pytest.mark.parametrize("regression", [False, True], ids=["classification", "regression"])
def test_speed_updates_equal_jax(regression):
    arrays, binning, imp, (js, ts), (jenc, tenc), lines = _trained(regression, seed=6)
    schema = REGRESSION_SCHEMA if regression else SCHEMA
    doc = jpmml.to_string(jfp.forest_to_pmml(
        jupdate.arrays_to_forest(arrays, binning, imp), js, jenc))
    jm = jspeed.RDFSpeedModelManager(_config(jconfig, schema))
    tm = tspeed.RDFSpeedModelManager(_config(tconfig, schema))
    assert list(tm.build_updates([KeyMessage(None, lines[0])])) == []  # no model yet
    jm.consume(iter([JaxKeyMessage("MODEL", doc)]))
    tm.consume(iter([KeyMessage("MODEL", doc)]))
    batch = _lines(150, 7, regression) + ["u1,purple,1.0,1.0,S,yes", "garbage"]
    got = list(tm.build_updates([KeyMessage(None, line) for line in batch]))
    want = list(jm.build_updates([JaxKeyMessage(None, line) for line in batch]))
    assert got == want and len(got) > 3
    # UP messages of its own are not applied by the speed layer
    tm.consume(iter([KeyMessage("UP", got[0])]))
    with pytest.raises(ValueError):
        tm.consume(iter([KeyMessage("BOGUS", "x")]))


# -- serving and the lambda loop ---------------------------------------------------


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


def _serving_config(loc, schema=SCHEMA):
    return _config(tconfig, schema, extra=f"""
          input-topic.broker = "{loc}"
          update-topic.broker = "{loc}"
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.rdf.serving:RDFServingModelManager"
            application-resources = "oryx_tpu_torch.app.rdf.serving"
          }}
    """)


def test_serving_endpoints_answer_what_the_forest_predicts():
    from oryx_tpu_torch import bus
    from oryx_tpu_torch.serving.layer import ServingLayer

    arrays, binning, imp, (js, ts), (jenc, tenc), lines = _trained(seed=8)
    doc = jpmml.to_string(jfp.forest_to_pmml(
        jupdate.arrays_to_forest(arrays, binning, imp), js, jenc))
    jforest, jenc2 = jfp.pmml_to_forest(jpmml.from_string(doc), js)
    loc = "inproc://rdf-serving"
    layer = ServingLayer(_serving_config(loc))
    layer.start()
    base = f"http://127.0.0.1:{layer.port}"
    try:
        assert http("GET", f"{base}/predict/u1,red,1.0,1.0,S,")[0] == 503
        with bus.get_broker(loc).producer("OryxUpdate") as p:
            p.send("MODEL", doc)
        assert wait_for(lambda: http("GET", f"{base}/ready")[0] == 200)
        tfi = js.target_feature_index
        probe = [line.rsplit(",", 1)[0] + "," for line in lines[:40]]
        want = []
        for datum in probe:
            row, _ = jencode.parse_examples([datum + "no"], js, jenc2)
            want.append(jforest.predict(row[0]))
        for datum, pred in zip(probe, want):
            status, body = http("GET", f"{base}/predict/{urllib.request.quote(datum)}")
            assert status == 200
            assert json.loads(body) == jenc2.value_for(tfi, pred.most_probable_index)
            dist = json.loads(http(
                "GET", f"{base}/classificationDistribution/{urllib.request.quote(datum)}")[1])
            assert dist == {jenc2.value_for(tfi, i): float(q)
                            for i, q in enumerate(pred.probabilities)}
        status, body = http("POST", f"{base}/predict", "\n".join(probe).encode())
        assert status == 200
        assert json.loads(body) == [jenc2.value_for(tfi, p.most_probable_index) for p in want]
        importances = json.loads(http("GET", f"{base}/feature/importance")[1])
        assert sorted(importances) == ["color", "size", "x", "y"]
        assert importances == {
            name: float(imp[js.feature_to_predictor_index(js.feature_names.index(name))])
            for name in importances
        }
        assert json.loads(http("GET", f"{base}/feature/importance/1")[1]) == float(imp[1])
        assert http("GET", f"{base}/feature/importance/99")[0] == 400
        assert http("GET", f"{base}/predict/u1,purple,1.0,1.0,S,")[0] == 400
        # a missing numeric field takes the heavier branch, as in the JAX package
        assert http("GET", f"{base}/predict/u1,red,,1.0,S,")[0] == 200
        # /train queues its lines on the input topic in order
        consumer = bus.get_broker(loc).consumer("OryxInput", from_beginning=True)
        assert http("POST", f"{base}/train", "\n".join(lines[:5] + [""]).encode())[0] == 204
        got = []
        assert wait_for(lambda: got.extend(r.message for r in consumer.poll(100, 0.1))
                        or len(got) >= 5)
        consumer.close()
        assert sorted(got) == sorted(lines[:5])
    finally:
        layer.close()


def _pipeline_config(tmp_path, loc):
    return tconfig.get_default().with_overlay(
        f"""
        oryx {{
          id = "RDFE2E"
          input-topic.broker = "{loc}"
          update-topic.broker = "{loc}"
          input-schema {{
            num-features = 3
            numeric-features = ["0", "1"]
            target-feature = "2"
          }}
          rdf {{
            num-trees = 5
            hyperparams {{ max-depth = 4, impurity = "entropy" }}
          }}
          batch {{
            streaming.generation-interval-sec = 3600
            update-class = "oryx_tpu_torch.app.rdf.update:RDFUpdate"
            storage {{ data-dir = "{tmp_path}/data/"
                      model-dir = "{tmp_path}/model/" }}
          }}
          speed {{
            streaming.generation-interval-sec = 3600
            model-manager-class = "oryx_tpu_torch.app.rdf.speed:RDFSpeedModelManager"
          }}
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.rdf.serving:RDFServingModelManager"
            application-resources = "oryx_tpu_torch.app.rdf.serving"
          }}
          ml.eval {{ candidates = 1, test-fraction = 0 }}
        }}
        """
    )


@pytest.fixture(params=["inproc", "file"])
def pipe_bus(request, tmp_path):
    return "inproc://rdf-e2e" if request.param == "inproc" else f"file:{tmp_path}/bus"


def test_full_rdf_pipeline(tmp_path, pipe_bus):
    """tests/app/rdf/test_rdf_e2e.py on the port: labelled lines through
    /train, a batch generation, served predictions, distributions and
    importances, and a speed micro-batch whose leaf updates shift the
    served distribution."""
    from oryx_tpu_torch.lambda_.batch import BatchLayer
    from oryx_tpu_torch.lambda_.speed import SpeedLayer
    from oryx_tpu_torch.serving.layer import ServingLayer

    cfg = _pipeline_config(tmp_path, pipe_bus)
    batch = BatchLayer(cfg)
    batch.prepare()
    speed = SpeedLayer(cfg)
    speed.start()
    serving = ServingLayer(cfg)
    serving.start()
    base = f"http://127.0.0.1:{serving.port}"
    try:
        gen = np.random.default_rng(8)
        lines = []
        for _ in range(150):
            x = float(gen.uniform(-5, 5))
            y = float(gen.uniform(-5, 5))
            lines.append(f"{x:.3f},{y:.3f},{'pos' if x > 0 else 'neg'}")
        assert http("POST", f"{base}/train", "\n".join(lines).encode())[0] == 204
        assert speed.run_one_batch() == 0  # no model yet: the lines pass unfolded

        batch.run_one_generation(timestamp_ms=4242)
        assert (tmp_path / "model" / "4242" / "model.pmml").exists()

        assert wait_for(lambda: http("GET", f"{base}/ready")[0] == 200)
        assert json.loads(http("GET", f"{base}/predict/3.5,0.0,")[1]) == "pos"
        assert json.loads(http("GET", f"{base}/predict/-3.5,0.0,")[1]) == "neg"
        probs = json.loads(http("GET", f"{base}/classificationDistribution/3.5,0.0,")[1])
        assert probs["pos"] > probs.get("neg", 0.0)
        importances = json.loads(http("GET", f"{base}/feature/importance")[1])
        assert importances["0"] > importances["1"]  # x decides, y is noise

        assert wait_for(lambda: speed.manager.model is not None)
        base_probs = json.loads(http("GET", f"{base}/classificationDistribution/4.0,1.0,")[1])
        body = b"\n".join(b"4.0,1.0,neg" for _ in range(20))
        assert http("POST", f"{base}/train", body)[0] == 204
        assert speed.run_one_batch() > 0  # [treeID, nodeID, counts] updates published

        def leaf_updated():
            got = json.loads(http("GET", f"{base}/classificationDistribution/4.0,1.0,")[1])
            return got.get("neg", 0.0) > base_probs.get("neg", 0.0)

        assert wait_for(leaf_updated)
    finally:
        serving.close()
        speed.close()
        batch.close()


def test_rdf_lambda_as_three_processes_on_the_cpu():
    """chip_smoke's rdf-lambda phase at a small size, its three layers
    started as ``python -m oryx_tpu_torch ... --device cpu``: every check
    of the phase holds."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    out = chip_smoke.phase_rdf_lambda(7, rows=3_000, device="cpu", batch_interval=8)
    assert out["predict_lines_checked"] > 0
    assert out["wave2_staleness_s"] > 0
