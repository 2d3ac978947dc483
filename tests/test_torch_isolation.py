"""The port stands alone: it imports neither jax nor the JAX package, and
it never picks the CPU on its own."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from oryx_tpu_torch import device as port_device

ROOT = Path(__file__).resolve().parent.parent

# Runs in a fresh interpreter where importing jax or any oryx_tpu module
# (other than oryx_tpu_torch) fails: every module of the port imports,
# the serving path answers over HTTP on the CPU (behind the native front,
# built by the port's own loader, where g++ is present, which also gives
# the native feature store), the k-means batch path
# trains one generation on a file: bus and the speed layer folds points
# into its model, ALS trains (packing in forked workers) and folds in, an
# RDF generation trains on a file: bus and answers /predict, the CLI's
# lint (its lockorder and torchhot passes) finds the tree clean, and
# chip_smoke.py and scan_bench.py import.
_ISOLATED = textwrap.dedent(
    r"""
    import importlib.abc, json, pkgutil, sys, time, urllib.request

    _T0 = time.monotonic()

    def step(name):
        # each step's seconds since the start, so that a failure names its step
        sys.stderr.write(f"ISOLATED-STEP {name} {time.monotonic() - _T0:.2f}\n")
        sys.stderr.flush()

    sys.modules["jax"] = None

    class _RefuseJaxPackage(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "oryx_tpu" or name.startswith("oryx_tpu."):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, _RefuseJaxPackage())

    import numpy as np
    import oryx_tpu_torch

    walked = set()
    for info in pkgutil.walk_packages(oryx_tpu_torch.__path__, "oryx_tpu_torch."):
        importlib.import_module(info.name)
        walked.add(info.name)
    assert {"oryx_tpu_torch.common.io_utils", "oryx_tpu_torch.loadgen.engine",
            "oryx_tpu_torch.loadgen.scenario", "oryx_tpu_torch.serving.autoscale",
            "oryx_tpu_torch.tools.fleet", "oryx_tpu_torch.common.locks",
            "oryx_tpu_torch.analysis.core", "oryx_tpu_torch.analysis.torchhot",
            "oryx_tpu_torch.analysis.lockorder", "oryx_tpu_torch.analysis.configkeys",
            "oryx_tpu_torch.analysis.deploymanifests",
            "oryx_tpu_torch.analysis.metricscatalog"} <= walked, sorted(walked)
    step("imports")

    from oryx_tpu_torch import bus, device
    from oryx_tpu_torch.app import pmml as app_pmml
    from oryx_tpu_torch.common import config, pmml
    from oryx_tpu_torch.common.text import join_json
    from oryx_tpu_torch.serving.layer import ServingLayer

    device.set_device("cpu")
    gen = np.random.default_rng(0)
    for dtype in ("float32", "int8"):
        loc = f"inproc://isolated-{dtype}"
        layer = ServingLayer(config.get_default().with_overlay(f'''
            oryx {{
              input-topic.broker = "{loc}"
              update-topic.broker = "{loc}"
              als.serving.score-dtype = "{dtype}"
              serving {{
                api.port = 0
                model-manager-class = "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"
                application-resources = "oryx_tpu_torch.app.als"
              }}
            }}'''))
        layer.start()
        from oryx_tpu_torch import native
        from oryx_tpu_torch.native.store import NativeFeatureVectors, make_feature_vectors
        assert (layer._native_front is not None) == (native.get_library() is not None)
        assert isinstance(make_feature_vectors(), NativeFeatureVectors) == (
            native.get_library() is not None)
        root = pmml.build_skeleton_pmml()
        app_pmml.add_extension(root, "features", 8)
        app_pmml.add_extension(root, "implicit", "true")
        with bus.get_broker(loc).producer("OryxUpdate") as p:
            p.send("MODEL", pmml.to_string(root))
            for j in range(300):
                p.send("UP", join_json(["Y", f"i{j}", gen.standard_normal(8).tolist()]))
            for j in range(20):
                p.send("UP", join_json(["X", f"u{j}", gen.standard_normal(8).tolist()]))
        base = f"http://127.0.0.1:{layer.port}"
        deadline = time.monotonic() + 30
        while True:
            try:
                urllib.request.urlopen(base + "/ready", timeout=5)
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        time.sleep(0.3)
        for path in ("/recommend/u3", "/similarity/i5", "/estimate/u3/i1"):
            with urllib.request.urlopen(base + path, timeout=10) as resp:
                assert resp.status == 200 and json.loads(resp.read()), path
        layer.close()
        step(f"als-serving-{dtype}")
    # the k-means lambda on a file: bus: one batch generation, trained
    # through the sweep, then a speed micro-batch folded into its model
    from oryx_tpu_torch.lambda_.batch import BatchLayer
    from oryx_tpu_torch.lambda_.speed import SpeedLayer
    import tempfile
    tmp = tempfile.mkdtemp()
    kmeans_cfg = config.get_default().with_overlay(f'''
        oryx {{
          id = "Isolated"
          input-topic.broker = "file:{tmp}/bus"
          update-topic.broker = "file:{tmp}/bus"
          input-schema {{ num-features = 2, numeric-features = ["0", "1"] }}
          kmeans.hyperparams.k = 2
          batch.update-class = "oryx_tpu_torch.app.kmeans.update:KMeansUpdate"
          batch.storage {{ data-dir = "{tmp}/data/", model-dir = "{tmp}/model/" }}
          speed.model-manager-class = "oryx_tpu_torch.app.kmeans.speed:KMeansSpeedModelManager"
          speed.streaming.generation-interval-sec = 3600
        }}''')
    batch = BatchLayer(kmeans_cfg)
    batch.prepare()
    speed = SpeedLayer(kmeans_cfg)
    speed.start()
    file_bus = bus.get_broker(f"file:{tmp}/bus")
    with file_bus.producer("OryxInput") as p:
        for j in range(40):
            p.send(None, f"{(j % 2) * 10 + gen.standard_normal():.3f},{gen.standard_normal():.3f}")
    assert speed.run_one_batch() == 0  # no model yet
    batch.run_one_generation(timestamp_ms=5)
    batch.close()
    assert pmml.read_pmml(f"{tmp}/model/5/model.pmml") is not None
    deadline = time.monotonic() + 30
    while speed.manager.model is None:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    with file_bus.producer("OryxInput") as p:
        p.send(None, "10.0,0.0")
    assert speed.run_one_batch() == 1
    speed.close()
    step("kmeans-lambda")
    # ALS: packing through forked workers, training and a device fold-in
    from oryx_tpu_torch.ops import als, packing
    u = gen.integers(0, 50, 2000).astype(np.int32)
    i = gen.integers(0, 30, 2000).astype(np.int32)
    m = als.train_als(u, i, np.ones(2000, np.float32), 50, 30, features=4, lam=0.1,
                      iterations=2, seed=1, packing=packing.PackingOptions(workers=2))
    assert packing.last_pack_stats["workers"] == 2 and np.isfinite(m.x).all()
    ok = np.ones(3, bool)
    out = als.fold_in_batch(m.y.T @ m.y, m.x.T @ m.x, m.x[:3], ok, m.y[:3], ok,
                            np.ones(3, np.float32), True, backend="device")
    assert np.isfinite(out[0]).all() and out[0].shape == (3, 4)
    step("als-train")
    # RDF: one generation trained by the port's forest ops on a file:
    # bus, served by the port's RDF serving layer. Its three trees draw
    # their bootstrap and feature subsets from the port's RandomManager:
    # unseeded, about one run in ten grew a forest that votes "neg" at
    # the probe point, so the test seed makes the forest the same each run
    from oryx_tpu_torch.common import rng
    rng.use_test_seed()
    rdf_tmp = tempfile.mkdtemp()
    rdf_cfg = config.get_default().with_overlay(f'''
        oryx {{
          id = "IsolatedRDF"
          input-topic.broker = "file:{rdf_tmp}/bus"
          update-topic.broker = "file:{rdf_tmp}/bus"
          input-schema {{ num-features = 3, numeric-features = ["0", "1"], target-feature = "2" }}
          rdf {{ num-trees = 3, hyperparams.max-depth = 3 }}
          ml.eval.test-fraction = 0
          batch.update-class = "oryx_tpu_torch.app.rdf.update:RDFUpdate"
          batch.storage {{ data-dir = "{rdf_tmp}/data/", model-dir = "{rdf_tmp}/model/" }}
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.rdf.serving:RDFServingModelManager"
            application-resources = "oryx_tpu_torch.app.rdf.serving"
          }}
        }}''')
    batch = BatchLayer(rdf_cfg)
    batch.prepare()
    with bus.get_broker(f"file:{rdf_tmp}/bus").producer("OryxInput") as p:
        for j in range(60):
            x0 = gen.uniform(-5, 5)
            p.send(None, f"{x0:.3f},{gen.uniform(-5, 5):.3f},{'pos' if x0 > 0 else 'neg'}")
    batch.run_one_generation(timestamp_ms=9)
    batch.close()
    rdf_serving = ServingLayer(rdf_cfg)
    rdf_serving.start()
    rdf_base = f"http://127.0.0.1:{rdf_serving.port}"
    deadline = time.monotonic() + 30
    while rdf_serving.model_manager.get_model() is None:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    with urllib.request.urlopen(rdf_base + "/predict/4.0,0.0,", timeout=10) as resp:
        assert json.loads(resp.read()) == "pos"
    rdf_serving.close()
    step("rdf")
    # the CLI's lint (python -m oryx_tpu_torch lint --select lockorder,torchhot),
    # under this interpreter's refusal of jax and of the JAX package
    import contextlib, io
    from oryx_tpu_torch import cli
    lint_out = io.StringIO()
    with contextlib.redirect_stdout(lint_out):
        lint_rc = cli.main(["lint", "--select", "lockorder,torchhot"])
    assert lint_rc == 0, lint_out.getvalue()
    assert lint_out.getvalue().splitlines()[-1].startswith("oryxlint: clean ("), lint_out.getvalue()
    step("lint")
    import chip_smoke  # the chip scripts import nothing of JAX either
    import scan_bench
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "oryx_tpu"
                    or m.startswith("oryx_tpu."))
    assert leaked == ["jax"], leaked  # only the None placeholder
    step("chip-scripts")
    print("ISOLATED-OK")
    """
)


# the isolated run's steps, in order; each writes "ISOLATED-STEP <name>
# <seconds since the start>" to stderr when it is done
STEPS = ("imports", "als-serving-float32", "als-serving-int8", "kmeans-lambda", "als-train",
         "rdf", "lint", "chip-scripts")


def isolated_steps(stderr) -> list[tuple[str, float]]:
    """(step, seconds since the start) of each step the run finished."""
    if isinstance(stderr, bytes):
        stderr = stderr.decode("utf-8", "replace")
    done = []
    for line in (stderr or "").splitlines():
        if line.startswith("ISOLATED-STEP "):
            _, name, seconds = line.split()
            done.append((name, float(seconds)))
    return done


def failed_step(stderr) -> str:
    """The step a failed or cut run was in: the one after the last it
    finished."""
    n = len(isolated_steps(stderr))
    return STEPS[n] if n < len(STEPS) else "after the last step"


def test_port_runs_without_jax_or_the_jax_package():
    from oryx_tpu_torch import native

    # A cold build of the native library waits on the build lock (which
    # the sanitized build holds for up to 240 s) and then compiles: under
    # the suite's parallel load that took most of the run's limit inside
    # the first serving step. The build runs here, outside the run's clock.
    native.get_library()
    try:
        out = subprocess.run(
            [sys.executable, "-c", _ISOLATED],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
        )
    except subprocess.TimeoutExpired as e:
        raise AssertionError(
            f"the isolated run was cut at 120 s in step {failed_step(e.stderr)!r}; "
            f"steps done: {isolated_steps(e.stderr)}"
        ) from None
    assert out.returncode == 0, (
        f"the isolated run failed in step {failed_step(out.stderr)!r}; steps done: "
        f"{isolated_steps(out.stderr)}\n{out.stderr[-4000:]}"
    )
    assert "ISOLATED-OK" in out.stdout
    assert [name for name, _ in isolated_steps(out.stderr)] == list(STEPS)
    print("isolated steps (s since start):", isolated_steps(out.stderr))


def test_isolated_step_lines_name_the_failed_step():
    """The step lines an isolated run writes, and the step a failure
    names, on a run that died in the k-means step (and on one that
    finished, and one that never started)."""
    stderr = ("noise\nISOLATED-STEP imports 2.50\nISOLATED-STEP als-serving-float32 3.10\n"
              "ISOLATED-STEP als-serving-int8 3.70\nTraceback (most recent call last):\n")
    assert isolated_steps(stderr) == [
        ("imports", 2.5), ("als-serving-float32", 3.1), ("als-serving-int8", 3.7)]
    assert failed_step(stderr) == "kmeans-lambda"
    assert failed_step(stderr.encode()) == "kmeans-lambda"
    assert failed_step(None) == "imports"
    done = "".join(f"ISOLATED-STEP {name} {i}.0\n" for i, name in enumerate(STEPS))
    assert failed_step(done) == "after the last step"
    assert [name for name, _ in isolated_steps(done)] == list(STEPS)


def test_native_loader_compiles_only_the_ports_sources(tmp_path, monkeypatch):
    """The port's native library is built from C++ sources under
    oryx_tpu_torch/ and nothing else: not the JAX package's copies."""
    from oryx_tpu_torch import native

    port_root = (ROOT / "oryx_tpu_torch").resolve()
    commands = []

    def record(cmd, **kw):
        commands.append(list(cmd))
        out = cmd[cmd.index("-o") + 1]
        Path(out).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, b"", b"")

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", record)
    so_path = native._build_library()
    assert so_path is not None and Path(so_path).parent == tmp_path
    assert len(commands) == 1
    sources = [a for a in commands[0] if a.endswith((".cpp", ".cc", ".c", ".cu"))]
    assert sources == native.source_paths()
    assert [Path(a).name for a in sources] == ["feature_store.cpp", "parse.cpp", "httpfront.cpp"]
    for a in sources:
        assert Path(a).resolve().is_relative_to(port_root), a
    # the library's name covers its sources: a second call builds nothing
    assert native._build_library() == so_path and len(commands) == 1


def test_native_front_source_is_the_jax_packages_byte_for_byte():
    assert (ROOT / "oryx_tpu_torch/native/httpfront.cpp").read_bytes() == (
        ROOT / "oryx_tpu/native/httpfront.cpp"
    ).read_bytes()


@pytest.mark.parametrize("name", ["feature_store.cpp", "parse.cpp"])
def test_native_store_and_parser_sources_are_the_jax_packages_byte_for_byte(name):
    assert (ROOT / "oryx_tpu_torch/native" / name).read_bytes() == (
        ROOT / "oryx_tpu/native" / name
    ).read_bytes()


def test_entry_points_raise_without_cuda_unless_cpu_chosen(monkeypatch):
    from oryx_tpu_torch.common import config
    from oryx_tpu_torch.lambda_.batch import BatchLayer
    from oryx_tpu_torch.lambda_.speed import SpeedLayer
    from oryx_tpu_torch.ops import als, kmeans, pallas_kmeans, streaming_topn, topn
    from oryx_tpu_torch.serving.layer import ServingLayer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("ORYX_CONF", raising=False)
    port_device.set_device(None)
    y = np.ones((10, 4), np.float32)
    with pytest.raises(RuntimeError, match="set_device"):
        port_device.default_device()
    with pytest.raises(RuntimeError, match="set_device"):
        topn.upload(y)
    with pytest.raises(RuntimeError, match="set_device"):
        topn.upload_queries(y)
    with pytest.raises(RuntimeError, match="set_device"):
        streaming_topn.handle_from_numpy(np.zeros((4, 16384), np.float32),
                                         np.zeros((1, 16384), np.float32), 10)
    with pytest.raises(RuntimeError, match="set_device"):
        ServingLayer(config.get_default())
    with pytest.raises(RuntimeError, match="set_device"):
        BatchLayer(config.get_default().with_overlay(
            'oryx.batch.update-class = "oryx_tpu_torch.app.kmeans.update:KMeansUpdate"'
        ))
    with pytest.raises(RuntimeError, match="set_device"):
        SpeedLayer(config.get_default().with_overlay(
            'oryx.speed.model-manager-class = '
            '"oryx_tpu_torch.app.kmeans.speed:KMeansSpeedModelManager"'
        ))
    with pytest.raises(RuntimeError, match="set_device"):
        kmeans.train_kmeans(y, 2, iterations=1)
    with pytest.raises(RuntimeError, match="set_device"):
        pallas_kmeans.lloyd(y, y[:2], 1)
    with pytest.raises(RuntimeError, match="set_device"):
        als.train_als(np.zeros(2, np.int32), np.zeros(2, np.int32), np.ones(2, np.float32),
                      1, 1, features=2, lam=0.1, iterations=1, seed=1)
    ok = np.ones(10, bool)
    with pytest.raises(RuntimeError, match="set_device"):
        als.fold_in_batch(np.eye(4), np.eye(4), y, ok, y, ok, np.ones(10, np.float32), True,
                          backend="device")
    try:
        port_device.set_device("cpu")
        assert topn.upload(y).device.type == "cpu"
    finally:
        port_device.set_device(None)
