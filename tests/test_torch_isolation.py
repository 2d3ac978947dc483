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
# the serving path answers over HTTP on the CPU, the k-means batch path
# trains one generation, and chip_smoke.py imports.
_ISOLATED = textwrap.dedent(
    r"""
    import importlib.abc, json, pkgutil, sys, time, urllib.request

    sys.modules["jax"] = None

    class _RefuseJaxPackage(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "oryx_tpu" or name.startswith("oryx_tpu."):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, _RefuseJaxPackage())

    import numpy as np
    import oryx_tpu_torch

    for info in pkgutil.walk_packages(oryx_tpu_torch.__path__, "oryx_tpu_torch."):
        importlib.import_module(info.name)

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
    # the k-means batch path: one generation, trained through the sweep
    from oryx_tpu_torch.lambda_.batch import BatchLayer
    import tempfile
    tmp = tempfile.mkdtemp()
    batch = BatchLayer(config.get_default().with_overlay(f'''
        oryx {{
          input-topic.broker = "inproc://isolated-kmeans"
          update-topic.broker = "inproc://isolated-kmeans"
          input-schema {{ num-features = 2, numeric-features = ["0", "1"] }}
          kmeans.hyperparams.k = 2
          batch.update-class = "oryx_tpu_torch.app.kmeans.update:KMeansUpdate"
          batch.storage {{ data-dir = "{tmp}/data/", model-dir = "{tmp}/model/" }}
        }}'''))
    batch.prepare()
    with bus.get_broker("inproc://isolated-kmeans").producer("OryxInput") as p:
        for j in range(40):
            p.send(None, f"{(j % 2) * 10 + gen.standard_normal():.3f},{gen.standard_normal():.3f}")
    batch.run_one_generation(timestamp_ms=5)
    batch.close()
    assert pmml.read_pmml(f"{tmp}/model/5/model.pmml") is not None
    import chip_smoke  # the chip script imports nothing of JAX either
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "oryx_tpu"
                    or m.startswith("oryx_tpu."))
    assert leaked == ["jax"], leaked  # only the None placeholder
    print("ISOLATED-OK")
    """
)


def test_port_runs_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATED],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "ISOLATED-OK" in out.stdout


def test_entry_points_raise_without_cuda_unless_cpu_chosen(monkeypatch):
    from oryx_tpu_torch.common import config
    from oryx_tpu_torch.lambda_.batch import BatchLayer
    from oryx_tpu_torch.ops import kmeans, pallas_kmeans, streaming_topn, topn
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
        kmeans.train_kmeans(y, 2, iterations=1)
    with pytest.raises(RuntimeError, match="set_device"):
        pallas_kmeans.lloyd(y, y[:2], 1)
    try:
        port_device.set_device("cpu")
        assert topn.upload(y).device.type == "cpu"
    finally:
        port_device.set_device(None)
