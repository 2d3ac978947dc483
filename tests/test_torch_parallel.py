"""The port's ``parallel/mesh.py`` against the JAX package's
``oryx_tpu/parallel/mesh.py``, on the CPU.

The JAX package meshes the suite's eight virtual CPU devices
(tests/conftest.py); the port names eight CPU shards
(``device_scope(["cpu"] * 8)`` or ``get_mesh(devices=...)``). Covered:
device scopes per thread, ``partition_devices``, ``get_mesh`` with a spec
and its errors, ``mesh_from_config``, the three collectives against
numpy, shard-items serving against the JAX package's model, and two
hyperparameter candidates training at once on disjoint sub-meshes.
"""

import threading

import numpy as np
import pytest
import torch

from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu.common import config as jconfig
from oryx_tpu.parallel import mesh as jmesh
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import rng as trng
from oryx_tpu_torch.parallel import mesh

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    trng.use_test_seed()
    yield
    trng.clear_test_seed()
    port_device.set_device(None)
    InProcessBroker.reset_all()


def _mesh_config(conf, spec):
    overlay = "" if spec is None else f"oryx.batch.compute.mesh {{ {spec} }}"
    return conf.get_default().with_overlay(overlay)


# -- scopes, partitions, meshes ---------------------------------------------------


def test_scoped_devices_default_to_the_chosen_cpu_and_never_silently():
    assert mesh.scoped_devices() == [mesh.Placement(torch.device("cpu"), 0)]
    port_device.set_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.scoped_devices()


def test_device_scope_is_per_thread():
    """A scope holds in its thread only; a thread started inside it starts
    with none (the candidates' and the batcher's threads inherit nothing)."""
    seen = {}

    def other():
        seen["other"] = mesh.scoped_devices()

    with mesh.device_scope(CPU8):
        assert len(mesh.scoped_devices()) == 8
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with mesh.device_scope(CPU8[:2]):
            assert len(mesh.scoped_devices()) == 2
        assert len(mesh.scoped_devices()) == 8
    assert len(seen["other"]) == 1
    assert len(mesh.scoped_devices()) == 1


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 8, 16])
def test_partition_devices_matches_jax(groups):
    """Disjoint contiguous groups, as many and as large as the JAX package
    forms on its eight devices."""
    want = jmesh.partition_devices(groups)
    scope = [mesh.Placement(torch.device("cpu"), 0) for _ in range(8)]
    with mesh.device_scope(scope):
        got = mesh.partition_devices(groups)
    assert [len(g) for g in got] == [len(g) for g in want]
    per = len(got[0])
    for g, group in enumerate(got):
        assert [id(p) for p in group] == [id(p) for p in scope[g * per : (g + 1) * per]]


@pytest.mark.parametrize("spec", [None, {"data": 8}, {"data": 4}, {"data": 2, "model": 4}])
def test_get_mesh_shapes_match_jax(spec):
    want = jmesh.get_mesh(spec)
    got = mesh.get_mesh(spec, devices=CPU8)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape and got.size == want.devices.size
    assert got.local == list(range(got.size)) and not got.multiprocess


def test_get_mesh_errors_match_jax():
    with pytest.raises(ValueError) as jerr:
        jmesh.get_mesh({"data": 16})
    with pytest.raises(ValueError) as terr:
        mesh.get_mesh({"data": 16}, devices=CPU8)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="no shard of this process"):
        mesh.get_mesh(devices=[mesh.Placement(torch.device("cpu"), 1)])


@pytest.mark.parametrize("spec", [None, "data = 8", "data = 1"])
def test_mesh_from_config_rules_match_jax(spec):
    """An explicit spec takes that many devices; no spec over several
    devices is all of them on 'data'; over one device, None."""
    want = jmesh.mesh_from_config(_mesh_config(jconfig, spec))
    with mesh.device_scope(CPU8):
        got = mesh.mesh_from_config(_mesh_config(tconfig, spec))
    assert got.shape == dict(want.shape)
    assert mesh.mesh_from_config(_mesh_config(tconfig, None)) is None  # the one chosen CPU
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        mesh.mesh_from_config(_mesh_config(tconfig, "data = 8"))


def test_put_and_pad_to_multiple():
    m = mesh.get_mesh(devices=CPU8[:4])
    a = np.arange(24, dtype=np.float32).reshape(12, 2)
    parts = mesh.put(a, mesh.shard_rows(m))
    assert [p.shape for p in parts] == [(3, 2)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), a)
    reps = mesh.put(a, mesh.replicated(m))
    assert all(r is reps[0] for r in reps)  # one copy per device
    assert mesh.data_sharding(m, 3).spec == ("data", None, None)
    assert [mesh.pad_to_multiple(n, 8) for n in (0, 1, 8, 9)] == [
        jmesh.pad_to_multiple(n, 8) for n in (0, 1, 8, 9)
    ]
    with pytest.raises(ValueError, match="evenly"):
        mesh.put(a[:10], mesh.shard_rows(m))


# -- collectives ------------------------------------------------------------------


def test_collectives_against_numpy():
    """all_gather (tiled), all_reduce_sum and ring_shift (shard s receives
    shard s + 1's) on eight CPU shards."""
    m = mesh.get_mesh(devices=CPU8)
    gen = np.random.default_rng(1)
    parts = [gen.standard_normal((3, 2)).astype(np.float32) for _ in range(8)]
    tensors = [torch.from_numpy(p) for p in parts]
    gathered = mesh.all_gather(m, tensors)
    assert len(gathered) == 8
    for g in gathered:
        np.testing.assert_array_equal(g.numpy(), np.concatenate(parts))
    summed = mesh.all_reduce_sum(m, tensors)
    total = parts[0].copy()
    for p in parts[1:]:
        total = total + p  # shard order, in float32
    for s in summed:
        np.testing.assert_array_equal(s.numpy(), total)
    shifted = mesh.ring_shift(m, tensors)
    for s in range(8):
        np.testing.assert_array_equal(shifted[s].numpy(), parts[(s + 1) % 8])
    with pytest.raises(ValueError, match="local shards"):
        mesh.all_reduce_sum(m, tensors[:7])


def test_ring_shift_s_steps_come_home():
    m = mesh.get_mesh(devices=CPU8[:5])
    cur = [torch.full((2,), float(s)) for s in range(5)]
    for t in range(5):
        assert [int(c[0]) for c in cur] == [(s + t) % 5 for s in range(5)]
        cur = mesh.ring_shift(m, cur)
    assert [int(c[0]) for c in cur] == list(range(5))


# -- shard-items serving ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_shard_items_serving_matches_jax(dtype):
    """``shard-items``: Y row-shards over eight CPU shards (the JAX package
    over its eight devices) and top_n answers the JAX package's sharded
    model's ids; float32 values within 1e-5, bf16 and int8 within their
    score precision (the int8 shard rescores its candidates where the JAX
    scan sums both planes)."""
    gen = np.random.default_rng(8)
    ys = gen.standard_normal((1000, 8), dtype=np.float32)
    ys[17] = 0.0  # a cold item scores 0, as on one device
    q = gen.standard_normal(8, dtype=np.float32)
    models = {}
    for name, sm in (("jax", jsm), ("torch", tsm)):
        m = sm.ALSServingModel(8, True, refresh_sec=0.0, score_dtype=dtype, shard_items=True)
        m.set_item_vectors([f"i{i}" for i in range(1000)], ys)
        models[name] = m
    with mesh.device_scope(CPU8):
        got = models["torch"].top_n(q, 10)
        got_excl = models["torch"].top_n(q, 5, exclude={got[0][0]})
        handle = models["torch"]._ensure_y_matrix()[2]
    want = models["jax"].top_n(q, 10)
    want_excl = models["jax"].top_n(q, 5, exclude={want[0][0]})
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=2.0**-7, atol=1e-3)
    assert [i for i, _ in got] == [i for i, _ in want]
    assert [i for i, _ in got_excl] == [i for i, _ in want_excl]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], **tol)
    assert len(handle.shards) == 8 and handle.per == 125
    assert not models["torch"]._x_staging
    for m in models.values():
        m.close()


# -- candidates on disjoint sub-meshes ----------------------------------------------


def test_candidates_train_at_once_on_disjoint_sub_meshes(tmp_path):
    """``oryx.ml.eval.parallelism = 2`` with eight CPU shards in scope: the
    two candidates build at once (each waits for the other inside
    build_model), each in the scope of its own four shards, as the JAX
    package's MLUpdate partitions its eight devices."""
    from oryx_tpu_torch.bus.core import KeyMessage
    from oryx_tpu_torch.ml.update import MLUpdate

    both_in = threading.Barrier(2, timeout=30)
    seen = {}

    class Probe(MLUpdate):
        def get_hyper_parameter_values(self):
            return []

        def build_model(self, train_data, hyper_parameters, candidate_path):
            both_in.wait()
            seen[int(hyper_parameters[0])] = [id(p) for p in mesh.scoped_devices()]
            from xml.etree.ElementTree import Element

            return Element("PMML")

        def evaluate(self, model, model_parent_path, test_data, train_data):
            return 1.0

    cfg = tconfig.get_default().with_overlay(
        "oryx.ml.eval { candidates = 2, parallelism = 2, test-fraction = 0.5 }"
    )
    upd = Probe(cfg)
    shards = [mesh.Placement(torch.device("cpu"), 0) for _ in range(8)]
    want = [len(g) for g in jmesh.partition_devices(2)]
    with mesh.device_scope(shards):
        best = upd._find_best_candidate(
            tmp_path, [[2], [3]], [KeyMessage(None, "x")], [KeyMessage(None, "y")]
        )
    assert best is not None
    assert sorted(seen) == [2, 3]
    assert [len(seen[k]) for k in (2, 3)] == want == [4, 4]
    assert not set(seen[2]) & set(seen[3])  # disjoint shards
    assert sorted(seen[2] + seen[3]) == sorted(id(p) for p in shards)
