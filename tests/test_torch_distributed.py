"""The port's ``parallel/distributed.py`` against the JAX package's, on the
CPU.

Two OS processes join one torch.distributed run through the port's
``maybe_initialize``, from the ``oryx.batch.compute.distributed.*`` keys
or from $ORYX_COORDINATOR / $ORYX_NUM_PROCESSES / $ORYX_PROCESS_ID, on
gloo, and run the JAX package's cross-process reduction
(tests/parallel/test_distributed.py: 1 + 2 = 3), the mesh's three
collectives, and mesh k-means and sharded-factor ALS over the two-rank
mesh, which rank 0 holds equal to the same runs over two shards in one
process. Each process has a time limit of its own, as the JAX test's
120 s. Missing keys raise the JAX package's ValueError; the compile
cache is a no-op when null, idempotent, and moves ``ops/_build``'s
directory.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.parallel import distributed as jdist
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.ops import _build
from oryx_tpu_torch.ops import als as tals
from oryx_tpu_torch.ops import kmeans as tkm
from oryx_tpu_torch.parallel import distributed
from oryx_tpu_torch.parallel.mesh import get_mesh

REPO = Path(__file__).resolve().parent.parent
PROCESS_TIMEOUT_S = 120

_RANK = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    from oryx_tpu_torch import device
    from oryx_tpu_torch.common import config as C
    from oryx_tpu_torch.parallel import distributed, mesh

    device.set_device("cpu")
    how, pid, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    cfg = C.get_default()
    if how == "config":
        cfg = cfg.with_overlay(
            'oryx.batch.compute.distributed {{\\n'
            f'  coordinator-address = "127.0.0.1:{{port}}"\\n'
            '  num-processes = 2\\n'
            f'  process-id = {{pid}}\\n'
            '}}'
        )
    assert distributed.maybe_initialize(cfg)
    assert distributed.maybe_initialize(cfg)  # idempotent
    assert distributed.world_size() == 2 and distributed.rank() == pid
    print("BACKEND", distributed.backend())
    m = mesh.get_mesh()
    assert m.multiprocess and m.size == 2 and m.local == [pid], m
    total = mesh.all_reduce_sum(m, [torch.ones(1) * (pid + 1)])[0]
    assert float(total) == 3.0, float(total)
    assert mesh.all_gather(m, [torch.tensor([pid])])[0].tolist() == [0, 1]
    assert mesh.ring_shift(m, [torch.tensor([pid])])[0].tolist() == [(pid + 1) % 2]
    if how == "config":
        from oryx_tpu_torch.ops import als, kmeans
        gen = np.random.default_rng(3)
        pts = gen.standard_normal((1001, 4)).astype(np.float32)
        c, n, cost = kmeans.train_kmeans(pts, 4, iterations=4, mesh=m,
                                         initial_centers=pts[:4].copy())
        u = gen.integers(0, 30, 400).astype(np.int32)
        i = gen.integers(0, 20, 400).astype(np.int32)
        v = (gen.random(400) + 0.5).astype(np.float32)
        model = als.train_als(u, i, v, 30, 20, features=3, lam=0.1, alpha=1.0, iterations=2,
                              seed=4, mesh=m, shard_factors=True)
        if pid == 0:
            np.savez(out, c=c, n=n, cost=cost, x=model.x, y=model.y)
    distributed.shutdown()
    print("DIST_OK", pid)
    """
).format(repo=str(REPO))


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, how: str) -> list[str]:
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    port = str(_free_port())
    out = str(tmp_path / "rank0.npz")
    procs = []
    for pid in (0, 1):
        env = {k: v for k, v in os.environ.items() if not k.startswith("ORYX_")}
        if how == "env":
            env.update(ORYX_COORDINATOR=f"127.0.0.1:{port}", ORYX_NUM_PROCESSES="2",
                       ORYX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-u", str(script), how, str(pid), port, out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        ))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{text}"
        assert f"DIST_OK {pid}" in text and "BACKEND gloo" in text
    return outs


def test_two_processes_join_from_the_config_keys(tmp_path):
    """The JAX package's two-process reduction, then mesh k-means and
    sharded-factor ALS over the two ranks: rank 0's results equal the
    same runs over two shards in one process (gloo's sum of two addends
    is the in-process sum's)."""
    _run_ranks(tmp_path, "config")
    got = np.load(tmp_path / "rank0.npz")
    m = get_mesh(devices=["cpu"] * 2)
    gen = np.random.default_rng(3)
    pts = gen.standard_normal((1001, 4)).astype(np.float32)
    c, n, cost = tkm.train_kmeans(pts, 4, iterations=4, mesh=m, initial_centers=pts[:4].copy())
    u = gen.integers(0, 30, 400).astype(np.int32)
    i = gen.integers(0, 20, 400).astype(np.int32)
    v = (gen.random(400) + 0.5).astype(np.float32)
    model = tals.train_als(u, i, v, 30, 20, features=3, lam=0.1, alpha=1.0, iterations=2,
                           seed=4, mesh=m, shard_factors=True)
    np.testing.assert_array_equal(got["n"], n)
    np.testing.assert_array_equal(got["c"], c)
    assert float(got["cost"]) == cost
    np.testing.assert_array_equal(got["x"], model.x)
    np.testing.assert_array_equal(got["y"], model.y)


def test_two_processes_join_from_the_environment(tmp_path):
    _run_ranks(tmp_path, "env")


@pytest.mark.parametrize("missing", ["num-processes", "process-id", "both"])
def test_missing_keys_raise_the_jax_packages_error(missing, monkeypatch):
    for var in ("ORYX_COORDINATOR", "ORYX_NUM_PROCESSES", "ORYX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    keys = {"coordinator-address": '"127.0.0.1:1"', "num-processes": "2", "process-id": "0"}
    if missing == "both":
        del keys["num-processes"], keys["process-id"]
    else:
        del keys[missing]
    overlay = "oryx.batch.compute.distributed { " + ", ".join(
        f"{k} = {v}" for k, v in keys.items()) + " }"
    errors = []
    for mod, conf in ((jdist, jconfig), (distributed, tconfig)):
        with pytest.raises(ValueError) as err:
            mod.maybe_initialize(conf.get_default().with_overlay(overlay))
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert not distributed.is_initialized()
    # without any of the keys, both stay single-process
    assert distributed.maybe_initialize(tconfig.get_default()) is False
    assert jdist.maybe_initialize(jconfig.get_default()) is False


def test_compile_cache_dir(tmp_path):
    """Null: a no-op. Set: ``_build`` builds and loads there, a second call
    (another layer in the process) changes nothing, and only kernels not
    yet loaded are affected."""
    build_dir = _build.BUILD_DIR
    try:
        distributed._cache_dir = None
        distributed.maybe_enable_compile_cache(tconfig.get_default())
        assert distributed._cache_dir is None and _build.BUILD_DIR == build_dir
        cfg = tconfig.get_default().with_overlay(
            f'oryx.compute.compile-cache-dir = "{tmp_path}/kernels"')
        distributed.maybe_enable_compile_cache(cfg)
        assert (tmp_path / "kernels").is_dir()
        assert _build.BUILD_DIR == tmp_path / "kernels"
        for name in _build.SOURCES:
            assert _build.library_path(name).parent == tmp_path / "kernels"
            assert _build.log_path(name).parent == tmp_path / "kernels"
        distributed.maybe_enable_compile_cache(tconfig.get_default().with_overlay(
            f'oryx.compute.compile-cache-dir = "{tmp_path}/elsewhere"'))
        assert _build.BUILD_DIR == tmp_path / "kernels"
        assert not (tmp_path / "elsewhere").exists()
    finally:
        distributed._cache_dir = None
        _build.set_build_dir(build_dir)
