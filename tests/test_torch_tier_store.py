"""The port's tiered HBM->RAM->disk cell store (``oryx_tpu_torch/native/
store.py``: the ts_* C++ store, its Python twin and ``TieredHostPlane``)
against the JAX package's, on the CPU.

Every case of tests/native/test_tier_store.py runs on both store kinds,
each beside the JAX package's store of the same kind fed the same
seeded cells and the same calls: the same bytes, residency codes and
counters. The IVF host stage-1 scan over a tiered plane equals the
port's flat scan and the JAX package's tiered scan (ids exact, scores
bit for bit). The batcher hints the cells a group will probe, and a
failing hint fails no dispatch. ``oryx.serving.store.tier.*`` reaches
the store through ``ServingLayer``, ``ALSServingModelManager`` takes
it, and the maintainer's compaction lands in a fresh tiered plane.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from oryx_tpu.native import get_library as jax_library
from oryx_tpu.native import store as jstore
from oryx_tpu.ops import ivf as jivf
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.app.als.serving_model import ALSServingModel
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.native import get_library
from oryx_tpu_torch.native import store
from oryx_tpu_torch.native.store import (
    TIER_ABSENT,
    TIER_DISK,
    TIER_RAM,
    PyTieredCellStore,
    TieredHostPlane,
    configure_tier,
    tier_config,
)
from oryx_tpu_torch.ops import ivf as tivf
from oryx_tpu_torch.serving import maintain as tmaintain
from oryx_tpu_torch.serving.batcher import TopNBatcher
from oryx_tpu_torch.serving.layer import ServingLayer

_HAVE_NATIVE = get_library() is not None and jax_library() is not None
_ANN_KNOBS = (
    "ANN_ENABLED", "N_CELLS", "NPROBE", "PROBE_FRACTION", "MIN_ITEMS",
    "OVERLAY_CAPACITY", "QUERY_BLOCK", "TILE_CHUNKS", "HOST_STAGE1",
)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU; the ANN and tier knobs are module globals of
    both packages: leave no residue."""
    port_device.set_device("cpu")
    saved = [(mod, name, getattr(mod, name)) for mod in (jivf, tivf) for name in _ANN_KNOBS]
    tiers = (tier_config(), jstore.tier_config())
    yield
    for mod, name, value in saved:
        setattr(mod, name, value)
    configure_tier(**tiers[0])
    jstore.configure_tier(**tiers[1])
    port_device.set_device(None)
    InProcessBroker.reset_all()


def _make_stores(kind, n_cells, budget, tmp_path):
    """(the port's store, the JAX package's store) of one kind, each in a
    directory of its own."""
    if kind == "native":
        if not _HAVE_NATIVE:
            pytest.skip("native library unavailable")
        mk = (store.NativeTieredCellStore, jstore.NativeTieredCellStore)
    else:
        mk = (PyTieredCellStore, jstore.PyTieredCellStore)
    out = []
    for cls, sub in zip(mk, ("port", "jax")):
        (tmp_path / sub).mkdir()
        out.append(cls(n_cells, budget, str(tmp_path / sub)))
    return out


@pytest.fixture(params=["python", "native"])
def store_kind(request):
    return request.param


def _stable_stats(st):
    return {k: v for k, v in st.stats().items() if k != "queue_len"}


def assert_same_stores(port, jax):
    np.testing.assert_array_equal(port.residency(), jax.residency())
    assert _stable_stats(port) == _stable_stats(jax)


def _wait_resident(stores, cells):
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if all((st.residency()[cells] == TIER_RAM).all() for st in stores):
            return
        time.sleep(0.02)


def test_put_read_roundtrip_and_residency(store_kind, tmp_path):
    stores = _make_stores(store_kind, 8, 1 << 20, tmp_path)
    try:
        gen = np.random.default_rng(0)
        cells = {c: gen.standard_normal((16, 8)).astype(np.float32) for c in (0, 3, 7)}
        for st in stores:
            for c, data in cells.items():
                st.put_cell(c, data)
            res = st.residency()
            assert res[1] == TIER_ABSENT and st.read_cell(1) is None
            for c in cells:
                assert res[c] in (TIER_DISK, TIER_RAM)
            for c, data in cells.items():
                np.testing.assert_array_equal(st.read_cell(c).view(np.float32).reshape(16, 8), data)
            assert st.residency()[0] == TIER_RAM  # a read promotes
            s = st.stats()
            assert s["disk_cells"] == 3 and s["ram_cells"] >= 1
            st.put_cell(3, cells[3] * 2.0)  # rewrite supersedes
            np.testing.assert_array_equal(
                st.read_cell(3).view(np.float32).reshape(16, 8), cells[3] * 2.0
            )
            assert st.cell_bytes(3) == 16 * 8 * 4 and st.cell_bytes(1) == -1
        assert_same_stores(*stores)
    finally:
        for st in stores:
            st.close()


def test_ram_budget_evicts_lru(store_kind, tmp_path):
    cell_bytes = 16 * 8 * 4
    stores = _make_stores(store_kind, 8, int(cell_bytes * 2.5), tmp_path)
    try:
        for st in stores:
            gen = np.random.default_rng(1)
            for c in range(6):
                st.put_cell(c, gen.standard_normal((16, 8)).astype(np.float32))
            for c in range(6):
                st.read_cell(c)
            s = st.stats()
            assert s["ram_cells"] <= 2 and s["demotions"] >= 4
            assert s["ram_bytes"] <= int(cell_bytes * 2.5)
            res = st.residency()  # the LAST reads stayed; the first were evicted
            assert res[5] == TIER_RAM and res[0] == TIER_DISK
        assert_same_stores(*stores)
    finally:
        for st in stores:
            st.close()


def test_prefetch_promotes_async(store_kind, tmp_path):
    stores = _make_stores(store_kind, 4, 1 << 20, tmp_path)
    try:
        for st in stores:
            gen = np.random.default_rng(2)
            for c in range(4):
                st.put_cell(c, gen.standard_normal((8, 4)).astype(np.float32))
            assert st.prefetch(np.array([0, 2], np.int64)) == 2
            assert st.prefetch(np.array([], np.int64)) == 0
        _wait_resident(stores, [0, 2])
        for st in stores:
            res = st.residency()
            assert res[0] == TIER_RAM and res[2] == TIER_RAM
            assert res[1] == TIER_DISK and res[3] == TIER_DISK
            m0 = st.stats()["misses"]
            st.read_cell(0)  # prefetched cells hit without a scan-path miss
            assert st.stats()["misses"] == m0
            st.drop_ram(0)
            assert st.residency()[0] == TIER_DISK
        assert_same_stores(*stores)
    finally:
        for st in stores:
            st.close()


def test_configure_tier_roundtrip():
    for mod in (store, jstore):
        cfg = mod.configure_tier(enabled=True, hot_cells=7, ram_bytes=123, spill_dir="/x")
        assert cfg["enabled"] and cfg["hot_cells"] == 7
        assert cfg["ram_bytes"] == 123 and cfg["spill_dir"] == "/x"
        cfg = mod.configure_tier(hot_cells=9)  # None leaves knobs unchanged
        assert cfg["hot_cells"] == 9 and cfg["ram_bytes"] == 123
        assert mod.tier_active()
    assert tier_config() == jstore.tier_config()


def _plane_case(n_cells=6, tiles_per_cell=(2, 1, 3, 1, 2, 1), ts=8, kf=16, seed=3):
    gen = np.random.default_rng(seed)
    counts = np.asarray(tiles_per_cell, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    plane = gen.standard_normal((int(counts.sum()) * ts, kf)).astype(np.float32)
    cents = gen.standard_normal((kf, n_cells)).astype(np.float32)
    return plane, starts, counts, ts, kf, cents, np.linalg.norm(cents, axis=0)


def _planes(tmp_path, hot_cells, seed=3):
    plane, starts, counts, ts, kf, cents, cnorms = _plane_case(seed=seed)
    out = []
    for cls, sub in ((TieredHostPlane, "port"), (jstore.TieredHostPlane, "jax")):
        out.append(cls.build(
            plane, tile_start=starts, tile_count=counts, tile_slots=ts, centroids=cents,
            centroid_norms=cnorms, hot_cells=hot_cells, ram_bytes=1 << 20,
            spill_dir=str(tmp_path / sub),
        ))
    return out, (plane, starts, ts, cents, cnorms)


def test_tiered_plane_gather_matches_flat(tmp_path):
    planes, (plane, _, ts, cents, cnorms) = _planes(tmp_path, hot_cells=2)
    try:
        tl = np.array([0, 3, 9, 4, 0, 7], np.int64)  # repeats + disorder
        want = np.concatenate([plane[t * ts : (t + 1) * ts] for t in tl.tolist()])
        for tp in planes:
            np.testing.assert_array_equal(tp.gather_tiles(tl), want)
            c, n = tp.routing_arrays()
            np.testing.assert_array_equal(c, cents)
            np.testing.assert_array_equal(n, cnorms)
            assert tp.stats()["hot_cells"] <= 2  # hot LRU bounded
        assert planes[0].stats() == planes[1].stats()
    finally:
        for tp in planes:
            tp.close()


def test_planes_sharing_a_spill_dir_keep_their_own_cells(tmp_path):
    """A compaction builds the next plane while the last one serves: with
    one configured spill dir each plane's store sits in a directory of
    its own, and a plane that no handle holds removes it."""
    import gc

    plane, starts, counts, ts, kf, cents, cnorms = _plane_case(seed=9)
    build = lambda p: TieredHostPlane.build(  # noqa: E731
        p, tile_start=starts, tile_count=counts, tile_slots=ts, centroids=cents,
        centroid_norms=cnorms, hot_cells=1, ram_bytes=0, spill_dir=str(tmp_path))
    old, new = build(plane), build(2.0 * plane)
    tl = np.arange(int(counts.sum()), dtype=np.int64)
    np.testing.assert_array_equal(old.gather_tiles(tl), plane)
    np.testing.assert_array_equal(new.gather_tiles(tl), 2.0 * plane)
    assert len(list(tmp_path.iterdir())) == 2
    del old
    gc.collect()
    assert len(list(tmp_path.iterdir())) == 1
    new.close()
    new.close()  # idempotent
    assert list(tmp_path.iterdir()) == []


def test_tiered_plane_prefetch_counters(tmp_path):
    (tp, jtp), (_, starts, *_) = _planes(tmp_path, hot_cells=1, seed=5)
    try:
        hit0 = metrics.registry.counter("serving.store.prefetch.hit").value
        miss0 = metrics.registry.counter("serving.store.prefetch.miss").value
        assert tp.prefetch_cells(np.array([2], np.int64)) == 1
        deadline = 50
        while deadline and tp._store.residency()[2] != TIER_RAM:
            threading.Event().wait(0.02)
            deadline -= 1
        tp.gather_tiles(np.array([int(starts[2])], np.int64))  # warm -> hit
        assert metrics.registry.counter("serving.store.prefetch.hit").value == hit0 + 1
        tp.gather_tiles(np.array([int(starts[4])], np.int64))  # cold -> miss
        assert metrics.registry.counter("serving.store.prefetch.miss").value == miss0 + 1
        # gauges published: one hot cell, every cell on disk, the warm tier's
        assert metrics.registry.gauge("serving.store.tier.hbm.cells").value == 1
        assert metrics.registry.gauge("serving.store.tier.disk.cells").value == 6
        assert metrics.registry.gauge("serving.store.tier.ram.cells").value == 2
        # the same calls on the JAX package's plane end in the same state
        jtp.prefetch_cells(np.array([2], np.int64))
        _wait_resident([jtp._store], [2])
        jtp.gather_tiles(np.array([int(starts[2])], np.int64))
        jtp.gather_tiles(np.array([int(starts[4])], np.int64))
        assert tp.stats() == jtp.stats()
    finally:
        tp.close()
        jtp.close()


def test_concurrent_readers_and_prefetch(store_kind, tmp_path):
    """Hammer reads + prefetch + drops from several threads: no torn
    payloads, counters stay coherent."""
    st, jst = _make_stores(store_kind, 16, 4 * 16 * 8 * 4, tmp_path)
    try:
        gen = np.random.default_rng(11)
        ref = {}
        for c in range(16):
            ref[c] = gen.standard_normal((16, 8)).astype(np.float32)
            st.put_cell(c, ref[c])
            jst.put_cell(c, ref[c])
        errs = []

        def reader(seed):
            r = np.random.default_rng(seed)
            for _ in range(200):
                c = int(r.integers(0, 16))
                buf = st.read_cell(c)
                if buf is None or not np.array_equal(buf.view(np.float32).reshape(16, 8), ref[c]):
                    errs.append(c)

        def churner():
            r = np.random.default_rng(99)
            for _ in range(200):
                st.prefetch(r.integers(0, 16, 4).astype(np.int64))
                st.drop_ram(int(r.integers(0, 16)))

        threads = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
        threads.append(threading.Thread(target=churner))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        s = st.stats()
        assert s["disk_cells"] == jst.stats()["disk_cells"] == 16
        assert s["hits"] + s["misses"] == 4 * 200
    finally:
        st.close()
        jst.close()


# -- the IVF host stage-1 scan over a tiered plane --------------------------------


def _clustered(n=6_000, f=24, centers=16, b=4, seed=7):
    gen = np.random.default_rng(seed)
    c = gen.standard_normal((centers, f)).astype(np.float32)
    mat = (c[gen.integers(0, centers, n)] + 0.3 * gen.standard_normal((n, f))).astype(np.float32)
    q = (c[gen.integers(0, centers, b)] + 0.3 * gen.standard_normal((b, f))).astype(np.float32)
    return mat, q


@pytest.mark.parametrize("cosine", [False, True])
def test_attach_tiered_plane_scan_parity(tmp_path, cosine):
    """The port's tiered scan is its flat scan and the JAX package's
    tiered scan: ids exact, scores bit for bit, probed and full probe."""
    mat, queries = _clustered()
    jivf.configure_ann(host_stage1=True)
    tivf.configure_ann(host_stage1=True)
    cents = np.ascontiguousarray(np.asarray(jivf.build_ivf(mat, n_cells=16, seed=1).centroids_t).T[:, :24])
    flat = tivf.build_ivf(mat, centroids=cents)
    assert flat.host_plane is not None and flat.tier is None
    configure_tier(enabled=True, hot_cells=4, ram_bytes=1 << 20, spill_dir=str(tmp_path / "port"))
    jstore.configure_tier(enabled=True, hot_cells=4, ram_bytes=1 << 20,
                          spill_dir=str(tmp_path / "jax"))
    tiered = tivf.attach_tiered_plane(tivf.build_ivf(mat, centroids=cents))
    jtiered = jivf.attach_tiered_plane(jivf.build_ivf(mat, centroids=cents))
    assert tiered.tier is not None and tiered.host_plane is None
    assert tivf.attach_tiered_plane(tiered) is tiered  # already tiered: a no-op
    try:
        for nprobe in (4, 16):
            fi, fv = tivf.top_k(flat, queries, 10, nprobe=nprobe, cosine=cosine)
            ti, tv = tivf.top_k(tiered, queries, 10, nprobe=nprobe, cosine=cosine)
            ji, jv = jivf.top_k(jtiered, queries, 10, nprobe=nprobe, cosine=cosine)
            assert np.array_equal(ti, fi) and np.array_equal(ti, np.asarray(ji))
            assert np.array_equal(tv.view(np.uint32), fv.view(np.uint32))
            if nprobe < 16:  # the same numpy code on the same plane
                assert np.array_equal(tv.view(np.uint32), np.asarray(jv).view(np.uint32))
        res = tiered.tier._store.residency()
        assert (res != TIER_ABSENT).sum() == int((tiered.tile_count_host > 0).sum())
        # the advisory prefetch hint names the same cells as the JAX package's
        assert tiered.prefetch_for_queries(queries, nprobe=4) == jtiered.prefetch_for_queries(
            queries, nprobe=4)
        assert tiered.prefetch_for_queries(queries, nprobe=16) == 0  # full probe: no target
        assert flat.prefetch_for_queries(queries, nprobe=4) == 0  # no tier
    finally:
        tiered.tier.close()
        jtiered.tier.close()


def test_attach_tiered_plane_is_the_identity_while_tiering_is_off():
    mat, _ = _clustered(n=2_000)
    tivf.configure_ann(host_stage1=True)
    configure_tier(enabled=False)
    index = tivf.build_ivf(mat, n_cells=8, seed=1)
    assert tivf.attach_tiered_plane(index) is index
    tivf.configure_ann(host_stage1=False)
    configure_tier(enabled=True)
    device_path = tivf.build_ivf(mat, n_cells=8, seed=1)
    assert tivf.attach_tiered_plane(device_path) is device_path  # no host plane to move


def test_batcher_hints_the_probed_cells(tmp_path, monkeypatch):
    mat, queries = _clustered()
    tivf.configure_ann(host_stage1=True, nprobe=4)
    configure_tier(enabled=True, hot_cells=2, ram_bytes=1 << 16, spill_dir=str(tmp_path))
    index = tivf.attach_tiered_plane(tivf.build_ivf(mat, n_cells=16, seed=1))
    hinted = []
    real = index.tier.prefetch_cells
    monkeypatch.setattr(index.tier, "prefetch_cells", lambda cells: hinted.append(
        np.asarray(cells).tolist()) or real(cells))
    want_ids, _ = tivf.top_k(index, queries[:1], 10)
    hinted.clear()
    batcher = TopNBatcher()
    try:
        ids, _ = batcher.score(index, queries[0], 10)
        assert np.array_equal(np.asarray(ids)[:10], want_ids[0])
        # the batcher's hint (the query's 4 cells), then the scan's own
        # prefetch for the padded batch (its zero rows route too)
        assert len(hinted) == 2 and len(hinted[0]) == 4 and set(hinted[0]) <= set(hinted[1])
        # a hint that raises never fails the dispatch
        monkeypatch.setattr(tivf.IVFIndex, "prefetch_for_queries",
                            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("hint")))
        ids, _ = batcher.score(index, queries[0], 10)
        assert np.array_equal(np.asarray(ids)[:10], want_ids[0])
    finally:
        batcher.close()
        index.tier.close()


# -- configuration: the layer, the model manager and the maintainer ---------------------


def _serving_config(extra: str):
    return tconfig.get_default().with_overlay(f"""
        oryx {{
          input-topic.broker = "inproc://tier-cfg"
          update-topic.broker = "inproc://tier-cfg"
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"
            application-resources = "oryx_tpu_torch.app.als.endpoints"
          }}
          {extra}
        }}
    """)


def test_tier_settings_reach_the_store(tmp_path):
    cfg = _serving_config(f"""
        serving.store.tier {{ enabled = true, hot-cells = 5, ram-mb = 3, spill-dir = "{tmp_path}" }}
    """)
    ServingLayer(cfg)
    assert tier_config() == {"enabled": True, "hot_cells": 5, "ram_bytes": 3 << 20,
                             "spill_dir": str(tmp_path)}
    tsm.ALSServingModelManager(cfg)  # accepted, no longer refused
    ServingLayer(_serving_config("serving.store.tier.enabled = false"))
    assert not store.tier_active()


def test_maintainer_compacts_into_a_fresh_tiered_plane(tmp_path):
    tivf.configure_ann(enabled=True, min_items=400, cells=16, nprobe=4, overlay_capacity=16,
                       host_stage1=True)
    configure_tier(enabled=True, hot_cells=4, ram_bytes=1 << 16, spill_dir=str(tmp_path))
    gen = np.random.default_rng(0)
    m = ALSServingModel(8, implicit=True, refresh_sec=0.0, score_dtype="int8")
    m.set_item_vectors([f"i{j}" for j in range(500)], gen.standard_normal((500, 8)).astype(np.float32))
    q = np.zeros(8, np.float32)
    q[0] = 1.0
    m.top_n(q, 3)
    before = m._ensure_y_matrix()[2]
    assert isinstance(before, tivf.IVFIndex) and before.tier is not None
    maint = tmaintain.IndexMaintainer(lambda: m, watermark=0.5)
    maint._hook_model(m)
    m.set_item_vectors([f"new{j}" for j in range(24)], gen.standard_normal((24, 8)).astype(np.float32))
    m.top_n(q, 3)
    stats = maint.run_once()
    assert stats is not None and stats["folded"] == 24
    after = m._ensure_y_matrix()[2]
    assert after.tier is not None and after.tier is not before.tier and after.host_plane is None
    assert after.ov_used == 0 and not after.pending_spill
    host0 = tivf.counts()["host"]
    assert len(m.top_n(q, 10)) == 10  # the probed scan gathers through the new plane
    assert tivf.counts()["host"] == host0 + 1
    tivf.configure_ann(nprobe=16)  # full probe: every fold-in visible
    assert {f"new{j}" for j in range(24)} <= {i for i, _ in m.top_n(q, 524)}
