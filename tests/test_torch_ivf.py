"""The IVF serving tier of the port (``oryx_tpu_torch.ops.ivf``,
``serving/maintain.py`` and the ALS model's IVF parts) against the JAX
package's, on the CPU, on the same seeded inputs.

- Both packages lay a catalog out onto the SAME centroids (the JAX
  package's trained ones, ``build_ivf(mat, centroids=...)``): codes,
  scales, norms, slot ids and chunk counts agree bit for bit. Cell
  assignment may differ only at rows whose two best centroid scores lie
  within 1e-6 relative (two float32 products summed in another order);
  none of these seeds has one.
- ``top_k`` at partial and full probe, dot and cosine, on the host
  stage-1 path (numpy in both packages) and the device path (XLA against
  PyTorch ops on the CPU): equal ids, scores within 1e-5 of the largest
  score (the host path's bits agree).
- ``update_rows``'s overlay and spill, and ``compact_ivf`` without
  split or merge, leave both packages in the same state; the split and
  merge cases hold the port to the JAX tests' assertions (the local
  2-means trains through each package's own k-means, whose random
  streams differ).
- The port's routing masks empty cells, so it passes the assertions of
  ``tests/ops/test_ivf_scan.py::test_empty_cells_are_harmless`` (recall
  0.95); the reference does not, and that is not asserted here.
- Index generations read across in both directions; the maintainer,
  the serving model's maintenance protocol and the config block mirror
  ``tests/serving/test_maintain.py``, ``tests/ops/test_ivf_maintain.py``
  and ``tests/app/als/test_als_serving_ann.py``; an INDEX-REF reaches a
  second port ServingLayer through a ``file:`` bus.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from oryx_tpu.ops import ivf as jivf
from oryx_tpu.serving import maintain as jmaintain
from oryx_tpu_torch import bus as tbus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.als.serving_model import ALSServingModel
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.common import pmml as tpmml
from oryx_tpu_torch.common.text import join_json
from oryx_tpu_torch.app import pmml as tapp_pmml
from oryx_tpu_torch.ops import ivf as tivf
from oryx_tpu_torch.ops import topn as ttopn
from oryx_tpu_torch.serving import maintain as tmaintain
from oryx_tpu_torch.serving.layer import ServingLayer

K = 10
TIE_TOL = 1e-5
SCORE_RTOL = 1e-5

_ANN_KNOBS = (
    "ANN_ENABLED", "N_CELLS", "NPROBE", "PROBE_FRACTION", "MIN_ITEMS",
    "OVERLAY_CAPACITY", "QUERY_BLOCK", "TILE_CHUNKS", "HOST_STAGE1",
)
_MAINTAIN_KNOBS = (
    "MAINTAIN_ENABLED", "MAINTAIN_INTERVAL_SEC", "MAINTAIN_WATERMARK",
    "MAINTAIN_SPLIT_MAX_ITEMS", "MAINTAIN_MERGE_MIN_ITEMS", "MAINTAIN_PUBLISH",
)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU; configure_ann / configure_maintain mutate
    module globals of both packages: leave no residue."""
    port_device.set_device("cpu")
    saved = [
        (mod, name, getattr(mod, name))
        for mod, names in ((jivf, _ANN_KNOBS), (tivf, _ANN_KNOBS),
                           (jmaintain, _MAINTAIN_KNOBS), (tmaintain, _MAINTAIN_KNOBS))
        for name in names
    ]
    yield
    for mod, name, value in saved:
        setattr(mod, name, value)
    port_device.set_device(None)
    InProcessBroker.reset_all()


def clustered(n=20_000, f=32, b=16, n_centers=64, seed=0, spread=0.3):
    """tests/ops/test_ivf_scan.py's mixture: items and queries near the
    same centers."""
    gen = np.random.default_rng(seed)
    centers = gen.standard_normal((n_centers, f)).astype(np.float32)
    mat = centers[gen.integers(0, n_centers, n)] + spread * gen.standard_normal(
        (n, f)
    ).astype(np.float32)
    queries = centers[gen.integers(0, n_centers, b)] + spread * gen.standard_normal(
        (b, f)
    ).astype(np.float32)
    return mat.astype(np.float32), queries.astype(np.float32)


def recall(mat, queries, idx, k=K, tol=TIE_TOL):
    """Tie-tolerant recall@k against the exact float32 ranking."""
    ref = queries @ mat.T
    hits = 0
    for r in range(len(queries)):
        kth = np.partition(ref[r], -k)[-k]
        rows = np.asarray(idx[r])
        rows = rows[rows >= 0]
        hits += int(np.sum(ref[r][rows] >= kth - tol))
    return hits / (len(queries) * k)


def jax_centroids(jindex) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(jindex.centroids_t).T[:, : jindex.features])


_PLANES = (
    "mat_t", "resid", "mat_rows", "scales", "resid_scales", "norms", "slot_ids",
    "chunk_start", "chunk_count", "centroids_t", "centroid_norms",
)


def assert_same_layout(jindex, pindex):
    for name in _PLANES:
        want = np.asarray(getattr(jindex, name))
        got = getattr(pindex, name).cpu().numpy()
        assert got.shape == want.shape, name
        assert np.array_equal(got, want), name
    for name in ("chunk_count_host", "tile_start_host", "tile_count_host", "id_to_slot"):
        assert np.array_equal(getattr(pindex, name), getattr(jindex, name)), name
    assert (pindex.n_items, pindex.features, pindex.chunk, pindex.tile_chunks) == (
        jindex.n_items, jindex.features, jindex.chunk, jindex.tile_chunks
    )


def assert_same_topk(j_ids, j_vals, p_ids, p_vals):
    j_ids, j_vals = np.asarray(j_ids), np.asarray(j_vals, np.float64)
    assert np.array_equal(p_ids, j_ids)
    fin = np.isfinite(j_vals)
    assert np.array_equal(np.isfinite(p_vals), fin)
    scale = max(1.0, float(np.abs(j_vals[fin]).max())) if fin.any() else 1.0
    assert float(np.abs(p_vals[fin] - j_vals[fin]).max(initial=0.0)) <= SCORE_RTOL * scale


def both(mat, cents, host_stage1, **kw):
    """(JAX index, port index) over ``mat`` on the same centroids."""
    jivf.configure_ann(host_stage1=host_stage1)
    tivf.configure_ann(host_stage1=host_stage1)
    return (
        jivf.build_ivf(mat, centroids=cents, **kw),
        tivf.build_ivf(mat, centroids=cents, **kw),
    )


@pytest.fixture(scope="module")
def trained():
    """One JAX-trained clustering shared by the parity cases."""
    mat, queries = clustered(seed=5)
    return mat, queries, jax_centroids(jivf.build_ivf(mat, n_cells=64, seed=1))


# -- build and layout -----------------------------------------------------------


def test_assignment_agrees_but_near_ties(trained):
    mat, _, cents = trained
    port = tivf._assign_cells(mat, cents, "cpu")
    ref = jivf._assign_cells(mat, cents)
    s = mat @ cents.T - 0.5 * np.einsum("kd,kd->k", cents, cents)[None, :]
    top2 = -np.sort(-s, axis=1)[:, :2]
    near = np.abs(top2[:, 0] - top2[:, 1]) <= 1e-6 * np.abs(top2[:, 0])
    assert np.array_equal(port[~near], ref[~near])


@pytest.mark.parametrize("host_stage1", [True, False])
def test_layout_equals_the_jax_package(trained, host_stage1):
    mat, _, cents = trained
    jindex, pindex = both(mat, cents, host_stage1)
    assert_same_layout(jindex, pindex)
    assert (pindex.host_plane is not None) == host_stage1
    if host_stage1:
        assert np.array_equal(pindex.host_plane, jindex.host_plane)


def test_build_trains_round_sqrt_n_cells():
    from oryx_tpu_torch.ops import pallas_kmeans

    mat, queries = clustered(n=4_000, f=16, seed=2)
    before = pallas_kmeans.launch_counts()
    index = tivf.build_ivf(mat, seed=3)
    assert index.n_cells == round(np.sqrt(len(mat)))
    assert set(tivf.last_build_seconds) == {"kmeans", "assign", "quantize", "upload", "layout"}
    # the sweep counts launches only on the card; on the CPU it runs its
    # plain version
    assert pallas_kmeans.launch_counts() == before
    idx, _ = tivf.top_k(index, queries, K, nprobe=8)
    assert recall(mat, queries, idx) >= 0.95


# -- query ------------------------------------------------------------------------


@pytest.mark.parametrize("host_stage1", [True, False])
@pytest.mark.parametrize("nprobe", [6, 64])
@pytest.mark.parametrize("cosine", [False, True])
def test_top_k_equals_the_jax_package(trained, host_stage1, nprobe, cosine):
    mat, queries, cents = trained
    jindex, pindex = both(mat, cents, host_stage1)
    j_ids, j_vals = jivf.top_k(jindex, queries, K, nprobe=nprobe, cosine=cosine)
    p_ids, p_vals = tivf.top_k(pindex, queries, K, nprobe=nprobe, cosine=cosine)
    assert_same_topk(j_ids, j_vals, p_ids, p_vals)
    if host_stage1 and nprobe < 64:
        assert np.array_equal(p_vals, np.asarray(j_vals))  # the same numpy code


def test_paths_are_counted_with_one_round_trip_per_batch(trained):
    mat, queries, cents = trained
    _, dev_index = both(mat, cents, False)
    _, host_index = both(mat, cents, True)
    tivf.reset_counts()
    tivf.top_k(dev_index, queries, K, nprobe=6)
    tivf.top_k(host_index, queries, K, nprobe=6)
    tivf.top_k(dev_index, queries, K, nprobe=dev_index.n_cells)
    got = tivf.counts()
    assert {k: got[k] for k in ("device", "host", "full", "route_syncs")} == {
        "device": 1, "host": 1, "full": 1, "route_syncs": 2
    }
    assert got["groups"] == 2 and got["pieces"] == 2  # 16 queries, groups of 8, one piece each


def test_host_and_device_stage1_agree():
    mat, queries = clustered(n=12_000, f=32, b=8, seed=23)
    tivf.configure_ann(host_stage1=True)
    host_index = tivf.build_ivf(mat, n_cells=32, seed=8)
    hidx, _ = tivf.top_k(host_index, queries, K, nprobe=6)
    tivf.configure_ann(host_stage1=False)
    dev_index = tivf.build_ivf(mat, centroids=tivf_centroids(host_index))
    assert dev_index.host_plane is None
    didx, _ = tivf.top_k(dev_index, queries, K, nprobe=6)
    ref = queries @ mat.T
    for r in range(len(queries)):
        kth = np.partition(ref[r], -K)[-K]
        for rows in (hidx[r], didx[r]):
            assert (ref[r][rows[rows >= 0]] >= kth - TIE_TOL).all()


def tivf_centroids(index) -> np.ndarray:
    return np.ascontiguousarray(index.centroids_t.numpy().T[:, : index.features])


def test_stage1_pieces_do_not_change_the_answer(trained, monkeypatch):
    """A group's slab walked in pieces of one tile gives the chunk maxes
    of one whole pass."""
    mat, queries, cents = trained
    _, index = both(mat, cents, False)
    whole = tivf.top_k(index, queries, K, nprobe=12)
    monkeypatch.setattr(tivf, "_PIECE_BYTES", 1)
    pieces = tivf.top_k(index, queries, K, nprobe=12)
    assert np.array_equal(whole[0], pieces[0]) and np.array_equal(whole[1], pieces[1])


@pytest.mark.parametrize("host_stage1", [True, False])
def test_empty_cells_are_harmless(host_stage1):
    """tests/ops/test_ivf_scan.py's case, held on the port: 30 of 32
    cells empty, and the probes of each blob's query must reach its
    blob's cell."""
    tivf.configure_ann(host_stage1=host_stage1)
    gen = np.random.default_rng(11)
    f = 16
    blob_a = gen.standard_normal(f).astype(np.float32)
    blob_b = gen.standard_normal(f).astype(np.float32)
    mat = np.concatenate([np.tile(blob_a, (1500, 1)), np.tile(blob_b, (1500, 1))])
    mat = mat.astype(np.float32)
    index = tivf.build_ivf(mat, n_cells=32, seed=4)
    assert int((index.chunk_count_host == 0).sum()) > 0  # empties exist
    queries = np.stack([blob_a, blob_b]).astype(np.float32)
    idx, _vals = tivf.top_k(index, queries, K, nprobe=8)
    assert recall(mat, queries, idx) >= 0.95
    for r in range(2):
        rows = idx[r][idx[r] >= 0]
        assert len(set(rows.tolist())) == len(rows)
    # all-empty probe windows starve gracefully: k beyond catalog pads -1
    tiny = tivf.build_ivf(mat[:4], n_cells=2, seed=4)
    idx, vals = tivf.top_k(tiny, queries[:1], 8, nprobe=1)
    assert (idx[vals == -np.inf] == -1).all()


def test_near_ties_straddling_cell_boundaries():
    gen = np.random.default_rng(7)
    n, f = 16_000, 32
    base = gen.standard_normal(f).astype(np.float32)
    base /= np.linalg.norm(base)
    mat = np.tile(base, (n, 1)).astype(np.float32)
    jit = gen.standard_normal((n, f)).astype(np.float32) * 0.35
    jit -= np.outer(jit @ base, base)
    mat += jit
    winners = gen.choice(n, 40, replace=False)
    mat[winners] += base
    queries = np.tile(base, (8, 1)).astype(np.float32)
    index = tivf.build_ivf(mat, n_cells=16, seed=3)
    idx, _vals = tivf.top_k(index, queries, K, nprobe=6)
    ref = queries @ mat.T
    for r in range(len(queries)):
        kth = np.partition(ref[r], -K)[-K]
        rows = idx[r]
        assert (rows >= 0).all()
        assert (ref[r][rows] >= kth - TIE_TOL).all()
        assert len(set(rows.tolist())) == K


def test_power_law_skewed_cells():
    gen = np.random.default_rng(13)
    f, n_centers = 24, 40
    sizes = (8000 / np.arange(1, n_centers + 1) ** 1.2).astype(int) + 1
    centers = gen.standard_normal((n_centers, f)).astype(np.float32) * 2.0
    mat = np.concatenate([
        centers[i] + 0.25 * gen.standard_normal((s, f)).astype(np.float32)
        for i, s in enumerate(sizes)
    ]).astype(np.float32)
    queries = centers[gen.integers(0, n_centers, 12)] + 0.25 * gen.standard_normal(
        (12, f)
    ).astype(np.float32)
    # the reference's clustering, so that its skew is the one asserted
    index = tivf.build_ivf(mat, centroids=jax_centroids(jivf.build_ivf(mat, n_cells=n_centers, seed=5)))
    assert index.chunk_count_host.max() >= 8 * max(1, np.median(index.chunk_count_host))
    idx, _vals = tivf.top_k(index, queries.astype(np.float32), K, nprobe=6)
    assert recall(mat, queries, idx) >= 0.95


# -- fold-ins: overlay and spill ------------------------------------------------------


def test_update_rows_overlay_and_spill_match_the_jax_package():
    mat, queries = clustered(n=4_000, f=16, b=6, seed=19)
    cents = jax_centroids(jivf.build_ivf(mat, n_cells=16, seed=7))
    jindex, pindex = both(mat, cents, False, overlay_capacity=8)
    gen = np.random.default_rng(3)
    batches = [
        (np.arange(8), mat[:8] + 0.5),  # fills the overlay
        (np.array([100]), mat[100:101] + 0.5),  # spills the oldest
        (np.arange(1, 4), mat[1:4] + 1.0),  # rewrites, no new slot
        (np.array([0]), mat[0:1] + 2.0),  # a spilled id comes back
        (np.arange(4_000, 4_020), gen.standard_normal((20, 16)).astype(np.float32)),
    ]
    for rows, vals in batches:
        jindex = jivf.update_rows(jindex, rows, vals)
        pindex = tivf.update_rows(pindex, rows, vals)
        assert list(pindex.ov_map.items()) == list(jindex.ov_map.items())
        assert pindex.ov_used == jindex.ov_used and pindex.n_items == jindex.n_items
        assert list(pindex.pending_spill) == list(jindex.pending_spill)
        for item, (raw, _born) in jindex.pending_spill.items():
            assert np.array_equal(pindex.pending_spill[item][0], raw)
        assert np.array_equal(pindex.slot_ids.numpy(), np.asarray(jindex.slot_ids))
        assert np.array_equal(pindex.id_to_slot, jindex.id_to_slot)
        for name in ("ov_rows", "ov_ids", "ov_norms"):
            assert np.array_equal(getattr(pindex, name).numpy(), np.asarray(getattr(jindex, name)))
    for nprobe in (4, 16):
        assert_same_topk(
            *jivf.top_k(jindex, queries, K, nprobe=nprobe),
            *tivf.top_k(pindex, queries, K, nprobe=nprobe),
        )


@pytest.mark.parametrize("host_stage1", [True, False])
def test_update_rows_visible_through_ann(host_stage1):
    tivf.configure_ann(host_stage1=host_stage1)
    mat, queries = clustered(n=8_000, f=32, b=4, seed=17)
    index = tivf.build_ivf(mat, n_cells=32, seed=6)
    newrow = (3.0 * queries[0]).astype(np.float32)
    index = tivf.update_rows(index, np.array([4321]), newrow[None, :])
    idx, vals = tivf.top_k(index, queries[:1], K, nprobe=4)
    assert int(idx[0, 0]) == 4321
    assert list(idx[0]).count(4321) == 1  # the tombstoned copy never resurfaces
    mat2 = mat.copy()
    mat2[4321] = newrow
    rebuilt = tivf.build_ivf(mat2, centroids=tivf_centroids(index))
    idx2, vals2 = tivf.top_k(rebuilt, queries[:1], K, nprobe=rebuilt.n_cells)
    pos = list(idx2[0]).index(4321)
    assert abs(float(vals[0, 0]) - float(vals2[0, pos])) <= 1e-4 * max(1.0, abs(float(vals2[0, pos])))


def test_overlay_batch_larger_than_capacity_spills_directly():
    mat, _ = clustered(n=4_000, f=16, b=1, seed=19)
    index = tivf.build_ivf(mat, n_cells=16, seed=7, overlay_capacity=8)
    rows = np.arange(20)
    index = tivf.update_rows(index, rows, mat[rows] + 0.5)
    assert index.ov_used == 8 and len(index.pending_spill) == 12
    assert set(index.ov_map) | set(index.pending_spill) == set(range(20))
    assert not np.isin(rows, index.slot_ids.numpy()).any()


def test_snapshot_and_watermark():
    mat, _ = clustered(n=3_000, f=24, seed=15)
    index = tivf.build_ivf(mat, n_cells=8, seed=8, overlay_capacity=8)
    assert not tivf.needs_maintenance(index)
    ids = np.arange(len(mat), len(mat) + 12)
    vals = np.random.default_rng(1).standard_normal((12, 24)).astype(np.float32)
    index = tivf.update_rows(index, ids, vals)
    assert tivf.needs_maintenance(index, watermark=0.99)  # spilled
    snap = tivf.snapshot_pending(index)
    assert set(snap.ids.tolist()) == set(ids.tolist()) == set(snap.born)
    before = snap.raw.copy()
    tivf.update_rows(index, ids[:3], vals[:3] * 9.0)
    assert np.array_equal(snap.raw, before)
    assert ttopn.capacity(index) == index.n_items + 8 - index.ov_used


# -- compaction -------------------------------------------------------------------------


def test_compaction_matches_the_jax_package_and_a_fresh_build():
    mat, queries = clustered(n=6_000, f=24, b=6, n_centers=24, seed=3)
    cents = jax_centroids(jivf.build_ivf(mat, n_cells=16, seed=7))
    jindex, pindex = both(mat, cents, False, overlay_capacity=32)
    new = np.random.default_rng(4).standard_normal((80, 24)).astype(np.float32)
    ids = np.arange(len(mat), len(mat) + 80)
    jindex = jivf.update_rows(jindex, ids, new)
    pindex = tivf.update_rows(pindex, ids, new)
    no_split = dict(split_max_items=10**9, merge_min_items=1)
    jc, jstats = jivf.compact_ivf(jindex, seed=5, **no_split)
    pc, pstats = tivf.compact_ivf(pindex, seed=5, **no_split)
    assert_same_layout(jc, pc)
    assert {k: pstats[k] for k in ("folded", "live", "cells", "splits", "merges")} == {
        k: jstats[k] for k in ("folded", "live", "cells", "splits", "merges")
    }
    assert pc.ov_used == 0 and not pc.pending_spill
    rebuilt = tivf.build_ivf(np.vstack([mat, new]), centroids=tivf_centroids(pc), overlay_capacity=32)
    assert_same_layout(jc, rebuilt)
    assert_same_topk(
        *jivf.top_k(jc, queries, K, nprobe=jc.n_cells), *tivf.top_k(pc, queries, K, nprobe=pc.n_cells)
    )


def test_split_grows_cells_and_keeps_full_probe_exact():
    mat, queries = clustered(n=5_000, f=24, b=6, n_centers=4, seed=11)
    index = tivf.build_ivf(mat, n_cells=4, seed=3, overlay_capacity=16)
    index = tivf.update_rows(index, np.array([len(mat)]), queries[:1])
    compacted, stats = tivf.compact_ivf(index, seed=4, split_max_items=400, merge_min_items=1)
    assert stats["splits"] > 0 and compacted.n_cells > 4
    full = np.vstack([mat, queries[:1]])
    ref = queries @ full.T
    idx, _ = tivf.top_k(compacted, queries, K, nprobe=compacted.n_cells)
    for r in range(len(queries)):
        kth = np.partition(ref[r], -K)[-K]
        assert (ref[r][idx[r]] >= kth - 1e-4).all()


def test_merge_dissolves_starved_cells():
    gen = np.random.default_rng(21)
    f = 16
    blob = gen.standard_normal(f).astype(np.float32)
    mat = np.concatenate([
        np.tile(blob, (3_000, 1)) + 0.1 * gen.standard_normal((3_000, f)).astype(np.float32),
        5.0 * gen.standard_normal((6, f)).astype(np.float32),
    ]).astype(np.float32)
    index = tivf.build_ivf(mat, n_cells=12, seed=6, overlay_capacity=16)
    index = tivf.update_rows(index, np.array([0]), mat[0:1] + 0.01)
    compacted, stats = tivf.compact_ivf(index, seed=6, merge_min_items=4, split_max_items=10**7)
    assert stats["merges"] > 0 and compacted.n_cells < 12
    for j in range(3_000, 3_006):
        q = (mat[j] / np.linalg.norm(mat[j]))[None, :].astype(np.float32)
        idx, _ = tivf.top_k(compacted, q, 1, nprobe=compacted.n_cells)
        assert int(idx[0, 0]) == j


# -- index generations ----------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_index_generation_reads_across_packages(tmp_path, writer):
    mat, queries = clustered(n=6_000, f=24, b=6, n_centers=24, seed=9)
    cents = jax_centroids(jivf.build_ivf(mat, n_cells=16, seed=2))
    jindex, pindex = both(mat, cents, False)
    if writer == "jax":
        ref = jmaintain.write_index_generation(str(tmp_path), jindex, generation_id="11")
        loaded = tmaintain.read_index_generation(ref)
    else:
        ref = tmaintain.write_index_generation(str(tmp_path), pindex, generation_id="11")
        loaded = jmaintain.read_index_generation(ref)
    gid, manifest, got = loaded
    assert gid == "11" and manifest["n_cells"] == 16 and manifest["features"] == 24
    assert np.array_equal(got, cents)
    assert tmaintain.read_index_generation(str(tmp_path / "nope")) is None
    adopted = tivf.build_ivf(mat, centroids=got)
    assert_same_layout(jindex, adopted)


# -- the facade ---------------------------------------------------------------------------


def test_topn_facade_dispatches_ivf():
    mat, queries = clustered(n=8_000, f=32, b=4, seed=29)
    index = tivf.build_ivf(mat, n_cells=32, seed=9)
    tivf.configure_ann(nprobe=8)  # the facade reads the module knob
    ids, vals = ttopn.top_k_scores(index, queries[0], K)
    assert len(ids) == K and len(vals) == K
    bidx, _ = ttopn.top_k_scores_batch(index, queries, K)
    assert recall(mat, queries, bidx) >= 0.9
    assert ttopn.capacity(index) >= len(mat)
    assert isinstance(ttopn.update_rows(index, np.array([7]), mat[7:8] * 2.0), tivf.IVFIndex)
    want = tivf.top_k(index, queries, K)
    for handle in (
        ttopn.submit_top_k(index, queries, K),
        ttopn.submit_top_k_multi(index, queries, K),
        ttopn.submit_top_k_multi_indexed(
            index, torch.from_numpy(queries), np.arange(len(queries)), K
        ),
    ):
        got = handle.result()
        assert np.array_equal(got[0], want[0]) and np.allclose(got[1], want[1])


# -- the ALS serving model ---------------------------------------------------------------

F = 8


def ann_model(n=600, seed=0):
    gen = np.random.default_rng(seed)
    m = ALSServingModel(F, implicit=True, refresh_sec=0.0, score_dtype="int8")
    m.set_item_vectors([f"i{j}" for j in range(n)], gen.standard_normal((n, F)).astype(np.float32))
    return m


def unit_query():
    q = np.zeros(F, np.float32)
    q[0] = 1.0
    return q


def warm(m):
    q = unit_query()
    m.top_n(q, 3)
    assert isinstance(m._ensure_y_matrix()[2], tivf.IVFIndex)
    return q


def test_ann_engages_above_min_items_and_full_probe_is_the_exact_answer():
    tivf.configure_ann(enabled=True, min_items=500, cells=16, nprobe=16)
    m = ann_model(600)
    q = unit_query()
    res = m.top_n(q, 5)
    assert isinstance(m._ensure_y_matrix()[2], tivf.IVFIndex)
    tivf.configure_ann(enabled=False)
    exact = ALSServingModel(F, implicit=True, refresh_sec=0.0, score_dtype="int8")
    ids, mats = m.y.to_matrix()
    exact.set_item_vectors(ids, mats)
    assert [i for i, _ in res] == [i for i, _ in exact.top_n(q, 5)]


@pytest.mark.parametrize("store", ["native", "python"])
def test_the_ivf_build_follows_ids_not_the_stores_row_order(store):
    """The same catalog inserted in another order, into either store
    kind, gives the same k-means sample, centroids and layout: the build
    takes its rows in id order."""
    from oryx_tpu_torch.app.als.common import FeatureVectors

    tivf.configure_ann(enabled=True, min_items=500, cells=16, nprobe=4)
    gen = np.random.default_rng(3)
    n = 600
    ids = [f"i{j}" for j in range(n)]
    vecs = gen.standard_normal((n, F)).astype(np.float32)
    ref = ALSServingModel(F, implicit=True, refresh_sec=0.0, score_dtype="int8")
    ref.set_item_vectors(ids, vecs)
    other = ALSServingModel(F, implicit=True, refresh_sec=0.0, score_dtype="int8")
    if store == "python":
        other.y = FeatureVectors()
    perm = gen.permutation(n)
    other.set_item_vectors([ids[j] for j in perm], vecs[perm])
    assert other.y.to_matrix()[0] != ref.y.to_matrix()[0]  # the stores' orders differ
    a, b = ref._ensure_y_matrix(), other._ensure_y_matrix()
    assert a[0] == b[0] == ids  # by length, then text: i0 ... i599
    assert torch.equal(a[2].centroids_t, b[2].centroids_t)
    assert np.array_equal(a[2].slot_ids_host, b[2].slot_ids_host)
    q = unit_query()
    assert ref.top_n(q, 5) == other.top_n(q, 5)


def test_ann_stays_off_below_min_items_and_for_float32():
    tivf.configure_ann(enabled=True, min_items=10_000, cells=16)
    m = ann_model(600)
    m.top_n(np.ones(F, np.float32), 3)
    assert not isinstance(m._ensure_y_matrix()[2], tivf.IVFIndex)
    tivf.configure_ann(min_items=500)
    f32 = ALSServingModel(F, implicit=True, refresh_sec=0.0, score_dtype="float32")
    f32.set_item_vectors(*m.y.to_matrix())
    f32.top_n(np.ones(F, np.float32), 3)
    assert not isinstance(f32._ensure_y_matrix()[2], tivf.IVFIndex)


def test_speed_layer_folds_stay_visible():
    tivf.configure_ann(enabled=True, min_items=500, cells=16, nprobe=4)
    m = ann_model(600)
    q = warm(m)
    m.set_item_vector("hot-new", (25.0 * q).astype(np.float32))
    assert m.top_n(q, 3)[0][0] == "hot-new"
    after = m._ensure_y_matrix()[2]
    assert isinstance(after, tivf.IVFIndex) and after.ov_used > 0  # overlay, not rebuild
    m.set_item_vector("i7", (30.0 * q).astype(np.float32))
    res = m.top_n(q, 3)
    assert res[0][0] == "i7" and [i for i, _ in res].count("i7") == 1


def test_overlay_exhaustion_without_a_maintainer_rebuilds():
    tivf.configure_ann(enabled=True, min_items=500, cells=16, nprobe=16, overlay_capacity=4)
    m = ann_model(600)
    q = np.ones(F, np.float32)
    m.top_n(q, 3)
    gen = np.random.default_rng(9)
    for j in range(6):
        m.set_item_vector(f"new{j}", gen.standard_normal(F).astype(np.float32))
    m.set_item_vector("winner", (40.0 * q).astype(np.float32))
    assert m.top_n(q, 3)[0][0] == "winner"
    rebuilt = m._ensure_y_matrix()[2]
    assert isinstance(rebuilt, tivf.IVFIndex) and rebuilt.ov_used == 0 and rebuilt.n_items == 607


def test_maintainer_compacts_and_reports_freshness():
    tivf.configure_ann(enabled=True, min_items=400, cells=16, nprobe=16, overlay_capacity=16)
    m = ann_model(500)
    q = warm(m)
    maint = tmaintain.IndexMaintainer(lambda: m, watermark=0.5)
    maint._hook_model(m)
    gen = np.random.default_rng(1)
    m.set_item_vectors([f"new{j}" for j in range(24)], gen.standard_normal((24, F)).astype(np.float32))
    m.top_n(q, 3)
    idx = m._ensure_y_matrix()[2]
    assert idx.ov_used == 16 and len(idx.pending_spill) == 8
    ep0 = m._y_build_epoch  # no request-path re-cluster
    c0 = metrics.registry.counter("serving.ann.maintain.compactions").value
    stats = maint.run_once()  # not forced: the spill makes it due
    assert stats is not None and stats["folded"] == 24
    after = m._ensure_y_matrix()[2]
    assert after.ov_used == 0 and not after.pending_spill and m._y_build_epoch == ep0
    assert metrics.registry.counter("serving.ann.maintain.compactions").value == c0 + 1
    assert 0.0 <= metrics.registry.gauge(tmaintain.FRESHNESS_GAUGE).value < 60.0
    assert maint.run_once() is None
    gone = {f"new{j}" for j in range(24)} - {i for i, _ in m.top_n(q, 624)}
    assert not gone


def test_install_discarded_when_a_rotation_races_and_replays_racing_fold_ins():
    tivf.configure_ann(enabled=True, min_items=400, cells=16, nprobe=16, overlay_capacity=16)
    m = ann_model(500)
    q = warm(m)
    m.set_item_vectors(["pre"], np.ones((1, F), np.float32))
    m.top_n(q, 3)
    index, snap = m.maintenance_snapshot(force=True)
    new_index, stats = tivf.compact_ivf(index, snap)
    m.set_item_vector("racer", (7.0 * q).astype(np.float32))  # races the compaction
    m.top_n(q, 3)
    assert m.install_compacted(new_index, stats) is True
    assert stats.get("replayed", 0) >= 1
    assert m.top_n(q, 1)[0][0] == "racer"
    index, snap = m.maintenance_snapshot(force=True)
    new_index, stats = tivf.compact_ivf(index, snap)
    m.retain_recent_and_item_ids({f"i{j}" for j in range(400)})
    m.top_n(q, 3)
    assert m.install_compacted(new_index, stats) is False


def test_maintainer_loop_wakes_on_pressure():
    tivf.configure_ann(enabled=True, min_items=400, cells=16, nprobe=16, overlay_capacity=8)
    m = ann_model(500)
    q = warm(m)
    maint = tmaintain.IndexMaintainer(lambda: m, interval_sec=30.0)
    maint.start()
    try:
        deadline = time.monotonic() + 10.0
        while m._index_pressure_cb is None and time.monotonic() < deadline:
            time.sleep(0.01)
        gen = np.random.default_rng(5)
        m.set_item_vectors([f"bg{j}" for j in range(12)], gen.standard_normal((12, F)).astype(np.float32))
        m.top_n(q, 3)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and maint.compactions == 0:
            time.sleep(0.05)
        assert maint.compactions >= 1  # the pressure wake-up, not the interval
        assert not m._ensure_y_matrix()[2].pending_spill
    finally:
        maint.close()


def test_replica_adopts_a_published_generation(tmp_path):
    tivf.configure_ann(enabled=True, min_items=400, cells=16, nprobe=16, overlay_capacity=16)
    m = ann_model(500)
    q = warm(m)
    refs = []

    def publish(index, stats):
        refs.append(tmaintain.write_index_generation(str(tmp_path), index, stats=stats))
        return refs[-1]

    maint = tmaintain.IndexMaintainer(lambda: m, publish_fn=publish)
    maint._hook_model(m)  # with a maintainer the overlay spills instead of rebuilding
    hot = np.random.default_rng(3).standard_normal((20, F)).astype(np.float32)
    m.set_item_vectors([f"hot{j}" for j in range(20)], hot)
    m.top_n(q, 3)
    stats = maint.run_once()
    assert maint.published == 1 and m.index_generation is not None
    assert m.apply_index_generation(refs[0]) is False  # the publisher's self-delivery
    gid, manifest, _ = tmaintain.read_index_generation(refs[0])
    assert manifest["compaction"]["folded"] == stats["folded"] == 20
    m2 = ALSServingModel(F, implicit=True, refresh_sec=0.0, score_dtype="int8")
    m2.set_item_vectors(*m.y.to_matrix())
    assert m2.apply_index_generation(refs[0]) is True
    assert m2.index_generation == gid
    assert m2.apply_index_generation(refs[0]) is False  # duplicate delivery
    assert torch.equal(m2._ensure_y_matrix()[2].centroids_t, m._ensure_y_matrix()[2].centroids_t)
    probe = (hot[4] / np.linalg.norm(hot[4])).astype(np.float32)
    assert [i for i, _ in m.top_n(probe, 5)] == [i for i, _ in m2.top_n(probe, 5)]


# -- the serving layer -------------------------------------------------------------------


def layer_config(broker_loc, extra=""):
    return tconfig.get_default().with_overlay(
        f"""
        oryx {{
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          als.serving.score-dtype = "int8"
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"
            application-resources = "oryx_tpu_torch.app.als.endpoints"
          }}
          {extra}
        }}
        """
    )


def test_config_blocks_reach_the_knobs():
    ServingLayer(layer_config("inproc://ivf-cfg", """
        serving.scan.ann {
          enabled = true, cells = 48, nprobe = 5, probe-fraction = 0.03, min-items = 1234
          overlay-capacity = 256, host-stage1 = false
          maintain { enabled = true, interval-sec = 0.5, watermark = 0.25
                     split-max-items = 777, merge-min-items = 3, publish = true }
        }
    """))
    assert (tivf.ANN_ENABLED, tivf.N_CELLS, tivf.NPROBE, tivf.MIN_ITEMS) == (True, 48, 5, 1234)
    assert tivf.PROBE_FRACTION == pytest.approx(0.03)
    assert (tivf.OVERLAY_CAPACITY, tivf.HOST_STAGE1) == (256, False)
    assert tivf.ann_active(2000) and not tivf.ann_active(100)
    assert tmaintain.MAINTAIN_ENABLED is True and tmaintain.MAINTAIN_PUBLISH is True
    assert tmaintain.MAINTAIN_INTERVAL_SEC == pytest.approx(0.5)
    assert tmaintain.MAINTAIN_WATERMARK == pytest.approx(0.25)
    assert (tmaintain.MAINTAIN_SPLIT_MAX_ITEMS, tmaintain.MAINTAIN_MERGE_MIN_ITEMS) == (777, 3)
    ServingLayer(layer_config("inproc://ivf-cfg", 'serving.scan.ann.host-stage1 = "auto"'))
    assert tivf.HOST_STAGE1 is False  # "auto" leaves the knob alone


def http_json(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def test_index_ref_reaches_a_second_layer_over_a_file_bus(tmp_path):
    """Two port ServingLayers on one file: bus and one model dir: the
    first compacts its fold-ins and publishes the generation; the second
    adopts it from the INDEX-REF, and both answer alike."""
    loc = f"file:{tmp_path / 'bus'}"
    extra = f"""
        batch.storage.model-dir = "{tmp_path / 'model'}"
        serving.scan.ann {{
          enabled = true, min-items = 400, cells = 16, nprobe = 4, overlay-capacity = 16
          maintain {{ enabled = true, interval-sec = 0.2, publish = true }}
        }}
    """
    gen = np.random.default_rng(31)
    items = gen.standard_normal((600, F)).astype(np.float32)
    users = gen.standard_normal((4, F)).astype(np.float32)
    root = tpmml.build_skeleton_pmml()
    tapp_pmml.add_extension(root, "features", F)
    tapp_pmml.add_extension(root, "implicit", "true")
    tapp_pmml.add_extension_content(root, "XIDs", [f"u{j}" for j in range(4)])
    tapp_pmml.add_extension_content(root, "YIDs", [f"i{j}" for j in range(600)])
    with tbus.get_broker(loc).producer("OryxUpdate") as p:
        p.send("MODEL", tpmml.to_string(root))
        for j in range(600):
            p.send("UP", join_json(["Y", f"i{j}", [float(v) for v in items[j]]]))
        for j in range(4):
            p.send("UP", join_json(["X", f"u{j}", [float(v) for v in users[j]]]))
    layers = [ServingLayer(layer_config(loc, extra)) for _ in range(2)]
    try:
        for layer in layers:
            layer.start()
        deadline = time.monotonic() + 30
        for layer in layers:
            while time.monotonic() < deadline:
                model = layer.model_manager.get_model()
                if model is not None and model.y.size() == 600 and model.x.size() == 4:
                    break
                time.sleep(0.05)
        bases = [f"http://127.0.0.1:{layer.port}" for layer in layers]
        for base in bases:  # builds each replica's own index
            assert len(http_json(f"{base}/recommend/u0")) > 0
        first = layers[0].model_manager.get_model()
        while time.monotonic() < deadline and first._index_pressure_cb is None:
            time.sleep(0.05)  # the maintainer has hooked the model
        with tbus.get_broker(loc).producer("OryxUpdate") as p:
            for j in range(40):  # past the 16 overlay slots; each user's folds top its list
                fold = (3.0 + 0.1 * j) * users[j % 4]
                p.send("UP", join_json(["Y", f"f{j}", [float(v) for v in fold]]))
        while time.monotonic() < deadline and first.y.size() < 640:
            time.sleep(0.05)
        # the refresh (after the model's 0.2 s throttle) spills and wakes
        # the maintainer; the overlay shows the fold-ins at once
        while time.monotonic() < deadline and not http_json(
            f"{bases[0]}/recommend/u0"
        )[0]["id"].startswith("f"):
            time.sleep(0.05)
        second = layers[1].model_manager.get_model()
        while time.monotonic() < deadline and not (
            first.index_generation is not None
            and second.index_generation == first.index_generation
        ):
            time.sleep(0.05)
        assert first.index_generation is not None
        assert second.index_generation == first.index_generation
        for u in range(4):
            answers = [
                [r["id"] for r in http_json(f"{base}/recommend/u{u}?howMany=12")]
                for base in bases
            ]
            assert answers[0] == answers[1]
            assert answers[0][0].startswith("f")
    finally:
        for layer in layers:
            layer.close()
