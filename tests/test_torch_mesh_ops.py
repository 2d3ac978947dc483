"""The port's mesh paths of the ops and apps against the JAX package's, on
the CPU: the port on eight CPU shards, the JAX package on the suite's
eight virtual CPU devices (tests/conftest.py), the same seeded numpy
inputs through both.

Bars are the JAX tests' own between sharded and single-device runs:
- ``top_k_sharded``: float32 values within 1e-5 and ids equal (ties to
  the lowest id; tests/ops/test_pallas_topn.py:100, :121); bfloat16 ids
  equal, values within its precision; int8 recall@10 of at least 0.99
  and the clear top set the single-device scan's
  (tests/ops/test_int8_scan.py:133);
- k-means: counts equal, centers within 1e-5, cost within rtol 1e-4
  (tests/app/kmeans/test_kmeans.py:58);
- forests: classification split for split (tests/ops/test_forest.py:8),
  regression splits equal and leaf statistics within rtol 1e-5;
- ALS: factors within the reference's parity bars rtol 2e-2, atol 2e-3,
  predictions within tests/ops/test_als_ops.py:92's 1e-2, :262's and
  :273's bars against one device; ``_sharded_layout`` and
  ``_translate_to_shards`` bit for bit;
- ``KMeansUpdate``, ``ALSUpdate`` and ``RDFUpdate`` with
  ``oryx.batch.compute.mesh`` against the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from oryx_tpu.ops import als as jals
from oryx_tpu.ops import forest as jforest
from oryx_tpu.ops import kmeans as jkm
from oryx_tpu.ops import topn as jtopn
from oryx_tpu.parallel.mesh import get_mesh as jax_mesh
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import rng as trng
from oryx_tpu_torch.ops import als as tals
from oryx_tpu_torch.ops import forest as tforest
from oryx_tpu_torch.ops import kmeans as tkm
from oryx_tpu_torch.ops import topn as ttopn
from oryx_tpu_torch.parallel.mesh import get_mesh

FACTORS = dict(rtol=2e-2, atol=2e-3)
K = 10
TIE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    trng.use_test_seed()
    yield
    trng.clear_test_seed()
    port_device.set_device(None)
    InProcessBroker.reset_all()


def mesh8():
    return get_mesh(devices=["cpu"] * 8)


# -- top_k_sharded ------------------------------------------------------------------

JAX_DTYPES = {"float32": None, "bfloat16": jnp.bfloat16, "int8": jnp.int8}


def _catalog(n=3000, f=16, b=9, seed=21):
    gen = np.random.default_rng(seed)
    y = gen.standard_normal((n, f)).astype(np.float32)
    y[[3, 1500]] = 0.0  # cold items: score 0, never masked as padding
    y[2001] = y[7]  # an exact tie: the lower id first
    q = gen.standard_normal((b, f)).astype(np.float32)
    return y, q


def _exact(mat, queries, cosine=False):
    ref = queries @ mat.T
    if cosine:
        norms = np.linalg.norm(queries, axis=1)[:, None] * np.linalg.norm(mat, axis=1)[None, :]
        ref = ref / np.maximum(norms, 1e-12)
    return ref


def _recall(mat, queries, idx, k=K, cosine=False):
    """Tie-tolerant recall@k against the exact float32 scan
    (tests/ops/test_int8_scan.py's ``_recall``)."""
    ref = _exact(mat, queries, cosine)
    hits = 0
    for r in range(len(queries)):
        kth = np.partition(ref[r], -k)[-k]
        hits += int(np.sum(ref[r][np.asarray(idx[r])] >= kth - TIE_TOL))
    return hits / (len(queries) * k)


@pytest.mark.parametrize("cosine", [False, True], ids=["dot", "cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_top_k_sharded_matches_jax(dtype, cosine):
    y, q = _catalog()
    y[7] = y[2001] = 3.0 * q[0]  # query 0's top two: the tied pair 7 and 2001
    jup = jtopn.upload_sharded(y, jax_mesh(), dtype=JAX_DTYPES[dtype])
    ji, jv = jtopn.top_k_sharded(jup, q, K, cosine=cosine)
    up = ttopn.upload_sharded(y, mesh8(), dtype=dtype)
    ti, tv = ttopn.top_k_sharded(up, q, K, cosine=cosine)
    assert ti.shape == tv.shape == (9, K) and tv.dtype == np.float32
    if dtype == "int8":
        # the port rescores each shard's int8 candidates, the JAX scan sums
        # both planes in full: recall against the exact scan
        assert _recall(y, q, ti, cosine=cosine) >= 0.99
        assert _recall(y, q, ji, cosine=cosine) >= 0.99
        same = ti == ji  # the two-plane score of one item, either way
        np.testing.assert_allclose(tv[same], jv[same], rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(ti, ji)
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2.0**-7, atol=1e-3)
        np.testing.assert_allclose(tv, jv, **tol)
    if dtype != "int8":
        assert list(ti[0, :2]) == [7, 2001]


@pytest.mark.parametrize("cosine", [False, True], ids=["dot", "cosine"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_top_k_sharded_matches_one_card(dtype, cosine):
    """The sharded scan against the port's own single-device scan on the
    same plane: float32 ids equal and values within 1e-5; int8 the clear
    top set equal (above the tie band), as tests/ops/test_int8_scan.py:133."""
    y, q = _catalog(n=5000, f=12, seed=11)
    ti, tv = ttopn.top_k_sharded(ttopn.upload_sharded(y, mesh8(), dtype=dtype), q, 7, cosine)
    si, sv = ttopn.top_k_scores_batch(ttopn.upload(y, dtype=dtype), q, 7, cosine=cosine)
    if dtype == "float32":
        np.testing.assert_array_equal(ti, si)
        np.testing.assert_allclose(tv, sv, rtol=1e-5, atol=1e-5)
        return
    assert _recall(y, q, ti, k=7, cosine=cosine) >= 0.99
    ref = _exact(y, q, cosine)
    for r in range(len(q)):
        kth = np.partition(ref[r], -7)[-7]
        clear = {i for i in ti[r].tolist() if ref[r][i] > kth + TIE_TOL}
        assert clear <= set(si[r].tolist())


def test_top_k_sharded_edges():
    """Fewer items than shards and k past the catalog; k past the kernels'
    128 takes the plain merge; b past 256 the candidates path."""
    gen = np.random.default_rng(3)
    y = gen.standard_normal((5, 4)).astype(np.float32)
    q = gen.standard_normal((3, 4)).astype(np.float32)
    ti, tv = ttopn.top_k_sharded(ttopn.upload_sharded(y, mesh8()), q, 20)
    ji, jv = jtopn.top_k_sharded(jtopn.upload_sharded(y, jax_mesh()), q, 20)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    y = gen.standard_normal((2000, 8)).astype(np.float32)
    q = gen.standard_normal((300, 8)).astype(np.float32)
    up = ttopn.upload_sharded(y, mesh8())
    for k in (5, 150):
        ti, tv = ttopn.top_k_sharded(up, q, k)
        si, sv = ttopn.top_k_scores_batch(ttopn.upload(y), q, k)
        np.testing.assert_array_equal(ti, si)
        np.testing.assert_allclose(tv, sv, rtol=1e-5, atol=1e-5)


# -- k-means --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3003, 96])
def test_mesh_kmeans_matches_jax_from_the_same_centers(n):
    """Points row-sharded (padded to a multiple of eight, the padding never
    counted), one sweep per shard per iteration, from the same initial
    centers: counts equal, centers within 1e-5, cost within 1e-4."""
    gen = np.random.default_rng(9)
    centers = gen.standard_normal((5, 6)).astype(np.float32) * 6
    pts = (centers[gen.integers(0, 5, n)] + gen.standard_normal((n, 6))).astype(np.float32)
    init = pts[:5].copy()
    jc, jn, jcost = jkm.train_kmeans(pts, 5, iterations=6, mesh=jax_mesh(), initial_centers=init)
    tc, tn, tcost = tkm.train_kmeans(pts, 5, iterations=6, mesh=mesh8(), initial_centers=init)
    np.testing.assert_array_equal(tn, np.asarray(jn))
    assert tn.sum() == n
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-5, atol=1e-5)
    assert tcost == pytest.approx(float(jcost), rel=1e-4)
    # and the port's single-device run from the same centers
    sc, sn, scost = tkm.train_kmeans(pts, 5, iterations=6, initial_centers=init)
    np.testing.assert_array_equal(tn, sn)
    assert tcost == pytest.approx(scost, rel=1e-4)


def test_mesh_kmeans_host_init_draws_like_jax():
    """Under a mesh both packages pick k-means|| on the host from the same
    seed, and mini-batch is off: the same centers."""
    gen = np.random.default_rng(4)
    pts = gen.standard_normal((800, 3)).astype(np.float32)
    jc, jn, _ = jkm.train_kmeans(pts, 4, iterations=3, mesh=jax_mesh(), seed=12,
                                 minibatch_size=100)
    tc, tn, _ = tkm.train_kmeans(pts, 4, iterations=3, mesh=mesh8(), seed=12,
                                 minibatch_size=100)
    np.testing.assert_array_equal(tn, np.asarray(jn))
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-5, atol=1e-5)


# -- forests --------------------------------------------------------------------------


def test_mesh_forest_classification_split_for_split():
    gen = np.random.default_rng(51)
    x = gen.integers(0, 16, (501, 6)).astype(np.int32)
    y = ((x[:, 0] > 7) ^ (x[:, 2] > 3)).astype(np.int32)
    kw = dict(num_bins=16, num_classes=2, num_trees=3, max_depth=4, seed=9)
    want = jforest.train_forest(x, y, mesh=jax_mesh(), **kw)
    got = tforest.train_forest(x, y, mesh=mesh8(), **kw)
    one = tforest.train_forest(x, y, **kw)
    for other in (want, one):
        np.testing.assert_array_equal(got.split_feature, other.split_feature)
        np.testing.assert_array_equal(got.split_bin, other.split_bin)
        np.testing.assert_array_equal(got.node_counts, other.node_counts)
        np.testing.assert_array_equal(got.node_stats, other.node_stats)


def test_mesh_forest_regression():
    gen = np.random.default_rng(52)
    x = gen.integers(0, 8, (403, 5)).astype(np.int32)
    y = (x[:, 0] * 0.7 - x[:, 3] * 0.2 + 0.1 * gen.standard_normal(403)).astype(np.float32)
    kw = dict(num_bins=8, num_classes=None, num_trees=2, max_depth=3, seed=4, impurity="variance")
    want = jforest.train_forest(x, y, mesh=jax_mesh(), **kw)
    got = tforest.train_forest(x, y, mesh=mesh8(), **kw)
    np.testing.assert_array_equal(got.split_feature, want.split_feature)
    np.testing.assert_array_equal(got.split_bin, want.split_bin)
    np.testing.assert_allclose(got.node_stats, want.node_stats, rtol=1e-5, atol=1e-4)


# -- ALS --------------------------------------------------------------------------------


def _ratings(num_users=48, num_items=32, k=4, density=0.5, seed=7):
    gen = np.random.default_rng(seed)
    xt = gen.standard_normal((num_users, k))
    yt = gen.standard_normal((num_items, k))
    u, i = np.nonzero(gen.random((num_users, num_items)) < density)
    v = (xt @ yt.T)[u, i] + 0.01 * gen.standard_normal(len(u))
    return u.astype(np.int32), i.astype(np.int32), v.astype(np.float32)


def _implicit(seed=13):
    gen = np.random.default_rng(seed)
    u = gen.integers(0, 40, 600).astype(np.int32)
    i = gen.integers(0, 30, 600).astype(np.int32)
    v = (np.abs(gen.standard_normal(600)) + 0.1).astype(np.float32)
    return u, i, v, 40, 30


@pytest.mark.parametrize("shard_factors", [False, True], ids=["replicated", "shard_factors"])
@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
def test_mesh_als_matches_jax(implicit, shard_factors):
    if implicit:
        u, i, v, nu, ni = _implicit()
        kw = dict(features=5, lam=0.1, alpha=1.0, implicit=True, iterations=6, seed=33)
    else:
        u, i, v = _ratings()
        nu, ni = 48, 32
        kw = dict(features=4, lam=0.05, implicit=False, iterations=5, seed=123)
    want = jals.train_als(u, i, v, nu, ni, mesh=jax_mesh(), shard_factors=shard_factors, **kw)
    got = tals.train_als(u, i, v, nu, ni, mesh=mesh8(), shard_factors=shard_factors, **kw)
    np.testing.assert_allclose(got.x, want.x, **FACTORS)
    np.testing.assert_allclose(got.y, want.y, **FACTORS)
    # against the port's one-device run, at the JAX tests' bars
    one = tals.train_als(u, i, v, nu, ni, **kw)
    pred_m = tals.predict_pairs(got.x, got.y, u, i)
    pred_1 = tals.predict_pairs(one.x, one.y, u, i)
    tol = dict(atol=5e-2, rtol=5e-2) if implicit else dict(atol=1e-2)
    np.testing.assert_allclose(pred_m, pred_1, **tol)


def test_mesh_als_bfloat16_and_warm_start_match_jax():
    """matmul_dtype = bfloat16 and a warm start over the mesh, held as
    tests/test_torch_als.py holds one device: the first half-sweep's
    factors within the factor bar, then (bfloat16 steps apart) cosine
    above 0.99 and training RMSE within 0.05."""
    u, i, v = _ratings(seed=8)
    init = np.random.default_rng(2).standard_normal((32, 4)).astype(np.float32) * 0.3
    kw = dict(features=4, lam=0.05, alpha=2.0, implicit=True, seed=3,
              matmul_dtype="bfloat16", init_y=init)
    want = jals.train_als(u, i, v, 48, 32, mesh=jax_mesh(), iterations=1, **kw)
    got = tals.train_als(u, i, v, 48, 32, mesh=mesh8(), iterations=1, **kw)
    np.testing.assert_allclose(got.x, want.x, **FACTORS)
    want = jals.train_als(u, i, v, 48, 32, mesh=jax_mesh(), iterations=3, **kw)
    got = tals.train_als(u, i, v, 48, 32, mesh=mesh8(), iterations=3, **kw)
    for a, b in ((got.x, want.x), (got.y, want.y)):
        cos = np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > 0.99
    assert abs(tals.rmse(got.x, got.y, u, i, v) - jals.rmse(want.x, want.y, u, i, v)) < 0.05


@pytest.mark.parametrize("s", [1, 3, 8])
def test_sharded_layout_and_translation_equal_jax(s):
    u, i, v, nu, ni = _implicit(seed=5)
    ub = tals.build_neighbor_buckets(u, i, v, nu, s, features=5)
    ib = tals.build_neighbor_buckets(i, u, v, ni, s, features=5)
    for buckets, rows in ((ub, nu), (ib, ni)):
        got = tals._sharded_layout(buckets, rows, s)
        want = jals._sharded_layout(buckets, rows, s)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2]
    _, pos_y, i_loc = tals._sharded_layout(ib, ni, s)
    for b in ub:
        for g, w in zip(tals._translate_to_shards(b.idx, pos_y, i_loc),
                        jals._translate_to_shards(b.idx, pos_y, i_loc)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_mesh_als_empty_side_returns_zeros_as_jax():
    u = np.zeros(0, np.int32)
    got = tals.train_als(u, u, np.zeros(0, np.float32), 3, 2, features=2, lam=0.1,
                         mesh=mesh8(), shard_factors=True)
    assert got.x.shape == (3, 2) and not got.x.any() and not got.y.any()


# -- the apps with oryx.batch.compute.mesh ---------------------------------------------------


def test_app_updates_take_the_configured_mesh(monkeypatch):
    """KMeansUpdate, ALSUpdate and RDFUpdate pass ``mesh_from_config``'s
    mesh (and ALS ``shard-factors``) to their trainers, as the JAX
    package's updates do."""
    from oryx_tpu_torch.app.als import update as als_update
    from oryx_tpu_torch.app.kmeans import update as km_update
    from oryx_tpu_torch.app.rdf import update as rdf_update
    from oryx_tpu_torch.bus.core import KeyMessage
    from oryx_tpu_torch.common import config as tconfig
    from oryx_tpu_torch.parallel.mesh import device_scope

    seen = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen[name] = (kw.get("mesh"), kw.get("shard_factors"))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(km_update.km_ops, "train_kmeans", spy("kmeans", tkm.train_kmeans))
    monkeypatch.setattr(als_update.als_ops, "train_als", spy("als", tals.train_als))
    monkeypatch.setattr(rdf_update.forest_ops, "train_forest",
                        spy("rdf", tforest.train_forest))
    mesh_conf = "batch.compute { mesh { data = 4 }, shard-factors = true }"
    km_cfg = tconfig.get_default().with_overlay(f"""oryx {{
        input-schema {{ num-features = 2, numeric-features = ["0", "1"] }}
        kmeans {{ hyperparams.k = 2, iterations = 2 }}
        {mesh_conf} }}""")
    als_cfg = tconfig.get_default().with_overlay(f"oryx {{ als.iterations = 2\n{mesh_conf} }}")
    rdf_cfg = tconfig.get_default().with_overlay(f"""oryx {{
        input-schema {{ num-features = 3, categorical-features = ["2"], target-feature = "2" }}
        rdf {{ num-trees = 2, hyperparams {{ max-depth = 3 }} }}
        {mesh_conf} }}""")
    gen = np.random.default_rng(0)
    km_lines = [f"{a:.3f},{b:.3f}" for a, b in gen.standard_normal((40, 2))]
    als_lines = [f"u{a},i{b},1.0,{t}" for t, (a, b) in enumerate(gen.integers(0, 9, (60, 2)))]
    rdf_lines = [f"{a:.3f},{b:.3f},{'x' if a > 0 else 'y'}"
                 for a, b in gen.standard_normal((60, 2))]
    with device_scope(["cpu"] * 4):
        km_update.KMeansUpdate(km_cfg).build_model(
            [KeyMessage(None, m) for m in km_lines], [2], None)
        als_update.ALSUpdate(als_cfg).build_model(
            [KeyMessage(None, m) for m in als_lines], [3, 0.1, 1.0], _tmp())
        rdf_update.RDFUpdate(rdf_cfg).build_model(
            [KeyMessage(None, m) for m in rdf_lines], [8, 3, "entropy"], None)
    for name in ("kmeans", "als", "rdf"):
        mesh, _ = seen[name]
        assert mesh is not None and mesh.size == 4, name
    assert seen["als"][1] is True


def _tmp():
    import tempfile
    from pathlib import Path

    return Path(tempfile.mkdtemp(prefix="mesh-als-"))
