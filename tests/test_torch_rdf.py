"""The port's forest ops (``oryx_tpu_torch/ops/forest.py``) against the JAX
package's, on the CPU.

The same seeded numpy inputs go through ``oryx_tpu.ops.forest`` (its
default CPU path: np.bincount histograms, split selection jitted) and the
port's host path and device formulations run on the CPU. Bars: split
features and bins identical; node stats, counts and gains within rtol
1e-5 (classification stats are exact integer sums; regression's float32
sums move with the summation order; gains with the last bit of ``log``,
regression's gains within 16 float32 ulps of the largest second moment,
``VARIANCE_ULPS``).
XLA's ``log`` and torch's may differ by an ulp, which can flip two
candidates whose gains agree to about 1e-7 (the JAX package's own note,
``oryx_tpu/ops/forest.py:342-347``): where a tree differs, its first
differing node must be such a near tie: the port's two best gains there
within 1e-6 relative, and the JAX package's choice within 1e-6 of the
best (regression: within a few float32 ulps of the node's second
moment). Below that node the trees
are not compared.
"""

import numpy as np
import pytest
import torch

from oryx_tpu.ops import forest as jf
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import rng as trng
from oryx_tpu_torch.ops import forest as tf

STATS_RTOL = 1e-5
NEAR_TIE_RTOL = 1e-6
# regression gains are differences of float32 second moments (wyy/w -
# mean^2), whose rounding is about eps32 * wyy/w: torch's CPU cumsum adds
# in float64, XLA's in float32, so gains agree to a few such ulps
VARIANCE_ULPS = 16 * float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    trng.use_test_seed()
    yield
    trng.clear_test_seed()
    port_device.set_device(None)
    InProcessBroker.reset_all()


def _classes(seed, n=600, p=8, bins=16, classes=3):
    gen = np.random.default_rng(seed)
    x = gen.integers(0, bins, (n, p)).astype(np.int32)
    # a few binary columns, as covtype's one-hots
    x[:, p - 2:] = (gen.random((n, 2)) < 0.3).astype(np.int32)
    y = ((x[:, 0] > 7).astype(int) + 2 * (x[:, 1] > 4) + (x[:, p - 1] > 0)) % classes
    flip = gen.random(n) < 0.1
    y[flip] = gen.integers(0, classes, int(flip.sum()))
    return x, y.astype(np.int32), bins, classes


def _regression(seed, n=600, p=8, bins=16):
    gen = np.random.default_rng(seed)
    x = gen.integers(0, bins, (n, p)).astype(np.int32)
    y = (x[:, 0] * 0.7 - 3.0 * (x[:, 3] > 9) + 0.25 * x[:, 2] + gen.standard_normal(n))
    return x, y.astype(np.float32), bins


def _first_difference(a, b, t):
    diff = np.nonzero((a.split_feature[t] != b.split_feature[t])
                      | (a.split_bin[t] != b.split_bin[t]))[0]
    return int(diff[0]) if len(diff) else None


def _subtree(heap, max_nodes):
    out, frontier = [], [heap]
    while frontier:
        out += frontier
        frontier = [c for h in frontier for c in (2 * h + 1, 2 * h + 2) if c < max_nodes]
    return np.asarray(out)


def assert_same_forest(port, ref, binned, targets, kw, num_bins):
    """Identical splits, stats within STATS_RTOL; a differing tree only
    below a near tie. Returns the number of near ties met."""
    ties = 0
    max_nodes = port.split_feature.shape[1]
    if ref.num_classes is None:
        second = ref.node_stats[..., 2] / np.maximum(ref.node_stats[..., 0], 1e-12)
        gain_atol = VARIANCE_ULPS * float(second.max())
        tie_atol, tie_rtol = gain_atol, 0.0
    else:
        gain_atol, tie_atol, tie_rtol = 1e-6, 0.0, NEAR_TIE_RTOL
    for t in range(port.num_trees):
        keep = np.ones(max_nodes, bool)
        node = _first_difference(port, ref, t)
        if node is not None:
            ties += 1
            gains, flats = tf.node_top_gains(binned, targets, port, t, node, num_bins, **kw)
            assert len(gains) >= 2, f"tree {t} node {node}: a difference with one candidate"
            tol = tie_atol + tie_rtol * abs(gains[0])
            assert gains[0] - gains[1] <= tol, (
                f"tree {t} node {node}: not a near tie, best gains {gains[:2]}"
            )
            # the port took its best; the reference's choice is near it
            assert flats[0] == port.split_feature[t, node] * num_bins + port.split_bin[t, node]
            theirs = ref.split_feature[t, node] * num_bins + ref.split_bin[t, node]
            assert gains[0] - gains[flats == theirs][0] <= tol, (t, node, theirs)
            keep[_subtree(node, max_nodes)] = False
            keep[node] = True  # its own stats agree; its split is the near tie
            np.testing.assert_array_equal(
                port.split_feature[t, keep & (np.arange(max_nodes) != node)],
                ref.split_feature[t, keep & (np.arange(max_nodes) != node)],
            )
        else:
            np.testing.assert_array_equal(port.split_feature[t], ref.split_feature[t])
            np.testing.assert_array_equal(port.split_bin[t], ref.split_bin[t])
        np.testing.assert_allclose(port.node_stats[t, keep], ref.node_stats[t, keep],
                                   rtol=STATS_RTOL, atol=1e-3)
        np.testing.assert_allclose(port.node_counts[t, keep], ref.node_counts[t, keep],
                                   rtol=STATS_RTOL)
        gains_keep = keep.copy()
        if node is not None:
            gains_keep[node] = False
        np.testing.assert_allclose(port.gains[t, gains_keep], ref.gains[t, gains_keep],
                                   rtol=STATS_RTOL, atol=gain_atol)
    return ties


PATHS = [("host", "auto", True), ("matmul", "matmul", False), ("scalar", "scalar", False),
         ("reference", "reference", False), ("auto-device", "auto", False)]


@pytest.mark.parametrize("impurity", ["entropy", "gini", "variance"])
@pytest.mark.parametrize("path,hist_mode,host_hist", PATHS, ids=[p[0] for p in PATHS])
def test_train_forest_matches_jax(impurity, path, hist_mode, host_hist):
    """mtry below p, an excluded feature and min_node_size on every path."""
    if impurity == "variance":
        x, y, bins = _regression(11)
        classes = None
    else:
        x, y, bins, classes = _classes(12)
    kw = dict(num_trees=5, max_depth=5, min_node_size=4.0, min_info_gain=0.0,
              impurity=impurity, mtry=3, seed=21, exclude_features={5})
    ref = jf.train_forest(x, y, num_bins=bins, num_classes=classes, **kw)
    port = tf.train_forest(x, y, num_bins=bins, num_classes=classes, hist_mode=hist_mode,
                           host_hist=host_hist, **kw)
    assert port.num_classes == classes
    assert not (port.split_feature == 5).any()
    assert_same_forest(port, ref, x, y, kw, bins)


@pytest.mark.parametrize("host_hist", [True, False], ids=["host", "device"])
def test_more_than_one_tree_chunk(monkeypatch, host_hist):
    """A chunk budget of three trees' rows: the random stream (weights per
    chunk, masks per dispatched level, chunk-wide early exit) stays the
    JAX package's."""
    x, y, bins, classes = _classes(13, n=400)
    budget = 3 * 400 * 8
    monkeypatch.setattr(jf, "_TREE_CHUNK_BUDGET_BYTES", budget)
    monkeypatch.setattr(tf, "_TREE_CHUNK_BUDGET_BYTES", budget)
    kw = dict(num_trees=7, max_depth=6, min_node_size=1.0, min_info_gain=0.0,
              impurity="entropy", mtry=2, seed=5)
    ref = jf.train_forest(x, y, num_bins=bins, num_classes=classes, **kw)
    port = tf.train_forest(x, y, num_bins=bins, num_classes=classes, host_hist=host_hist, **kw)
    assert_same_forest(port, ref, x, y, kw, bins)
    # the chunk-wide early exit: a gain no split reaches stops every chunk
    # at its root, and the masks it did not draw shift no later chunk
    kw["min_info_gain"] = 0.9
    ref = jf.train_forest(x, y, num_bins=bins, num_classes=classes, **kw)
    port = tf.train_forest(x, y, num_bins=bins, num_classes=classes, host_hist=host_hist, **kw)
    assert_same_forest(port, ref, x, y, kw, bins)


def test_jax_device_path_matches_port_device_path():
    """The JAX package's XLA level pass (host_hist=False) against the
    port's, each in its scalar formulation."""
    x, y, bins, classes = _classes(14)
    kw = dict(num_trees=3, max_depth=4, min_node_size=1.0, min_info_gain=0.0,
              impurity="entropy", mtry=4, seed=8)
    ref = jf.train_forest(x, y, num_bins=bins, num_classes=classes, hist_mode="scalar",
                          host_hist=False, **kw)
    port = tf.train_forest(x, y, num_bins=bins, num_classes=classes, hist_mode="scalar",
                           host_hist=False, **kw)
    assert_same_forest(port, ref, x, y, kw, bins)


def test_level_histograms_formulations_equal_jax():
    """One level's [p, L, B, S] tensor, every formulation, against the
    JAX package's on the same routed rows: classification exact."""
    import jax.numpy as jnp

    gen = np.random.default_rng(3)
    n, p, B, C, L = 500, 5, 8, 4, 4
    binned = gen.integers(0, B, (n, p)).astype(np.int32)
    y = gen.integers(0, C, n).astype(np.int32)
    chan = np.eye(C, dtype=np.float32)[y]
    w = gen.poisson(1.0, n).astype(np.float32)
    pos = gen.integers(0, L, n).astype(np.int32)
    want = np.asarray(jf._level_histograms(
        jnp.asarray(binned), jnp.asarray(w), jnp.asarray(y), jnp.asarray(chan),
        jnp.asarray(pos), L, B, "entropy", "reference"))
    for mode in ("matmul", "scalar", "reference"):
        got = tf._level_histograms(
            torch.from_numpy(binned), torch.from_numpy(w), torch.from_numpy(y),
            torch.from_numpy(chan), torch.from_numpy(pos).long(), L, B, "entropy", mode)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)


@pytest.mark.parametrize("mode", ["matmul", "reference"])
def test_regression_histograms_equal_the_host_bincount(mode):
    """Regression's device formulations sum w, w*y and w*y^2 in float64
    and round once, as the host path's np.bincount does, so a level's
    histograms are the host's bit for bit (float32 sums, and on the card
    float32 atomics in a changing order, made the forests differ between
    runs)."""
    gen = np.random.default_rng(5)
    n, p, B, L = 4000, 3, 8, 4
    binned = gen.integers(0, B, (n, p)).astype(np.int32)
    y = (100.0 * gen.standard_normal(n)).astype(np.float32)
    chan = np.stack([np.ones(n, np.float32), y, y * y], axis=1)
    w = gen.poisson(1.0, n).astype(np.float32)
    pos = gen.integers(0, L, n)
    want = tf._host_level_hists(
        np.ascontiguousarray(binned.T), w.astype(np.float64), None,
        (chan[:, 1].astype(np.float64), chan[:, 2].astype(np.float64)), pos, L, B, 3,
    )
    got = tf._level_histograms(
        torch.from_numpy(binned), torch.from_numpy(w), torch.zeros(n, dtype=torch.int32),
        torch.from_numpy(chan), torch.from_numpy(pos), L, B, "variance", mode,
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_formulation_budget_is_the_jax_packages():
    assert tf._MM_FLOP_BUDGET == jf._MM_FLOP_BUDGET
    assert tf._MM_ELEM_BUDGET == jf._MM_ELEM_BUDGET
    assert tf._TREE_CHUNK_BUDGET_BYTES == jf._TREE_CHUNK_BUDGET_BYTES
    # covtype's published size takes the scalar path from the root on;
    # bench_rdf's 100,000 rows x 32 bins takes matmul at the root only
    assert tf.formulation(581_012, 54, 7, 1, 100, "entropy", "auto") == "scalar"
    assert tf.formulation(100_000, 54, 7, 1, 32, "entropy", "auto") == "matmul"
    assert tf.formulation(100_000, 54, 7, 2, 32, "entropy", "auto") == "scalar"
    assert tf.formulation(100_000, 54, 3, 8, 32, "variance", "auto") == "vector"
    assert tf.formulation(10, 2, 3, 1, 4, "entropy", "reference") == "vector"


@pytest.mark.parametrize("regression", [False, True], ids=["classification", "regression"])
def test_predict_and_importances_match_jax(regression):
    if regression:
        x, y, bins = _regression(15)
        classes, imp = None, "variance"
    else:
        x, y, bins, classes = _classes(15)
        imp = "entropy"
    ref = jf.train_forest(x, y, num_bins=bins, num_classes=classes, num_trees=6, max_depth=5,
                          impurity=imp, seed=4)
    forest = tf.ForestArrays(ref.split_feature, ref.split_bin, ref.node_stats,
                             ref.node_counts, ref.gains, ref.num_classes)
    got = tf.predict_forest_binned(forest, x)
    want = jf.predict_forest_binned(ref, x)
    assert got.dtype == np.float32 and got.shape == want.shape
    # the same float32 adds in the same tree order
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tf.feature_importances(forest, x.shape[1]),
                                  jf.feature_importances(ref, x.shape[1]))


def test_node_top_gains_names_the_chosen_split(monkeypatch):
    """The replayed candidates at a split node put the trainer's own split
    first, at the trainer's own gain, across two tree chunks."""
    x, y, bins, classes = _classes(16, n=300)
    monkeypatch.setattr(tf, "_TREE_CHUNK_BUDGET_BYTES", 2 * 300 * 8)
    kw = dict(num_trees=4, max_depth=4, min_node_size=2.0, min_info_gain=0.0,
              impurity="entropy", mtry=3, seed=9, exclude_features={0})
    forest = tf.train_forest(x, y, num_bins=bins, num_classes=classes, **kw)
    checked = 0
    for t in range(4):
        for heap in np.nonzero(forest.split_feature[t] >= 0)[0][:6]:
            gains, flats = tf.node_top_gains(x, y, forest, t, int(heap), bins, **kw)
            assert flats[0] == forest.split_feature[t, heap] * bins + forest.split_bin[t, heap]
            assert gains[0] == np.float32(forest.gains[t, heap])
            checked += 1
    assert checked >= 12


def test_a_cuda_device_takes_the_device_path(monkeypatch):
    """On a card, train_forest runs the level loop on the device: the host
    path (np.bincount) is never taken, and its histograms, split
    selection and routing all go through the device functions."""
    x, y, bins, classes = _classes(19, n=120)
    taken = []
    monkeypatch.setattr(tf, "resolve", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(tf, "_train_device_chunks", lambda st, dev, *a: taken.append(dev))
    monkeypatch.setattr(tf, "_train_host_chunks", lambda *a: pytest.fail("host path taken"))
    tf.train_forest(x, y, num_bins=bins, num_classes=classes, num_trees=2, max_depth=2)
    assert taken == [torch.device("cuda")]


def test_device_path_runs_no_bincount(monkeypatch):
    x, y, bins, classes = _classes(20, n=200)
    want = tf.train_forest(x, y, num_bins=bins, num_classes=classes, num_trees=3, max_depth=4,
                           seed=3)
    monkeypatch.setattr(np, "bincount", lambda *a, **k: pytest.fail("np.bincount ran"))
    got = tf.train_forest(x, y, num_bins=bins, num_classes=classes, num_trees=3, max_depth=4,
                          seed=3, host_hist=False)
    np.testing.assert_array_equal(got.split_feature, want.split_feature)
    np.testing.assert_array_equal(got.node_counts, want.node_counts)


def test_mesh_grows_the_jax_packages_forest():
    """Rows sharded over eight CPU shards, level histograms summed by one
    all_reduce_sum: the JAX package's mesh forest (its eight virtual
    devices), split for split (tests/ops/test_forest.py:8's bar: the
    classification histograms are exact sums either way)."""
    from oryx_tpu.parallel.mesh import get_mesh as jax_mesh

    from oryx_tpu_torch.parallel.mesh import get_mesh

    x, y, bins, classes = _classes(17)
    kw = dict(num_bins=bins, num_classes=classes, num_trees=3, max_depth=4, seed=3)
    want = jf.train_forest(x, y, mesh=jax_mesh(), **kw)
    got = tf.train_forest(x, y, mesh=get_mesh(devices=["cpu"] * 8), **kw)
    np.testing.assert_array_equal(got.split_feature, want.split_feature)
    np.testing.assert_array_equal(got.split_bin, want.split_bin)
    np.testing.assert_array_equal(got.node_counts, want.node_counts)


def test_train_forest_raises_without_cuda_unless_cpu_chosen(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_device.set_device(None)
    x, y, bins, classes = _classes(17, n=50)
    with pytest.raises(RuntimeError, match="set_device"):
        tf.train_forest(x, y, num_bins=bins, num_classes=classes, num_trees=1)
    with pytest.raises(RuntimeError, match="set_device"):
        tf.predict_forest_binned(
            tf.train_forest(x, y, num_bins=bins, num_classes=classes, num_trees=1,
                            device="cpu"), x)


# -- the JAX package's own forest cases, run on the port ----------------------
# (tests/ops/test_forest.py and tests/ops/test_trainers.py:47-62)


def _naive_best_split(x, y_stats, num_bins, kind):
    """Exhaustive (feature, bin) split search, straight from the math:
    gain = imp(parent) - (n_l*imp(l) + n_r*imp(r)) / n, entropy in nats,
    split 'bin <= b' goes left, last bin never valid."""
    import math

    def imp(stats):
        if kind == "variance":
            w, wy, wyy = stats
            if w <= 0:
                return 0.0
            m = wy / w
            return max(wyy / w - m * m, 0.0)
        tot = sum(stats)
        if tot <= 0:
            return 0.0
        e = 0.0
        for c in stats:
            q = c / tot
            if q > 0:
                e += q * q if kind == "gini" else -q * math.log(q)
        return 1.0 - e if kind == "gini" else e

    def count(stats):
        return stats[0] if kind == "variance" else sum(stats)

    n, p = x.shape
    ys = np.asarray(y_stats, np.float64)
    parent = ys.sum(axis=0).tolist()
    best = (-np.inf, None, None)
    for f in range(p):
        for b in range(num_bins - 1):
            left = ys[x[:, f] <= b].sum(axis=0).tolist()
            right = [parent[s] - left[s] for s in range(len(parent))]
            if count(left) < 1.0 or count(right) < 1.0:
                continue
            g = imp(parent) - (count(left) * imp(left) + count(right) * imp(right)) / count(parent)
            if g > best[0] + 1e-12:
                best = (g, f, b)
    return best


@pytest.mark.parametrize("host_hist", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("kind", ["entropy", "gini", "variance"])
def test_root_split_matches_exhaustive_search(kind, host_hist):
    gen = np.random.default_rng(123)
    n, p, num_bins = 300, 5, 8
    x = gen.integers(0, num_bins, (n, p)).astype(np.int32)
    if kind == "variance":
        y = (x[:, 2] * 1.7 - (x[:, 4] > 3) * 5.0 + gen.standard_normal(n)).astype(np.float32)
        stats = [(1.0, float(v), float(v * v)) for v in y]
        forest = tf.train_forest(x, y, num_bins=num_bins, num_classes=None, num_trees=1,
                                 max_depth=1, impurity="variance", mtry=p, seed=5,
                                 host_hist=host_hist)
    else:
        y = ((x[:, 1] > 4).astype(int) * 2 + (x[:, 3] > 2).astype(int)) % 3
        y = np.where(gen.random(n) < 0.1, gen.integers(0, 3, n), y).astype(np.int32)
        stats = [tuple(1.0 if c == yi else 0.0 for c in range(3)) for yi in y]
        forest = tf.train_forest(x, y, num_bins=num_bins, num_classes=3, num_trees=1,
                                 max_depth=1, impurity=kind, mtry=p, seed=5,
                                 host_hist=host_hist)
    want_gain, want_f, want_b = _naive_best_split(x, stats, num_bins, kind)
    assert forest.split_feature[0, 0] == want_f
    assert forest.split_bin[0, 0] == want_b
    np.testing.assert_allclose(forest.gains[0, 0], want_gain, rtol=1e-4)


@pytest.mark.parametrize("host_hist", [True, False], ids=["host", "device"])
def test_regression_stats_channels_and_leaf_means(host_hist):
    gen = np.random.default_rng(9)
    n = 400
    x = gen.integers(0, 8, (n, 3)).astype(np.int32)
    y = np.where(x[:, 0] <= 3, 2.0, 7.0).astype(np.float32)
    forest = tf.train_forest(x, y, num_bins=8, num_classes=None, num_trees=1, max_depth=1,
                             impurity="variance", mtry=3, seed=1, host_hist=host_hist)
    np.testing.assert_allclose(forest.node_stats[0, 0], [n, y.sum(), (y * y).sum()], rtol=1e-5)
    assert forest.split_feature[0, 0] == 0 and forest.split_bin[0, 0] == 3
    left, right = forest.node_stats[0, 1], forest.node_stats[0, 2]
    np.testing.assert_allclose(left + right, forest.node_stats[0, 0], rtol=1e-5)
    np.testing.assert_allclose(left[1] / left[0], 2.0, rtol=1e-5)
    np.testing.assert_allclose(right[1] / right[0], 7.0, rtol=1e-5)
    pred = tf.predict_forest_binned(forest, x)
    np.testing.assert_allclose(pred[:, 1] / pred[:, 0], y, rtol=1e-4)


@pytest.mark.parametrize("host_hist", [True, False], ids=["host", "device"])
def test_mtry_mask_varies_features_across_trees(host_hist):
    gen = np.random.default_rng(4)
    n, p = 600, 8
    x = gen.integers(0, 4, (n, p)).astype(np.int32)
    y = (x.sum(axis=1) > (1.5 * p)).astype(np.int32)
    forest = tf.train_forest(x, y, num_bins=4, num_classes=2, num_trees=24, max_depth=1,
                             mtry=1, seed=7, host_hist=host_hist)
    roots = set(forest.split_feature[:, 0].tolist()) - {-1}
    assert len(roots) >= 4, f"mtry mask not varying: {roots}"
    stump = tf.train_forest(x, y, num_bins=4, num_classes=2, num_trees=2, max_depth=3,
                            min_info_gain=1e9, seed=7, host_hist=host_hist)
    assert (stump.split_feature == -1).all()


@pytest.mark.parametrize("host_hist", [True, False], ids=["host", "device"])
def test_exclude_features_never_split(host_hist):
    gen = np.random.default_rng(2)
    x = gen.integers(0, 8, (300, 4)).astype(np.int32)
    y = (x[:, 1] > 3).astype(np.int32)  # feature 1 is perfectly predictive
    forest = tf.train_forest(x, y, num_bins=8, num_classes=2, num_trees=5, max_depth=3,
                             exclude_features={1}, seed=3, host_hist=host_hist)
    assert not (forest.split_feature == 1).any()


@pytest.mark.parametrize("host_hist", [True, False], ids=["host", "device"])
def test_min_node_size_respected(host_hist):
    gen = np.random.default_rng(8)
    x = gen.integers(0, 16, (200, 4)).astype(np.int32)
    y = gen.integers(0, 2, 200).astype(np.int32)
    min_sz = 40.0
    forest = tf.train_forest(x, y, num_bins=16, num_classes=2, num_trees=1, max_depth=4,
                             min_node_size=min_sz, seed=6, host_hist=host_hist)
    for node in np.nonzero(forest.split_feature[0] >= 0)[0]:
        assert forest.node_counts[0, 2 * node + 1] >= min_sz
        assert forest.node_counts[0, 2 * node + 2] >= min_sz


def _trainer_inputs():
    gen = np.random.default_rng(7)
    binned = gen.integers(0, 8, size=(160, 4)).astype(np.int32)
    targets = ((binned[:, 0] > 3) ^ (binned[:, 1] > 5)).astype(np.int32)
    return binned, targets


def _grow(binned, targets, **kw):
    return tf.train_forest(binned, targets, num_bins=8, num_classes=2, num_trees=2,
                           max_depth=2, seed=13, **kw)


def test_rdf_hist_modes_grow_identical_forests():
    binned, targets = _trainer_inputs()
    ref = _grow(binned, targets, hist_mode="reference", host_hist=False)
    for mode in ("matmul", "scalar"):
        out = _grow(binned, targets, hist_mode=mode, host_hist=False)
        np.testing.assert_array_equal(out.split_feature, ref.split_feature)
        np.testing.assert_array_equal(out.split_bin, ref.split_bin)
        np.testing.assert_allclose(out.node_counts, ref.node_counts)


def test_rdf_host_bincount_matches_device():
    binned, targets = _trainer_inputs()
    dev = _grow(binned, targets, hist_mode="matmul", host_hist=False)
    host = _grow(binned, targets, hist_mode="auto", host_hist=True)
    np.testing.assert_array_equal(host.split_feature, dev.split_feature)
    np.testing.assert_array_equal(host.split_bin, dev.split_bin)


def test_stage_hook_wraps_each_tree_level():
    x, y, bins, classes = _classes(18, n=200)
    seen = []

    class Stage:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            seen.append(self.name)

        def __exit__(self, *exc):
            return False

    forest = tf.train_forest(x, y, num_bins=bins, num_classes=classes, num_trees=3,
                             max_depth=3, seed=2, host_hist=False, stage=Stage)
    levels = 1 + int(np.log2(np.nonzero((forest.split_feature >= 0).any(axis=0))[0].max() + 1)) + 1
    assert seen == ["histograms", "splits", "routing"] * 3 * min(levels, 4)
    assert set(tf.last_phase_seconds) == {"init", "iterate"}
