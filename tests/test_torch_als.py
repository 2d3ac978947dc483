"""The port's ALS ops (oryx_tpu_torch/ops/als.py, ops/packing.py) against
the JAX package's (oryx_tpu/ops/als.py, ops/packing.py), on the CPU.

The same seeded numpy inputs go through both; the tolerances are the
reference's own (tests/ops/test_als_ops.py): factors within rtol 2e-2,
atol 2e-3 (its naive-solver parity), fold-in within rtol 1e-4, atol
1e-5, buckets and partitioned fold sessions bit for bit.
"""

import numpy as np
import pytest

from oryx_tpu.ops import als as jax_als
from oryx_tpu.ops import packing as jax_packing
from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.als.common import compute_updated_xu
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common.vectormath import Solver
from oryx_tpu_torch.ops import als as als_ops
from oryx_tpu_torch.ops import packing

FACTORS = dict(rtol=2e-2, atol=2e-3)
FOLD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


def low_rank_ratings(num_users=60, num_items=40, k=4, density=0.5, seed=7, noise=0.01):
    gen = np.random.default_rng(seed)
    xt = gen.standard_normal((num_users, k))
    yt = gen.standard_normal((num_items, k))
    mask = gen.random((num_users, num_items)) < density
    u, i = np.nonzero(mask)
    v = (xt @ yt.T)[u, i] + noise * gen.standard_normal(len(u))
    return u.astype(np.int32), i.astype(np.int32), v.astype(np.float32)


def skewed_ratings(seed=21, num_users=60, num_items=40, nnz=600, implicit=False):
    """Unique (user, item) pairs, one heavy user, power-law items."""
    gen = np.random.default_rng(seed)
    w = (1.0 / (np.arange(num_items) + 2.0)) ** 0.9
    u = np.concatenate([np.zeros(35, np.int64), gen.integers(0, num_users, nnz)])
    i = np.concatenate([np.arange(35), gen.choice(num_items, size=nnz, p=w / w.sum())])
    pair = u * num_items + i
    _, first = np.unique(pair, return_index=True)
    u, i = u[first].astype(np.int32), i[first].astype(np.int32)
    if implicit:
        v = (1.0 + gen.random(len(u))).astype(np.float32)
    else:
        v = gen.integers(1, 6, len(u)).astype(np.float32)
    return u, i, v, num_users, num_items


# -- packing -------------------------------------------------------------------


def _assert_identical(ref, got):
    assert len(ref) == len(got)
    for rb, gb in zip(ref, got):
        assert rb.chunk == gb.chunk
        for name in ("rows", "idx", "val", "deg"):
            r, g = getattr(rb, name), getattr(gb, name)
            assert r.dtype == g.dtype
            np.testing.assert_array_equal(r, g)


def power_law_coo():
    gen = np.random.default_rng(42)
    num_users, num_items, nnz = 20_000, 900, 120_000
    w = (1.0 / (np.arange(num_users) + 5.0)) ** 0.9
    u = gen.choice(num_users, size=nnz, p=w / w.sum()).astype(np.int32)
    i = gen.integers(0, num_items, nnz).astype(np.int32)
    return u, i, gen.random(nnz).astype(np.float32), num_users, num_items


def duplicate_coo():
    """Duplicate pairs with distinct values, rows straddling the 65,536-row
    radix block, interleaved arrival order."""
    gen = np.random.default_rng(7)
    num_users = 70_000
    hot = np.array([0, 1, 65535, 65536, 65537, 69_999], dtype=np.int32)
    u = np.concatenate([
        np.tile(hot, 2_000), gen.integers(0, num_users, 20_000, dtype=np.int32),
        np.repeat(hot, 100),
    ])
    nnz = len(u)
    i = np.tile(np.array([3, 3, 1, 0, 2], dtype=np.int32), nnz // 5 + 1)[:nnz]
    return u, i, np.arange(nnz, dtype=np.float32), num_users, 4


@pytest.mark.parametrize("data", [power_law_coo, duplicate_coo], ids=["power-law", "duplicates"])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("stable_shapes", [True, False])
def test_buckets_bit_identical_to_jax(data, workers, stable_shapes):
    """The port's buckets equal the JAX package's build_neighbor_buckets
    and its single-process reference, in both orientations, in-process
    and through forked workers."""
    u, i, v, num_users, num_items = data()
    opts = packing.PackingOptions(workers=workers, chunk_rows=10_000)
    jopts = jax_packing.PackingOptions(workers=workers, chunk_rows=10_000)
    for rows, cols, nr in ((u, i, num_users), (i, u, num_items)):
        kw = dict(num_shards=1, features=50, stable_shapes=stable_shapes)
        got = als_ops.build_neighbor_buckets(rows, cols, v, nr, options=opts, **kw)
        if workers > 1:
            assert packing.last_pack_stats["workers"] == workers
        _assert_identical(jax_als.build_neighbor_buckets(rows, cols, v, nr, options=jopts, **kw), got)
        _assert_identical(jax_packing.build_neighbor_buckets_reference(rows, cols, v, nr, **kw), got)
        _assert_identical(packing.build_neighbor_buckets_reference(rows, cols, v, nr, **kw), got)


def test_build_neighbor_block_matches_jax():
    u, i, v = low_rank_ratings()
    want = jax_als.build_neighbor_block(u, i, v, num_rows=60, pad_rows_to=8)
    got = als_ops.build_neighbor_block(u, i, v, num_rows=60, pad_rows_to=8)
    for name in ("idx", "val", "mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.num_rows == want.num_rows == 64


# -- training ------------------------------------------------------------------


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
def test_train_als_matches_jax(implicit):
    u, i, v, nu, ni = skewed_ratings(implicit=implicit)
    kw = dict(features=5, lam=0.05, alpha=1.0, implicit=implicit, iterations=3, seed=9)
    want = jax_als.train_als(u, i, v, nu, ni, **kw)
    got = als_ops.train_als(u, i, v, nu, ni, **kw)
    np.testing.assert_allclose(got.x, want.x, **FACTORS)
    np.testing.assert_allclose(got.y, want.y, **FACTORS)
    assert set(als_ops.last_phase_seconds) == {"pack", "init", "iterate"}


def _cosine(a, b):
    return float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
def test_train_als_bfloat16_matches_jax(implicit):
    """matmul_dtype = bfloat16. The first half-sweep starts from the same
    init on both sides, so its user factors hold the factor bar. After
    it the two sides' factors differ in f32 rounding (the port solves by
    Cholesky, JAX by LU), and rounding those to bfloat16 moves single
    entries by a bfloat16 step (2**-8 relative): from there on the
    factorizations are held to the reference's own bfloat16 bar
    (tests/ops/test_als_ops.py::test_matmul_dtype_bfloat16_quality_parity:
    cosine above 0.99, training RMSE within 0.05)."""
    u, i, v, nu, ni = skewed_ratings(implicit=implicit)
    kw = dict(features=5, lam=0.05, alpha=1.0, implicit=implicit, seed=9,
              matmul_dtype="bfloat16")
    want = jax_als.train_als(u, i, v, nu, ni, iterations=1, **kw)
    got = als_ops.train_als(u, i, v, nu, ni, iterations=1, **kw)
    np.testing.assert_allclose(got.x, want.x, **FACTORS)
    want = jax_als.train_als(u, i, v, nu, ni, iterations=3, **kw)
    got = als_ops.train_als(u, i, v, nu, ni, iterations=3, **kw)
    assert _cosine(got.x, want.x) > 0.99 and _cosine(got.y, want.y) > 0.99
    r_got = als_ops.rmse(got.x, got.y, u, i, v)
    r_want = jax_als.rmse(want.x, want.y, u, i, v)
    assert abs(r_got - r_want) < 0.05


def test_train_als_small_workspace_matches_jax():
    """A workspace of 64 elements makes chunk = 1 in every bucket, and a
    solve of one row's system at a time: the same factors."""
    u, i, v = low_rank_ratings(num_users=50, num_items=20)
    kw = dict(features=4, lam=0.05, implicit=False, iterations=3, seed=9)
    want = jax_als.train_als(u, i, v, 50, 20, **kw)
    got = als_ops.train_als(u, i, v, 50, 20, workspace_elems=64, **kw)
    np.testing.assert_allclose(got.x, want.x, **FACTORS)
    np.testing.assert_allclose(got.y, want.y, **FACTORS)


def test_solve_in_pieces_matches_whole_chunk(monkeypatch):
    """Building and solving a chunk's systems in pieces changes nothing:
    every row is independent."""
    import torch

    u, i, v, nu, ni = skewed_ratings(implicit=True)
    buckets = als_ops.build_neighbor_buckets(u, i, v, nu, features=6)
    args = als_ops.bucket_tensors(buckets, "cpu")
    y = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 6)).astype(np.float32))
    whole = als_ops._sweep_buckets(y, 64, args, 0.1, 1.0, True)
    monkeypatch.setattr(als_ops, "SOLVE_ELEMS", 36 * 3)  # three rows' systems at a time
    pieces = als_ops._sweep_buckets(y, 64, args, 0.1, 1.0, True)
    np.testing.assert_allclose(pieces[:nu].numpy(), whole[:nu].numpy(), rtol=1e-5, atol=1e-6)


def test_singular_system_solves_to_nan_without_raising():
    import torch

    a = torch.stack([torch.eye(3) * 2.0, torch.zeros(3, 3), torch.diag(torch.tensor([1.0, 0.0, 1.0]))])
    x = als_ops._solve(a, torch.ones(3, 3))
    np.testing.assert_allclose(x[0].numpy(), [0.5, 0.5, 0.5])
    assert torch.isnan(x[1:]).all()


def test_singular_systems_do_not_raise():
    """Explicit feedback with lam = 0 trains, and matches the JAX
    package's factors, where every real row's system is nonsingular."""
    u, i, v = low_rank_ratings(k=3)  # every real row has degree >= 3
    kw = dict(features=3, lam=0.0, implicit=False, iterations=2, seed=4)
    want = jax_als.train_als(u, i, v, 60, 40, **kw)
    got = als_ops.train_als(u, i, v, 60, 40, **kw)
    assert np.isfinite(want.x).all() and np.isfinite(got.x).all()
    np.testing.assert_allclose(got.x, want.x, **FACTORS)
    np.testing.assert_allclose(got.y, want.y, **FACTORS)


@pytest.mark.parametrize("shape_ok", [True, False], ids=["warm", "cold-fallback"])
def test_warm_start_matches_jax(shape_ok):
    u, i, v, nu, ni = skewed_ratings(implicit=True)
    gen = np.random.default_rng(3)
    init = gen.standard_normal((ni if shape_ok else ni - 1, 5)).astype(np.float32) * 0.3
    kw = dict(features=5, lam=0.05, alpha=2.0, implicit=True, iterations=1, seed=8, init_y=init)
    want = jax_als.train_als(u, i, v, nu, ni, **kw)
    got = als_ops.train_als(u, i, v, nu, ni, **kw)
    np.testing.assert_allclose(got.x, want.x, **FACTORS)
    np.testing.assert_allclose(got.y, want.y, **FACTORS)


@pytest.mark.parametrize("kwargs", [{"mesh": object()}, {"shard_factors": True}],
                         ids=["mesh", "shard_factors"])
def test_mesh_and_sharded_factors_raise(kwargs):
    u, i, v = low_rank_ratings()
    with pytest.raises(NotYetPortedError, match="mesh"):
        als_ops.train_als(u, i, v, 60, 40, features=4, lam=0.1, **kwargs)


def test_bad_matmul_dtype_raises():
    u, i, v = low_rank_ratings()
    with pytest.raises(ValueError, match="matmul_dtype"):
        als_ops.train_als(u, i, v, 60, 40, features=4, lam=0.1, matmul_dtype="float16")


# -- evaluation ----------------------------------------------------------------


def test_rmse_and_predictions_match_jax():
    u, i, v, nu, ni = skewed_ratings()
    m = jax_als.train_als(u, i, v, nu, ni, features=5, lam=0.1, implicit=False,
                          iterations=2, seed=1)
    np.testing.assert_allclose(
        als_ops.predict_pairs(m.x, m.y, u, i), jax_als.predict_pairs(m.x, m.y, u, i),
        rtol=1e-5, atol=1e-6,
    )
    assert als_ops.rmse(m.x, m.y, u, i, v) == pytest.approx(
        jax_als.rmse(m.x, m.y, u, i, v), rel=1e-5
    )
    assert np.isnan(als_ops.rmse(m.x, m.y, u[:0], i[:0], v[:0]))


def test_mean_auc_matches_jax():
    """The same rng draws the same negatives on the host; the scores and
    comparisons run in torch."""
    u, i, v, nu, ni = skewed_ratings(implicit=True, nnz=900)
    m = jax_als.train_als(u, i, v, nu, ni, features=6, lam=0.01, alpha=10.0,
                          implicit=True, iterations=4, seed=11)
    want = jax_als.mean_auc(m.x, m.y, u, i, np.random.default_rng(5))
    got = als_ops.mean_auc(m.x, m.y, u, i, np.random.default_rng(5))
    assert got == pytest.approx(want, abs=1e-3)
    assert np.isnan(als_ops.mean_auc(m.x, m.y, u[:0], i[:0], np.random.default_rng(5)))


# -- fold-in -------------------------------------------------------------------


def _fold_inputs(gen, n, k):
    xu = gen.standard_normal((n, k)).astype(np.float32)
    yi = gen.standard_normal((n, k)).astype(np.float32)
    xu_valid = gen.random(n) < 0.9
    yi_valid = gen.random(n) < 0.9
    values = gen.standard_normal(n).astype(np.float32)
    return xu, xu_valid, yi, yi_valid, values


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("k", [4, 50])
def test_fold_in_batch_matches_jax(implicit, backend, k):
    gen = np.random.default_rng(42 + k)
    g = gen.standard_normal((2 * k, k)).astype(np.float32)
    yty, xtx = (g.T @ g).astype(np.float64), (g.T @ g * 0.5).astype(np.float64)
    args = _fold_inputs(gen, 300, k)
    want = jax_als.fold_in_batch(yty, xtx, *args, implicit, backend=backend)
    got = als_ops.fold_in_batch(yty, xtx, *args, implicit, backend=backend)
    for g_arr, w_arr in zip(got, want):
        if g_arr.dtype == bool:
            np.testing.assert_array_equal(g_arr, w_arr)
        else:
            np.testing.assert_allclose(g_arr, w_arr, **FOLD)


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("implicit", [True, False])
def test_fold_in_batch_matches_scalar_fold(implicit, backend):
    """The batched fold against ALSUtils' one-event fold
    (``compute_updated_xu``), as the reference's test holds it."""
    gen = np.random.default_rng(42)
    k = 4
    xvecs = {f"U{j}": gen.standard_normal(k).astype(np.float32) for j in range(6)}
    yvecs = {f"I{j}": gen.standard_normal(k).astype(np.float32) for j in range(6)}
    xmat, ymat = np.stack(list(xvecs.values())), np.stack(list(yvecs.values()))
    yty_mat, xtx_mat = ymat.T @ ymat, xmat.T @ xmat
    events = [(("U0", "I0"), 1.0), (("U1", "I1"), -0.5), (("U2", "Inew"), 2.0),
              (("Unew", "I3"), 1.0), (("U4", "I4"), 0.0)]
    n = len(events)
    xu, yi = np.zeros((n, k), np.float32), np.zeros((n, k), np.float32)
    xu_valid, yi_valid = np.zeros(n, bool), np.zeros(n, bool)
    values = np.array([val for _, val in events], np.float32)
    for j, ((u, i), _) in enumerate(events):
        if u in xvecs:
            xu[j], xu_valid[j] = xvecs[u], True
        if i in yvecs:
            yi[j], yi_valid[j] = yvecs[i], True
    new_xu, x_upd, new_yi, y_upd = als_ops.fold_in_batch(
        yty_mat, xtx_mat, xu, xu_valid, yi, yi_valid, values, implicit, backend=backend
    )
    yty, xtx = Solver(yty_mat), Solver(xtx_mat)
    for j, ((u, i), val) in enumerate(events):
        exp_xu = compute_updated_xu(yty, val, xvecs.get(u), yvecs.get(i), implicit)
        exp_yi = compute_updated_xu(xtx, val, yvecs.get(i), xvecs.get(u), implicit)
        assert bool(x_upd[j]) == (exp_xu is not None)
        assert bool(y_upd[j]) == (exp_yi is not None)
        if exp_xu is not None:
            np.testing.assert_allclose(new_xu[j], exp_xu, **FOLD)
        if exp_yi is not None:
            np.testing.assert_allclose(new_yi[j], exp_yi, **FOLD)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_fold_in_singular_gramian_never_emits_nonfinite(backend):
    """A rank-1 YtY: the Cholesky fails (torch: info > 0), every row
    re-solves by pseudo-inverse, as the JAX package's do."""
    gen = np.random.default_rng(5)
    k = 4
    y = np.zeros((3, k), np.float32)
    y[:, 0] = 1.0
    x = gen.standard_normal((3, k)).astype(np.float32)
    yty, xtx = y.T @ y, x.T @ x + 0.1 * np.eye(k, dtype=np.float32)
    values = np.array([1.0, 2.0, 0.5], np.float32)
    valid = np.ones(3, bool)
    got = als_ops.fold_in_batch(yty, xtx, x, valid, y, valid, values, True, backend=backend)
    want = jax_als.fold_in_batch(yty, xtx, x, valid, y, valid, values, True, backend=backend)
    new_xu, x_upd, new_yi, y_upd = got
    assert np.isfinite(new_xu).all() and np.isfinite(new_yi).all()
    assert y_upd.any()
    for g_arr, w_arr in zip(got, want):
        np.testing.assert_allclose(g_arr, w_arr, rtol=1e-4, atol=1e-4)


def test_device_gramian_session_matches_numpy_session():
    gen = np.random.default_rng(3)
    k, n = 5, 40
    g = gen.standard_normal((7, k)).astype(np.float32)
    yty, xtx = (g.T @ g).astype(np.float64), (g.T @ g * 0.5).astype(np.float64)
    args = _fold_inputs(gen, n, k)
    dev = als_ops.FoldInSession(als_ops.device_gramian(yty), als_ops.device_gramian(xtx),
                                True, backend="device")
    plain = als_ops.FoldInSession(yty, xtx, True, backend="device")
    dev.add_block(*args)
    plain.add_block(*args)
    for g_arr, w_arr in zip(dev.solve(), plain.solve()):
        np.testing.assert_array_equal(g_arr, w_arr)
    assert dev.solve() is None


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("implicit", [True, False])
def test_partitioned_fold_merge_bit_identical_to_single_session(implicit, backend):
    gen = np.random.default_rng(7)
    k, n, shards = 4, 96, 4
    g = gen.standard_normal((6, k)).astype(np.float32)
    yty, xtx = (g.T @ g).astype(np.float64), (g.T @ g * 0.5).astype(np.float64)
    xu, xu_valid, yi, yi_valid, values = _fold_inputs(gen, n, k)
    owner = np.arange(n) % shards
    part = als_ops.PartitionedFoldInSession(yty, xtx, implicit, shards, backend=backend)
    for s in range(shards):
        sel = owner == s
        part.add_block(s, xu[sel], xu_valid[sel], yi[sel], yi_valid[sel], values[sel])
    assert part.pending == n
    got = part.solve()
    assert part.pending == 0
    order = np.concatenate([np.flatnonzero(owner == s) for s in range(shards)])
    single = als_ops.FoldInSession(yty, xtx, implicit, backend=backend)
    single.add_block(xu[order], xu_valid[order], yi[order], yi_valid[order], values[order])
    want = single.solve()
    for g_arr, w_arr in zip(got, want):
        if g_arr.dtype == np.float32:
            np.testing.assert_array_equal(g_arr.view(np.uint32), w_arr.view(np.uint32))
        else:
            np.testing.assert_array_equal(g_arr, w_arr)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_partitioned_solve_shard_matches_private_session(backend):
    gen = np.random.default_rng(11)
    k, n = 4, 32
    g = gen.standard_normal((5, k)).astype(np.float32)
    yty, xtx = (g.T @ g).astype(np.float64), (g.T @ g * 0.25).astype(np.float64)
    a, b = _fold_inputs(gen, n, k), _fold_inputs(gen, n, k)
    part = als_ops.PartitionedFoldInSession(yty, xtx, True, 2, backend=backend)
    part.add_block(0, *a)
    part.add_block(1, *b)
    single = als_ops.FoldInSession(yty, xtx, True, backend=backend)
    single.add_block(*a)
    for g_arr, w_arr in zip(part.solve_shard(0), single.solve()):
        np.testing.assert_array_equal(g_arr, w_arr)
    assert part.pending == n and part.session(1).pending == n
    assert part.solve_shard(1) is not None
    assert part.solve_shard(1) is None


def test_partitioned_set_gramians_swaps_every_slice():
    part = als_ops.PartitionedFoldInSession(np.eye(3), np.eye(3), False, 3, backend="host")
    yty2, xtx2 = np.eye(3) * 2.0, np.eye(3) * 3.0
    part.set_gramians(yty2, xtx2)
    for s in range(3):
        assert part.session(s).yty is yty2 and part.session(s).xtx is xtx2
    with pytest.raises(ValueError):
        als_ops.PartitionedFoldInSession(np.eye(3), np.eye(3), False, 0)


def test_auto_backend_locks_in_a_choice(monkeypatch):
    """'auto' runs both backends on the first large batch, returns the
    host result and keeps the faster one for the process."""
    monkeypatch.setattr(als_ops, "_auto_fold_choice", None)
    gen = np.random.default_rng(2)
    k, n = 50, 10_000
    g = gen.standard_normal((2 * k, k)).astype(np.float32)
    yty = (g.T @ g).astype(np.float64)
    args = _fold_inputs(gen, n, k)
    got = als_ops.fold_in_batch(yty, yty, *args, True, backend="auto")
    want = als_ops.fold_in_batch(yty, yty, *args, True, backend="host")
    for g_arr, w_arr in zip(got, want):
        np.testing.assert_array_equal(g_arr, w_arr)
    assert als_ops._auto_fold_choice in ("host", "device")
