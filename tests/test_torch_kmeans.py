"""The k-means modules of the port against the JAX package, on the CPU.

Inputs are seeded numpy Gaussian blobs fed to both packages. The JAX
sweep runs its Pallas kernel in interpret mode; the port runs the plain
PyTorch versions of its CUDA kernels. Bars are the JAX package's own
(tests/ops/test_pallas_kmeans.py): sums rtol 1e-5 / atol 1e-5, counts
exact, cost rtol 1e-4. The port accumulates sums and cost in float64,
the Pallas kernel in float32, hence a tolerance and not equality.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from oryx_tpu.app.kmeans import common as jcommon
from oryx_tpu.app.schema import InputSchema as JaxInputSchema
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as jpmml
from oryx_tpu.ops import kmeans as jkm
from oryx_tpu.ops import pallas_kmeans as jpk
from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.kmeans import common as tcommon
from oryx_tpu_torch.app.schema import InputSchema as TorchInputSchema
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as tpmml
from oryx_tpu_torch.common import rng as trng
from oryx_tpu_torch.ops import kmeans as tkm
from oryx_tpu_torch.ops import pallas_kmeans as tpk

SUMS_TOL = dict(rtol=1e-5, atol=1e-5)
COST_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    trng.use_test_seed()
    yield
    trng.clear_test_seed()
    port_device.set_device(None)
    InProcessBroker.reset_all()


def blobs(n_per, k, d, seed, spread=8.0):
    gen = np.random.default_rng(seed)
    centers = gen.standard_normal((k, d)) * spread
    pts = np.concatenate([c + gen.standard_normal((n_per, d)) for c in centers])
    return pts.astype(np.float32), centers.astype(np.float32)


def padded_inputs(pts, init):
    k, d = init.shape
    kp = tpk.padded_k(k)
    assert kp == max(8, jpk._ceil_to(k, 8))
    ctr = np.zeros((kp, d), np.float32)
    ctr[:k] = init
    return tpk.pad_to_block(pts), ctr


# n_per * k is never a multiple of 1024 and k never a multiple of 8
SHAPES = [(137, 5, 3), (101, 10, 20), (77, 13, 33)]


@pytest.mark.parametrize("n_per,k,d", SHAPES)
def test_plain_sweep_matches_jax_sweep(n_per, k, d):
    pts, init = blobs(n_per, k, d, seed=n_per)
    # start from perturbed centers so the sweep moves points around
    init = init + np.random.default_rng(1).standard_normal(init.shape).astype(np.float32) * 3
    padded, ctr = padded_inputs(pts, init)
    n = len(pts)
    js, jc, jcost = jpk._sweep(
        jnp.asarray(padded), jnp.asarray(ctr), n_items=n, k_real=k, interpret=True
    )
    ts, tc, tcost = tpk.sweep(torch.from_numpy(padded), torch.from_numpy(ctr), n, k)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SUMS_TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(tcost[0]), float(jcost), rtol=COST_RTOL)
    assert tc.numpy()[k:].sum() == 0  # padded centers attract nothing
    assert tc.numpy().sum() == n  # padding rows count nothing
    assert tpk.launch_counts() == {"kmeans_sweep.tc": 0}  # CPU: plain


# (row, feature or None for all, value): a NaN feature, one inf feature
# (distances inf to some centers, NaN to others), and features whose
# squared norm overflows float32 (every distance inf)
POISON = {
    "nan": [(5, None, np.nan)],
    "inf": [(77, 2, np.inf)],
    "overflow": [(300, None, 1e20)],
    "all": [(5, None, np.nan), (77, 2, np.inf), (300, None, 1e20)],
}


@pytest.mark.parametrize("case", sorted(POISON))
def test_plain_sweep_matches_jax_sweep_on_non_finite_rows(case):
    """A point with a NaN distance adds NaN to the cost and goes to no
    center, as in the JAX kernel; a point at +inf from every center goes
    to the first. The JAX kernel's one-hot matmul also spreads 0 * NaN
    into every center's sum, so the port's sums are held against the JAX
    sweep of the points without the rows that go to no center."""
    pts, init = blobs(101, 5, 4, seed=11)
    for row, col, value in POISON[case]:
        pts[row, slice(None) if col is None else col] = value
    padded, ctr = padded_inputs(pts, init)
    n = len(pts)
    _, jc, jcost = jpk._sweep(
        jnp.asarray(padded), jnp.asarray(ctr), n_items=n, k_real=5, interpret=True
    )
    ts, tc, tcost = tpk.sweep(torch.from_numpy(padded), torch.from_numpy(ctr), n, 5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(tcost[0]), float(jcost), rtol=COST_RTOL)
    # the NaN row and the row with one inf feature (NaN to some centers)
    nowhere = [row for row, col, v in POISON[case] if np.isnan(v) or col is not None]
    assert tc.numpy().sum() == n - len(nowhere)
    assert np.isnan(float(tcost[0])) == bool(nowhere)
    kept = np.delete(pts, nowhere, axis=0)
    clean, _ = padded_inputs(kept, init)
    js, _, _ = jpk._sweep(
        jnp.asarray(clean), jnp.asarray(ctr), n_items=len(kept), k_real=5, interpret=True
    )
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SUMS_TOL)
    assert np.isfinite(ts.numpy()).all()


@pytest.mark.parametrize("k", [1, 5, 300])
@pytest.mark.parametrize("d", [3, 7, 20, 601, 768])
def test_plain_sweep_matches_jax_sweep_at_kernel_shapes(d, k):
    """The shapes the CUDA kernel takes its other paths for: d * 4 not a
    multiple of 16 (3, 7, 601), one center, kp = 304 > 256 (two center
    tiles), and rows too wide for a whole 64-point tile in shared memory
    (601, 768: staged in chunks); padding rows, and n_items below the real
    rows."""
    pts, init = blobs(1500 // k + 40, k, d, seed=31 * d + k)
    init = init + np.random.default_rng(d).standard_normal(init.shape).astype(np.float32)
    padded, ctr = padded_inputs(pts, init)
    n = len(pts) - 13
    js, jc, jcost = jpk._sweep(
        jnp.asarray(padded), jnp.asarray(ctr), n_items=n, k_real=k, interpret=True
    )
    ts, tc, tcost = tpk.sweep(torch.from_numpy(padded), torch.from_numpy(ctr), n, k)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SUMS_TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(tcost[0]), float(jcost), rtol=COST_RTOL)
    assert tc.numpy().sum() == n and tc.numpy()[k:].sum() == 0


def split3(x: torch.Tensor):
    """x as three bf16 pieces, each rounding to nearest even what the earlier
    ones left (csrc/kmeans.cu split_value / split_pair), as f32 tensors."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def six_pass_d2(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The kernel's distances: |p|^2 - 2 p.c + |c|^2 with p.c from six bf16
    products (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid) summed in f32."""
    p, c = split3(points), split3(centers)
    dot = torch.zeros((points.shape[0], centers.shape[0]), dtype=torch.float32)
    for a, b in ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)):
        dot = dot + p[a] @ c[b].T
    return torch.sum(points * points, 1, keepdim=True) - 2.0 * dot + torch.sum(centers**2, 1)


def assert_six_pass_argmin_exact(seed: int, scale: float, n: int = 256, k: int = 48):
    gen = np.random.default_rng(seed)
    centers = (gen.standard_normal((k, 256)) * scale).astype(np.float32)
    pts = centers[gen.integers(0, k, n)] + gen.standard_normal((n, 256)).astype(np.float32)
    p, c = torch.from_numpy(pts), torch.from_numpy(centers)
    for x in (p, c):  # the split is exact
        hi, mid, lo = split3(x)
        assert torch.equal(hi + mid + lo, x)
    got = torch.argmin(six_pass_d2(p, c), dim=1).numpy()
    d64 = ((pts.astype(np.float64)[:, None, :] - centers.astype(np.float64)[None]) ** 2).sum(-1)
    want = np.argmin(d64, axis=1)
    two = np.sort(d64, axis=1)[:, :2]
    near = two[:, 1] - two[:, 0] <= 1e-5 * two[:, 1]
    bad = (got != want) & ~near
    assert not bad.any(), f"rows {np.nonzero(bad)[0][:5]} pick another center"


def test_six_pass_distance_argmin_matches_float64():
    assert_six_pass_argmin_exact(seed=5, scale=0.2)  # centers close: many near rivals


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), scale=st.floats(0.05, 8.0))
def test_six_pass_distance_argmin_matches_float64_hypothesis(seed, scale):
    assert_six_pass_argmin_exact(seed, scale, n=64, k=24)


def test_launch_counts_name_the_tensor_core_sweep():
    """The launch key says which path the sweep took; CPU tensors take the
    plain version and count nothing."""
    pts, init = blobs(50, 3, 4, seed=2)
    padded, ctr = padded_inputs(pts, init)
    tpk.reset_launch_counts()
    tpk.sweep(torch.from_numpy(padded), torch.from_numpy(ctr), len(pts), 3)
    assert tpk.launch_counts() == {"kmeans_sweep.tc": 0}


@pytest.mark.parametrize("iterations", [1, 8])
def test_lloyd_matches_jax_lloyd_pallas(iterations):
    pts, init = blobs(137, 5, 3, seed=9)
    init = init + 2.0
    jc, jn, jcost = jpk.lloyd_pallas(pts, init, iterations=iterations, interpret=True)
    tc, tn, tcost = tpk.lloyd(pts, init, iterations)
    np.testing.assert_allclose(tc, jc, **SUMS_TOL)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tcost, jcost, rtol=COST_RTOL)
    assert tn.sum() == len(pts)


def test_lloyd_accepts_padded_device_points():
    pts, init = blobs(137, 4, 3, seed=21)
    ref = tpk.lloyd(pts, init, 3)
    dev = tpk.lloyd(torch.from_numpy(tpk.pad_to_block(pts)), init, 3, n_items=len(pts))
    np.testing.assert_array_equal(dev[0], ref[0])
    np.testing.assert_array_equal(dev[1], ref[1])
    assert dev[2] == ref[2]
    with pytest.raises(ValueError, match="n_items"):
        tpk.lloyd(torch.from_numpy(tpk.pad_to_block(pts)), init, 3)


def test_minibatch_step_matches_jax_sweep_and_update():
    pts, init = blobs(200, 6, 4, seed=13)
    padded, ctr = padded_inputs(pts, init + 1.5)
    n, batch = len(pts), 300
    gen = np.random.default_rng(4)
    idx = gen.integers(0, n, size=1024)  # the JAX schedule gathers bpad rows
    v0 = np.abs(gen.standard_normal(ctr.shape[0])).astype(np.float32) * 10
    # the JAX package's step: _sweep on points[idx], then pallas_kmeans.py:189-190
    xb = jnp.asarray(padded)[jnp.asarray(idx)]
    sums, counts, _ = jpk._sweep(xb, jnp.asarray(ctr), n_items=batch, k_real=6, interpret=True)
    v = jnp.asarray(v0) + counts
    jctr = jnp.asarray(ctr) + (sums - counts[:, None] * jnp.asarray(ctr)) / jnp.maximum(v, 1.0)[
        :, None
    ]
    tctr, tv = tpk.minibatch_step(
        torch.from_numpy(padded), torch.from_numpy(ctr), torch.from_numpy(v0),
        torch.from_numpy(idx), batch, k_real=6,
    )
    np.testing.assert_allclose(tctr.numpy(), np.asarray(jctr), **SUMS_TOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))


def test_minibatch_lloyd_counts_come_from_the_full_pass():
    pts, init = blobs(120, 3, 2, seed=5)
    g = torch.Generator().manual_seed(3)
    centers, counts, cost = tpk.minibatch_lloyd(pts, init + 1.0, 15, 64, g)
    assert counts.sum() == len(pts)
    np.testing.assert_allclose(cost, tkm.sum_squared_error(pts, centers), rtol=COST_RTOL)


# -- train_kmeans ------------------------------------------------------------------


def trainer_blobs():
    """tests/ops/test_trainers.py's three blobs (global-optimum SSE ~180)."""
    gen = np.random.default_rng(5)
    centers = np.array([[0.0, 0.0], [8.0, 8.0], [-8.0, 8.0]], np.float32)
    return np.concatenate(
        [c + gen.normal(0.0, 0.5, size=(120, 2)) for c in centers]
    ).astype(np.float32)


GOOD_SSE = 400.0  # tests/ops/test_trainers.py:_GOOD_SSE


@pytest.mark.parametrize(
    "kwargs", [dict(init="random"), dict(init="k-means||", init_backend="host")],
    ids=["random", "host-kmeans||"],
)
def test_train_kmeans_matches_jax_from_the_same_seed(kwargs):
    pts, _ = blobs(150, 4, 5, seed=8)
    # iterations = 0 returns the initial centers untouched: both packages
    # draw them from the same numpy stream
    j0 = jkm.train_kmeans(pts, 4, iterations=0, seed=17, **kwargs)
    t0 = tkm.train_kmeans(pts, 4, iterations=0, seed=17, **kwargs)
    np.testing.assert_array_equal(t0[0], np.asarray(j0[0]))
    jc, jn, jcost = jkm.train_kmeans(pts, 4, iterations=6, seed=17, **kwargs)
    tc, tn, tcost = tkm.train_kmeans(pts, 4, iterations=6, seed=17, **kwargs)
    np.testing.assert_allclose(tc, np.asarray(jc), **SUMS_TOL)
    np.testing.assert_array_equal(tn, np.asarray(jn))
    np.testing.assert_allclose(tcost, jcost, rtol=COST_RTOL)
    assert set(tkm.last_phase_seconds) == {"init", "iterate"}


def test_train_kmeans_minibatch_draws_like_jax():
    """Mini-batch samples come from a torch.Generator, not JAX's stream:
    the contract is the quality bar (test_trainers.py:102-108)."""
    pts = trainer_blobs()
    _, counts, cost = tkm.train_kmeans(pts, 3, iterations=15, seed=11, minibatch_size=64)
    assert int(counts.sum()) == len(pts)
    assert cost < GOOD_SSE


@pytest.mark.parametrize("backend", ["device", "host", "auto"])
def test_device_init_reaches_host_quality(backend):
    pts = trainer_blobs()
    centers, counts, cost = tkm.train_kmeans(pts, 3, iterations=5, seed=11, init_backend=backend)
    assert centers.shape == (3, 2)
    assert int(counts.sum()) == len(pts)
    assert cost < GOOD_SSE, backend


def test_device_init_picks_valid_distinct_rows():
    pts = trainer_blobs()
    padded = torch.from_numpy(tpk.pad_to_block(pts))
    g = torch.Generator().manual_seed(2)
    c = tkm._kmeans_parallel_init_device(padded, len(pts), 3, 2, g).numpy()
    assert c.shape == (3, 2)
    # every center is a real point (never a zero padding row), all distinct
    for row in c:
        assert np.min(np.abs(pts - row).sum(axis=1)) == 0.0
    assert len({tuple(r) for r in c}) == 3


def test_warm_start_and_mesh():
    pts = trainer_blobs()
    warm = np.array([[0.0, 0.0], [8.0, 8.0], [-8.0, 8.0]], np.float32)
    c, _, _ = tkm.train_kmeans(pts, 3, iterations=0, initial_centers=warm)
    np.testing.assert_array_equal(c, warm)
    with pytest.raises(NotYetPortedError):
        tkm.train_kmeans(pts, 3, mesh=object())


def test_centers_from_jax_gives_port_tensors():
    pts = trainer_blobs()
    jc, jn, _ = jkm.train_kmeans(pts, 3, iterations=3, seed=1, init="random")
    c, n = tkm.centers_from_jax(np.asarray(jc), np.asarray(jn))
    assert c.dtype == torch.float32 and n.dtype == torch.float32 and c.device.type == "cpu"
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


# -- metrics and PMML -------------------------------------------------------------


@pytest.mark.parametrize(
    "name", ["sum_squared_error", "davies_bouldin_index", "dunn_index", "silhouette_coefficient"]
)
def test_metrics_equal_jax(name):
    pts, centers = blobs(90, 4, 3, seed=2)
    centers = centers + 0.3
    j = getattr(jkm, name)(pts, centers)
    t = getattr(tkm, name)(pts, centers)
    assert t == j


def test_silhouette_sample_draws_like_jax():
    pts, centers = blobs(60, 3, 2, seed=6)
    j = jkm.silhouette_coefficient(pts, centers, max_sample=50, gen=np.random.default_rng(1))
    t = tkm.silhouette_coefficient(pts, centers, max_sample=50, gen=np.random.default_rng(1))
    assert t == j


def _schema_config(cfg_mod):
    return cfg_mod.get_default().with_overlay(
        """
        oryx.input-schema {
          feature-names = ["a", "b", "id", "c"]
          numeric-features = ["a", "b", "c"]
          ignored-features = ["id"]
        }
        """
    )


def _strip_header(xml: str) -> str:
    return re.sub(r"<(\w+:)?Header.*?</(\w+:)?Header>|<(\w+:)?Header[^>]*/>", "", xml, flags=re.S)


def test_clusters_to_pmml_identical_to_jax_without_header():
    gen = np.random.default_rng(3)
    centers = gen.standard_normal((4, 3))
    counts = [10, 0, 7, 123]
    out = {}
    for name, common, schema_cls, cfg_mod, pmml_mod in (
        ("jax", jcommon, JaxInputSchema, jconfig, jpmml),
        ("torch", tcommon, TorchInputSchema, tconfig, tpmml),
    ):
        schema = schema_cls(_schema_config(cfg_mod))
        clusters = [common.ClusterInfo(i, centers[i], counts[i]) for i in range(4)]
        out[name] = pmml_mod.to_string(common.clusters_to_pmml(clusters, schema))
    assert "Header" in out["torch"]
    assert _strip_header(out["torch"]) == _strip_header(out["jax"])
    # each package reads the other's document to the same clusters
    back = tcommon.pmml_to_clusters(tpmml.from_string(out["jax"]))
    assert [(c.id, c.count) for c in back] == list(enumerate(counts))
    np.testing.assert_array_equal(np.stack([c.center for c in back]), centers)


def test_kmeans_parallel_init_misses_a_blob_alike_in_both_packages():
    """k-means|| (2 rounds of 2k) then weighted k-means++ on chip_smoke's
    blob shape (20 features, k = 10, centers at 6 N(0, 1), unit noise):
    the candidates cover every blob, but the D^2 sampling over them picks
    a second candidate of a covered blob before the last uncovered one in
    a fair share of seeds, in both packages alike (the same numpy draws:
    exact). Lloyd cannot move a center across a blob gap, so such a run
    ends in a local minimum; ``oryx.kmeans.runs`` restarts are the
    remedy, and at reference.conf's 3 a generation still misses a blob
    now and then."""
    gen = np.random.default_rng(1309)
    true = 6.0 * gen.standard_normal((10, 20))
    pts = (true[gen.integers(0, 10, 40_000)]
           + gen.standard_normal((40_000, 20))).astype(np.float32)

    def covered(centers):
        return len(set(np.argmin(((centers[:, None, :] - true[None]) ** 2).sum(-1), axis=1)))

    misses = {}
    for name, mod in (("jax", jkm), ("torch", tkm)):
        misses[name] = [s for s in range(40)
                        if covered(mod._kmeans_parallel_init(pts, 10, np.random.default_rng(s))) < 10]
    assert misses["torch"] == misses["jax"]
    assert 4 <= len(misses["torch"]) <= 24, misses
