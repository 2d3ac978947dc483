"""ALS LSH pruning (``sample-rate < 1``) on the port against the JAX
package, on the CPU.

- The seven cases of tests/app/als/test_lsh.py run on both packages.
- For one seed, at fixed core counts, the hash vectors, the partitions of
  an item matrix and each query's ``candidate_indices`` are equal bit for
  bit.
- ``ALSServingModel.top_n`` at sample-rate 0.3 answers the same ids on
  both packages, plain, with ``exclude``, with a rescorer and with cosine.
"""

import numpy as np
import pytest

from oryx_tpu.app.als import lsh as jlsh
from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu.common import rng as jrng
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.als import lsh as tlsh
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.common import rng as trng

PACKAGES = {"jax": (jlsh, jsm, jrng), "torch": (tlsh, tsm, trng)}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    trng.use_test_seed()
    yield
    trng.clear_test_seed()
    port_device.set_device(None)


def seeded(pkg):
    """Both packages' generators restart at the test seed."""
    PACKAGES[pkg][2].use_test_seed()
    return PACKAGES[pkg]


# -- tests/app/als/test_lsh.py, both packages ----------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize(
    "sample_rate,num_cores,expected_hashes,expected_bits",
    [
        (1.0, 1, 0, 0),
        (0.5, 1, 1, 0),
        (0.1, 1, 4, 0),
        (1.0, 2, 1, 1),
        (0.75, 3, 2, 1),
        (0.5, 3, 3, 1),
        (0.1, 8, 7, 1),
        (0.01, 8, 11, 1),
        (0.001, 8, 14, 1),
        (0.0001, 8, 16, 1),
        (0.00001, 8, 16, 1),
    ],
)
def test_hashes_and_bits(pkg, sample_rate, num_cores, expected_hashes, expected_bits):
    lsh = PACKAGES[pkg][0]
    assert lsh.MAX_HASHES == 16
    assert lsh.choose_hashes_and_bits(sample_rate, num_cores) == (expected_hashes, expected_bits)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_candidate_indices_no_sample(pkg):
    h = PACKAGES[pkg][0].LocalitySensitiveHash(1.0, 10, 8)
    cands = h.candidate_indices(np.zeros(10, dtype=np.float32))
    assert list(cands) == list(range(h.num_partitions))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_candidate_indices_one_bit(pkg):
    h = PACKAGES[pkg][0].LocalitySensitiveHash(0.1, 10, 8)
    assert h.max_bits_differing == 1
    zero_cands = h.candidate_indices(np.zeros(10, dtype=np.float32))
    assert len(zero_cands) == 1 + h.num_hashes
    assert zero_cands[0] == 0
    for i in range(1, len(zero_cands)):
        assert zero_cands[i] == 1 << (i - 1)
    one_cands = h.candidate_indices(np.ones(10, dtype=np.float32))
    for i in range(1, len(one_cands)):
        assert one_cands[i] == one_cands[0] ^ (1 << (i - 1))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_candidate_indices_three_bits(pkg):
    h = PACKAGES[pkg][0].LocalitySensitiveHash(0.5, 10, 32)
    assert (h.num_hashes, h.max_bits_differing) == (7, 3)
    cands = h.candidate_indices(np.ones(10, dtype=np.float32))
    assert len(cands) == 64 and len({int(c) for c in cands}) == 64
    main = int(cands[0])
    assert all(bin(int(c) ^ main).count("1") <= 3 for c in cands)
    assert all(bin(int(c) ^ main).count("1") == 1 for c in cands[1:8])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_hash_distribution_and_index_consistency(pkg):
    gen = np.random.default_rng(42)
    for features, sample_rate, cores in [(40, 0.1, 8), (10, 0.1, 1), (200, 0.1, 16)]:
        h = PACKAGES[pkg][0].LocalitySensitiveHash(sample_rate, features, cores)
        mat = gen.standard_normal((2000, features)).astype(np.float32)
        parts = h.partitions_for(mat)
        assert parts.min() >= 0 and parts.max() < h.num_partitions
        for row in range(0, 2000, 371):
            assert h.index_for(mat[row]) == parts[row]
        if h.num_hashes >= 4:
            counts = np.bincount(parts, minlength=h.num_partitions)
            assert counts.max() <= 20 * (2000 / h.num_partitions)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_hash_vectors_roughly_orthogonal(pkg):
    hv = PACKAGES[pkg][0].LocalitySensitiveHash(0.1, 32, 8).hash_vectors
    n = np.linalg.norm(hv, axis=1)
    cos = np.abs(hv @ hv.T) / np.outer(n, n)
    assert cos[~np.eye(len(hv), dtype=bool)].max() < 0.5


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_serving_model_lsh_top_n_finds_aligned_items(pkg):
    gen = np.random.default_rng(7)
    features = 16
    q = gen.standard_normal(features).astype(np.float32)
    model = PACKAGES[pkg][1].ALSServingModel(features, implicit=True, sample_rate=0.3)
    assert model.lsh is not None
    for i in range(500):
        model.set_item_vector(f"noise{i}", gen.standard_normal(features).astype(np.float32) * 0.2)
    for i in range(10):
        v = (2.0 * q + 0.05 * gen.standard_normal(features)).astype(np.float32)
        model.set_item_vector(f"best{i}", v)
    got = model.top_n(q, 10)
    assert {id_ for id_, _ in got} == {f"best{i}" for i in range(10)}
    rows = np.flatnonzero(np.isin(model._y_partitions, model.lsh.candidate_indices(q)))
    assert 0 < len(rows) < 510
    model.close()


# -- bit for bit across the packages ------------------------------------------------


@pytest.mark.parametrize("features,sample_rate,cores", [
    (10, 0.3, 1), (50, 0.3, 8), (250, 0.3, 8), (32, 0.05, 32), (16, 0.5, 3),
])
def test_hash_vectors_partitions_and_candidates_equal(features, sample_rate, cores):
    out = {}
    for pkg in PACKAGES:
        h = seeded(pkg)[0].LocalitySensitiveHash(sample_rate, features, cores)
        gen = np.random.default_rng(5)
        mat = gen.standard_normal((3000, features)).astype(np.float32)
        queries = gen.standard_normal((20, features)).astype(np.float32)
        out[pkg] = (h.num_hashes, h.max_bits_differing, h.hash_vectors, h.partitions_for(mat),
                    [h.candidate_indices(q) for q in queries])
    got, want = out["torch"], out["jax"]
    assert got[:2] == want[:2]
    assert got[2].dtype == want[2].dtype and got[2].tobytes() == want[2].tobytes()
    assert np.array_equal(got[3], want[3])
    assert all(np.array_equal(a, b) for a, b in zip(got[4], want[4]))


class _Rescorer:
    """Drops items whose number is a multiple of 7 and halves odd ones."""

    def is_filtered(self, id_):
        return int(id_[1:]) % 7 == 0

    def rescore(self, id_, score):
        return score * 0.5 if int(id_[1:]) % 2 else score


def lsh_answers(pkg, features=24, items=4000, users=25):
    _, sm, _ = seeded(pkg)
    gen = np.random.default_rng(11)
    y = gen.standard_normal((items, features)).astype(np.float32)
    x = gen.standard_normal((users, features)).astype(np.float32)
    m = sm.ALSServingModel(features, True, refresh_sec=0.0, sample_rate=0.3)
    m.set_item_vectors([f"i{j}" for j in range(items)], y)
    m.set_user_vectors([f"u{j}" for j in range(users)], x)
    out = {}
    for u in range(users):
        q = x[u]
        exclude = {f"i{j}" for j in range(0, items, 3)}
        out[u] = {
            "plain": m.top_n(q, 10),
            "user": m.top_n_for_user(f"u{u}", 10),
            "exclude": m.top_n(q, 10, exclude=exclude),
            "rescorer": m.top_n(q, 10, rescorer=_Rescorer()),
            "cosine": m.top_n(q, 10, cosine=True),
        }
    assert not m._x_staging  # LSH serves the vector path
    m.close()
    return out


def test_top_n_at_sample_rate_0_3_matches_jax():
    got, want = lsh_answers("torch"), lsh_answers("jax")
    for u in got:
        for case in got[u]:
            g, w = got[u][case], want[u][case]
            assert [i for i, _ in g] == [i for i, _ in w], (u, case)
            np.testing.assert_allclose([v for _, v in g], [v for _, v in w], rtol=1e-6)
            assert len(g) == 10
