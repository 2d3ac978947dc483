"""The port's native feature store and update formatters
(``oryx_tpu_torch/native/store.py`` over ``feature_store.cpp``) against
the JAX package's (``oryx_tpu/native/store.py``), on the CPU.

Every case of tests/native/test_feature_store.py and test_store.py runs
on both packages' stores with the same seeded inputs: the port's store
answers as the JAX package's does (vectors, ids and their order, masks,
VtV), and the JAX case's own checks hold on the port's side. The
formatters give the JAX package's bytes: non-finite values, ids with
quotes, backslashes, control characters and non-ASCII text, rows past
``_MULTI_BUFFER_BUDGET`` (patched down, not grown), and the pure-Python
paths where the library is declined. ``parse_float_csv`` gives the same
array or the same None.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from oryx_tpu.app.als.common import FeatureVectors as JaxFeatureVectors
from oryx_tpu.native import get_library as jax_library
from oryx_tpu.native import store as jstore
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.als.common import FeatureVectors
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.native import get_library
from oryx_tpu_torch.native import store

_HAVE_NATIVE = get_library() is not None and jax_library() is not None
needs_native = pytest.mark.skipif(not _HAVE_NATIVE, reason="native library unavailable")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


@pytest.fixture(params=["python", "native"])
def stores(request):
    """(the port's store, the JAX package's store) of one kind."""
    if request.param == "python":
        return FeatureVectors(), JaxFeatureVectors()
    if not _HAVE_NATIVE:
        pytest.skip("native library unavailable")
    return store.NativeFeatureVectors(), jstore.NativeFeatureVectors()


def assert_same_store(port, jax):
    """Same size, ids in the same order, the same vectors and VtV."""
    assert port.size() == jax.size()
    assert port.ids() == jax.ids()
    p_ids, p_mat = port.to_matrix()
    j_ids, j_mat = jax.to_matrix()
    assert p_ids == j_ids
    np.testing.assert_array_equal(p_mat, j_mat)
    pv, jv = port.get_vtv(), jax.get_vtv()
    assert (pv is None) == (jv is None)
    if pv is not None:
        np.testing.assert_array_equal(pv, jv)


# -- tests/native/test_feature_store.py, both kinds ------------------------------


def test_set_get_remove_size(stores):
    for s in stores:
        assert s.size() == 0
        assert s.get_vector("a") is None
        s.set_vector("a", np.array([1.0, 0.5, -2.0], np.float32))
        s.set_vector("b", np.array([0.0, 1.0, 3.0], np.float32))
        assert s.size() == 2
        np.testing.assert_array_equal(s.get_vector("a"), [1.0, 0.5, -2.0])
        s.set_vector("a", np.array([9.0, 9.0, 9.0], np.float32))  # overwrite
        assert s.size() == 2
        np.testing.assert_array_equal(s.get_vector("a"), [9.0, 9.0, 9.0])
        s.remove_vector("a")
        assert s.size() == 1
        assert s.get_vector("a") is None
        s.remove_vector("never-there")  # no-op
        assert s.size() == 1
    assert_same_store(*stores)


def test_to_matrix_and_ids_consistent(stores):
    vecs = {f"id{i}": np.arange(4, dtype=np.float32) + i for i in range(37)}
    for s in stores:
        for k, v in vecs.items():
            s.set_vector(k, v)
        ids, mat = s.to_matrix()
        assert sorted(ids) == sorted(vecs)
        assert mat.shape == (37, 4)
        for row, id_ in enumerate(ids):
            np.testing.assert_array_equal(mat[row], vecs[id_])
        got = dict(s.items())
        assert set(got) == set(vecs)
        np.testing.assert_array_equal(got["id3"], vecs["id3"])
    assert_same_store(*stores)
    assert [i for i, _ in stores[0].items()] == [i for i, _ in stores[1].items()]


def test_vtv(stores):
    mats = np.random.default_rng(5).standard_normal((50, 6)).astype(np.float32)
    for s in stores:
        for i, v in enumerate(mats):
            s.set_vector(f"v{i}", v)
        expect = mats.astype(np.float64).T @ mats.astype(np.float64)
        np.testing.assert_allclose(s.get_vtv(), expect, rtol=1e-5)
    assert_same_store(*stores)


def test_vtv_empty(stores):
    assert [s.get_vtv() for s in stores] == [None, None]


def test_retain_recent_and_ids(stores):
    """Rotation semantics (FeatureVectors.retainRecentAndIDs:131-136):
    survivors = new-model ids + written-since-last-rotation, recency resets."""
    for s in stores:
        s.set_vector("old1", np.ones(2, np.float32))
        s.set_vector("old2", np.ones(2, np.float32))
        s.retain_recent_and_ids({"old1", "old2"})  # resets recency
        s.set_vector("fresh", np.ones(2, np.float32))
        recent: set = set()
        s.add_all_recent_to(recent)
        assert recent == {"fresh"}
        s.retain_recent_and_ids({"old1"})
        assert sorted(s.ids()) == ["fresh", "old1"]
    assert_same_store(*stores)
    for s in stores:
        # recency has reset again: nothing recent survives an immediate rotation
        s.retain_recent_and_ids(set())
        assert s.ids() == []
    assert_same_store(*stores)


def test_add_all_ids_to(stores):
    outs = []
    for s in stores:
        s.set_vector("x", np.zeros(3, np.float32))
        s.set_vector("y", np.zeros(3, np.float32))
        out: set = set()
        s.add_all_ids_to(out)
        outs.append(out)
    assert outs == [{"x", "y"}, {"x", "y"}]


@needs_native
def test_native_dim_mismatch_raises():
    for cls in (store.NativeFeatureVectors, jstore.NativeFeatureVectors):
        fv = cls()
        fv.set_vector("a", np.zeros(3, np.float32))
        with pytest.raises(ValueError):
            fv.set_vector("b", np.zeros(4, np.float32))


@needs_native
@pytest.mark.parametrize("hostile", [
    ["ключ-λ"],
    ["a\nb", "c\x00d", "plain", "x" * 500, ""],
], ids=["unicode", "hostile"])
def test_native_unicode_and_hostile_ids(hostile):
    """Ids are arbitrary wire strings: non-ASCII text, newlines, NULs and
    long ids round-trip through pack, ids and retain on both stores."""
    pair = (store.NativeFeatureVectors(), jstore.NativeFeatureVectors())
    for fv in pair:
        for i, id_ in enumerate(hostile):
            fv.set_vector(id_, np.full(3, float(i), np.float32))
        assert sorted(fv.ids()) == sorted(hostile)
        ids, mat = fv.to_matrix()
        assert len(ids) == mat.shape[0] == len(hostile)
        for row, id_ in enumerate(ids):
            assert mat[row][0] == float(hostile.index(id_))
    assert_same_store(*pair)
    for fv in pair:
        fv.retain_recent_and_ids(set())  # everything recent -> all survive
        fv.retain_recent_and_ids(set(hostile[:2]))
        assert sorted(fv.ids()) == sorted(hostile[:2])
    assert_same_store(*pair)


@needs_native
def test_native_concurrent_read_write():
    """Hammer the port's store from writer + reader + packer threads; every
    read returns None or a complete, self-consistent vector."""
    fv = store.NativeFeatureVectors(num_shards=8)
    dim = 8
    stop = threading.Event()
    errors: list[str] = []

    def writer(tid: int):
        i = 0
        while not stop.is_set():
            fv.set_vector(f"k{tid}-{i % 200}", np.full(dim, float(i), np.float32))
            i += 1

    def reader():
        while not stop.is_set():
            v = fv.get_vector("k0-7")
            if v is not None and len(set(v.tolist())) != 1:
                errors.append(f"torn read: {v}")

    def packer():
        while not stop.is_set():
            ids, mat = fv.to_matrix()
            if len(ids) != mat.shape[0]:
                errors.append(f"inconsistent pack: {len(ids)} vs {mat.shape}")
            fv.get_vtv()

    threads = (
        [threading.Thread(target=writer, args=(t,)) for t in range(2)]
        + [threading.Thread(target=reader) for _ in range(2)]
        + [threading.Thread(target=packer)]
    )
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert not errors, errors[:3]
    assert fv.size() <= 400


def test_make_feature_vectors_fallback(monkeypatch):
    monkeypatch.setenv("ORYX_NATIVE", "0")
    assert isinstance(store.make_feature_vectors(), FeatureVectors)
    assert isinstance(jstore.make_feature_vectors(), JaxFeatureVectors)


def test_make_feature_vectors_takes_the_native_store():
    kind = "NativeFeatureVectors" if _HAVE_NATIVE else "FeatureVectors"
    assert type(store.make_feature_vectors()).__name__ == kind
    assert type(jstore.make_feature_vectors()).__name__ == kind


def test_get_batch_hits_and_misses(stores):
    outs = []
    for fv in stores:
        assert fv.get_batch(["a"], dim=2)[0].shape == (1, 2)  # empty store, shaped
        fv.set_vector("a", np.asarray([1.0, 2.0], np.float32))
        fv.set_vector("b", np.asarray([3.0, 4.0], np.float32))
        mat, valid = fv.get_batch(["a", "missing", "b", "a"])
        assert valid.tolist() == [True, False, True, True]
        np.testing.assert_array_equal(mat, [[1.0, 2.0], [0.0, 0.0], [3.0, 4.0], [1.0, 2.0]])
        outs.append((mat, valid))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_set_batch_matches_per_record(stores):
    gen = np.random.default_rng(5)
    ids = [f"id{j}" for j in range(500)] + ["id3", "id7"]  # dup ids: later wins
    mat = gen.standard_normal((len(ids), 8)).astype(np.float32)
    port, jax = stores
    single = type(port)()
    for i, v in zip(ids, mat):
        single.set_vector(i, v)
    for s in stores:
        s.set_batch(ids, mat)
        assert s.size() == single.size() == 500
        for j in (0, 3, 7, 499):
            np.testing.assert_array_equal(single.get_vector(f"id{j}"), s.get_vector(f"id{j}"))
    assert_same_store(port, jax)
    for s in stores:
        # recency marked: rotation to an empty keep-set retains all batch ids
        s.retain_recent_and_ids(set())
        assert s.size() == 500
    assert_same_store(port, jax)


# -- the formatters, byte for byte -----------------------------------------------

HOSTILE_IDS = ["U1", 'we"ird\\id', "usér-Ω", "tab\tnl\nctl\x01", "ключ", "", "x" * 300]


def _matrix(seed: int, n: int, k: int, non_finite: bool = True) -> np.ndarray:
    gen = np.random.default_rng(seed)
    mat = np.concatenate([
        gen.standard_normal((n, k)),
        gen.standard_normal((n, k)) * 1e6,
        gen.standard_normal((n, k)) * 1e-6,
    ]).astype(np.float32)
    mat[0, :7] = [0.0, -0.0, 1.0, -1.0, 0.1, 1e-38, 3.1e38][:k] if k >= 7 else mat[0, :7]
    if non_finite:
        mat[1, 0], mat[2, 1 % k], mat[3, 2 % k] = np.nan, np.inf, -np.inf
    return mat


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_format_vectors_json_is_the_jax_packages(native, monkeypatch):
    if native and not _HAVE_NATIVE:
        pytest.skip("native library unavailable")
    if not native:
        monkeypatch.setattr(store, "get_library", lambda: None)
        monkeypatch.setattr(jstore, "get_library", lambda: None)
    mat = _matrix(3, 50, 7)
    out = store.format_vectors_json(mat)
    assert out == jstore.format_vectors_json(mat)
    want = np.nan_to_num(mat, nan=0.0, posinf=0.0, neginf=0.0)
    for row, s in zip(want, out):
        np.testing.assert_array_equal(np.asarray(json.loads(s), np.float32), row)
    assert store.format_vectors_json(mat[:0]) == jstore.format_vectors_json(mat[:0]) == []


@needs_native
@pytest.mark.parametrize("include_known", [True, False])
@pytest.mark.parametrize("threads", [None, 7])
def test_format_update_messages_is_the_jax_packages(include_known, threads):
    n = 1000
    mat = _matrix(9, n // 3 + 1, 5)[:n]
    n = len(mat)
    ids = [HOSTILE_IDS[j % len(HOSTILE_IDS)] + str(j) for j in range(n)]
    others = [f"I{j}" if j % 3 else HOSTILE_IDS[j % len(HOSTILE_IDS)] for j in range(n)]
    got = store.format_update_messages(mat, ids, others, "X", include_known, num_threads=threads)
    assert got == jstore.format_update_messages(mat, ids, others, "X", include_known,
                                                num_threads=threads)
    assert len(got) == n
    want = np.nan_to_num(mat, nan=0.0, posinf=0.0, neginf=0.0)
    for j in (0, 1, 2, 3, 142, 143, n - 1):  # across thread-chunk boundaries
        parsed = json.loads(got[j])
        assert parsed[:2] == ["X", ids[j]]
        assert parsed[3:] == ([[others[j]]] if include_known else [])
        np.testing.assert_array_equal(np.asarray(parsed[2], np.float32), want[j])
    # a malformed pairing declines on both sides; empty input is empty
    assert store.format_update_messages(mat, ids[:-1], others, "Y") is None
    assert jstore.format_update_messages(mat, ids[:-1], others, "Y") is None
    assert store.format_update_messages(mat[:0], [], [], "Y") == []


@needs_native
@pytest.mark.parametrize("budget", [None, 4096], ids=["whole", "sliced"])
def test_format_update_messages_multi_is_the_jax_packages(budget, monkeypatch):
    """Per-row known lists, hostile ids in both places; with the buffer
    budget patched down both packages slice rows into bounded calls and
    still give the unsliced bytes."""
    gen = np.random.default_rng(11)
    n, k = 200, 4
    mat = gen.standard_normal((n, k)).astype(np.float32)
    mat[5, 1], mat[6, 2] = np.nan, -np.inf
    ids = [HOSTILE_IDS[j % len(HOSTILE_IDS)] + f"U{j}" for j in range(n)]
    knowns = [[f"I{j}-{m}" for m in range(j % 30)] + HOSTILE_IDS[: j % 4] for j in range(n)]
    whole = store.format_update_messages_multi(mat, ids, knowns, "X", num_threads=7)
    if budget is not None:
        monkeypatch.setattr(store, "_MULTI_BUFFER_BUDGET", budget)
        monkeypatch.setattr(jstore, "_MULTI_BUFFER_BUDGET", budget)
    got = store.format_update_messages_multi(mat, ids, knowns, "X", num_threads=7)
    assert got == jstore.format_update_messages_multi(mat, ids, knowns, "X", num_threads=7)
    assert got == whole
    want = np.nan_to_num(mat, nan=0.0, posinf=0.0, neginf=0.0)
    for j in (0, 1, 5, 6, 142, 143, 199):
        parsed = json.loads(got[j])
        assert parsed[:2] == ["X", ids[j]] and parsed[3] == knowns[j]
        np.testing.assert_array_equal(np.asarray(parsed[2], np.float32), want[j])
    assert store.format_update_messages_multi(mat, ids, knowns[:-1], "Y") is None


def test_formatters_decline_without_the_library(monkeypatch):
    monkeypatch.setattr(store, "get_library", lambda: None)
    mat = np.ones((2, 2), np.float32)
    assert store.format_update_messages(mat, ["a", "b"], ["c", "d"], "X") is None
    assert store.format_update_messages_multi(mat, ["a", "b"], [[], []], "X") is None
    assert store.parse_float_csv(b"1,2", 2) is None


@needs_native
@pytest.mark.parametrize("payload,expected", [
    (b"1,2.5,-3e-2,4", 4),
    (b"1,2.5,-3e-2,4", 3),
    (b"1,2.5", 3),
    (b"1,abc,3", 3),
    (b"", 0),
    (b"0.1,3.4028235e38,-1e-45,1e400", 4),
    (b" 1, 2", 2),
    (b"1,,2", 3),
    (b"nan,inf", 2),
], ids=lambda v: repr(v)[:20])
def test_parse_float_csv_is_the_jax_packages(payload, expected):
    got, want = store.parse_float_csv(payload, expected), jstore.parse_float_csv(payload, expected)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@needs_native
def test_parse_float_csv_reads_the_formatters_text():
    mat = _matrix(4, 40, 9, non_finite=False)
    payload = ",".join(s[1:-1] for s in store.format_vectors_json(mat)).encode()
    got = store.parse_float_csv(payload, mat.size)
    np.testing.assert_array_equal(got.reshape(mat.shape), mat)
    np.testing.assert_array_equal(got, jstore.parse_float_csv(payload, mat.size))
