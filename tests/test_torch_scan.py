"""The port's streaming scan (oryx_tpu_torch.ops.streaming_topn) against
the JAX package's Pallas scan (oryx_tpu.ops.pallas_topn), on the CPU.

The same seeded numpy inputs go through both. The JAX side runs the
Pallas kernels in interpret mode, as its own tests do; the port runs the
plain PyTorch versions of its CUDA kernels, which are what a CPU tensor
takes. Tolerances: float32 and int8 ids equal and values within 1e-4
(as tests/ops/test_pallas_topn.py); bfloat16 the reference's "ranks
close" bar (the two sides round bf16 products alike but sum in another
order).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from oryx_tpu.ops import pallas_topn as ptn
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.ops import streaming_topn as stn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


def _make(n=5003, kf=24, b=8, seed=0):
    gen = np.random.default_rng(seed)
    y = gen.standard_normal((n, kf), dtype=np.float32)
    q = gen.standard_normal((b, kf), dtype=np.float32)
    return y, q


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


# -- handle and quantizers ----------------------------------------------------


def test_quantizers_bit_exact():
    y, _ = _make(n=700, kf=19, seed=1)
    y[5] = 0.0  # all-zero row: scale 1.0, codes 0
    y[9] *= 1e4  # hot row keeps its own scale
    q, s = stn._quantize_rows(y)
    jq, js = ptn._quantize_rows(y)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    q2, s2 = stn._quantize_residual(y, q, s)
    jq2, js2 = ptn._quantize_residual(y, jq, js)
    np.testing.assert_array_equal(q2, jq2)
    np.testing.assert_array_equal(s2, js2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_upload_and_handle_from_numpy_bit_exact(dtype):
    jdt, tdt = DTYPES[dtype]
    y, _ = _make(n=20000, kf=19, seed=2)  # n past one BLOCK_N, kf off the int8 multiple
    ref = ptn.upload_streaming(y, dtype=jdt)
    port = stn.upload_streaming(y, dtype=tdt)
    carried = stn.handle_from_numpy(
        np.asarray(ref.mat_t), np.asarray(ref.norms), ref.n_items,
        scales=None if ref.scales is None else np.asarray(ref.scales),
        resid=None if ref.resid is None else np.asarray(ref.resid),
        resid_scales=None if ref.resid_scales is None else np.asarray(ref.resid_scales),
        features=ref.features,
    )
    for h in (port, carried):
        assert h.mat_t.dtype == tdt
        assert tuple(h.mat_t.shape) == ref.mat_t.shape  # same capacity
        assert h.n_items == ref.n_items and h.features == ref.features
        np.testing.assert_array_equal(h.mat_t.float().numpy(), _f32(ref.mat_t))
        np.testing.assert_array_equal(h.norms.numpy(), np.asarray(ref.norms))
        for a, b in ((h.scales, ref.scales), (h.resid, ref.resid),
                     (h.resid_scales, ref.resid_scales)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- the scan: plain B1/B2 versions against the Pallas kernels ---------------

# (dtype, cosine, b, k): every dtype, both scorings, b in {1, 8, 300}
# (300 takes the candidates kernel on both sides) and k in {1, 10, 100,
# 130} (130 is past MAX_KERNEL_K: the materialized scan)
SCAN_CASES = [
    ("float32", False, 8, 10),
    ("float32", True, 1, 10),
    ("float32", False, 300, 10),
    ("float32", True, 8, 100),
    ("float32", False, 8, 1),
    ("float32", False, 8, 130),
    ("bfloat16", False, 8, 10),
    ("bfloat16", True, 300, 10),
    ("bfloat16", False, 1, 130),
    ("int8", False, 8, 10),
    ("int8", True, 1, 10),
    ("int8", False, 300, 1),
    ("int8", True, 8, 130),
]


@pytest.mark.parametrize("dtype,cosine,b,k", SCAN_CASES)
def test_scan_matches_pallas(dtype, cosine, b, k):
    jdt, tdt = DTYPES[dtype]
    y, q = _make(b=b, seed=SCAN_CASES.index((dtype, cosine, b, k)))
    ridx, rvals = ptn.top_k_streaming(ptn.upload_streaming(y, dtype=jdt), q, k,
                                      cosine=cosine, interpret=True)
    idx, vals = stn.top_k_streaming(stn.upload_streaming(y, dtype=tdt), q, k, cosine=cosine)
    assert idx.shape == (b, k) and vals.dtype == np.float32
    if dtype == "bfloat16":
        # bf16 scoring may swap near-ties but the candidate sets agree
        for got, ref in zip(idx, ridx):
            assert len(set(got.tolist()) & set(ref.tolist())) >= int(0.8 * k)
        np.testing.assert_allclose(vals, rvals, rtol=1e-2, atol=1e-2)
        return
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(vals, rvals, atol=1e-4)


@pytest.mark.parametrize("dtype,cosine", [("float32", False), ("float32", True),
                                           ("int8", True)])
def test_planted_exact_ties_go_to_lowest_id(dtype, cosine):
    """Small-integer factors make every score exact in any summation
    order, so both sides see the same exact ties and must break them
    toward the lowest item id."""
    jdt, tdt = DTYPES[dtype]
    gen = np.random.default_rng(4)
    y = gen.integers(-2, 3, size=(3001, 8)).astype(np.float32)
    y[2500:2600] = y[100]  # a run of duplicates of one item
    q = gen.integers(-2, 3, size=(8, 8)).astype(np.float32)
    q[0] = y[100]
    ridx, rvals = ptn.top_k_streaming(ptn.upload_streaming(y, dtype=jdt), q, 10,
                                      cosine=cosine, interpret=True)
    idx, vals = stn.top_k_streaming(stn.upload_streaming(y, dtype=tdt), q, 10, cosine=cosine)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(vals, rvals, atol=1e-4)
    assert len(set(vals[0].tolist())) < 10  # the ties really are there


def test_candidates_then_merge_equals_running_scan():
    """B2 (per-block lists) and B1 (running list) stages agree once
    merged, on a plane of several blocks with a ragged last one."""
    y, q = _make(n=40000, kf=16, b=12, seed=6)
    up = stn.upload_streaming(y)
    qq = torch.from_numpy(q)
    aux = stn._fold_aux(up.norms, None, True)
    cv, ci = stn.topn_candidates(qq, up.mat_t, aux, up.n_items, 20, True, False)
    assert cv.shape == (up.mat_t.shape[1] // stn.CANDIDATE_BLOCK, 12, 20)
    v2, i2 = stn.topn_merge(cv, ci, 20)
    v1, i1 = stn.topn_merge(*stn.topn_scan(qq, up.mat_t, aux, up.n_items, 20, True, False), 20)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    assert int(i1.max()) < 40000  # padding columns never enter


def test_padding_never_wins():
    y, q = _make(n=130, kf=8, b=1, seed=5)
    up = stn.upload_streaming(y)
    assert up.mat_t.shape[1] % stn.BLOCK_N == 0
    idx, _ = stn.top_k_streaming(up, q[0], 130)
    assert set(idx[0].tolist()) == set(range(130))
    neg = -np.abs(y)  # every real score below the zero padding columns
    idx2, _ = stn.top_k_streaming(stn.upload_streaming(neg, dtype=torch.int8), np.abs(q), 20)
    assert idx2.max() < 130


def test_configure_scan_oversample():
    old = stn.RESCORE_OVERSAMPLE
    try:
        stn.configure_scan(oversample=2)
        assert stn.RESCORE_OVERSAMPLE == 2
        assert stn._scan_k(10, 1000, object()) == 32
        assert stn._scan_k(30, 1000, object()) == 60
        assert stn._scan_k(10, 1000, None) == 10
    finally:
        stn.configure_scan(oversample=old)


# -- the tensor-core scan's exact query split and argument rules ---------------


def _split_bf16x3(q: torch.Tensor) -> torch.Tensor:
    """[3, b, kf] bfloat16 pieces (hi, mid, lo) of float32 queries, the
    split the tensor-core scan makes for an int8 plane (``split_query`` in
    csrc/topn.cu): each piece rounds to nearest even what the earlier ones
    left, and each remainder is exact in float32."""
    hi = q.to(torch.bfloat16)
    rest = q - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return torch.stack((hi, mid, lo))


def _assert_exact_split(q: torch.Tensor) -> None:
    pieces = _split_bf16x3(q)
    assert pieces.dtype == torch.bfloat16 and tuple(pieces.shape) == (3, *q.shape)
    hi, mid, lo = (p.float() for p in pieces)
    # exact in f32 in either order of summation: each partial sum fits
    assert torch.equal((hi + mid) + lo, q)
    assert torch.equal(hi + (mid + lo), q)


# finite f32 values of every significand, exponents kept where each
# remainder stays above bfloat16's smallest subnormal (2^-133)
_normal_f32 = st.builds(
    lambda sign, mant, exp: float(np.ldexp(np.float32(sign * mant), exp)),
    st.sampled_from([-1, 1]), st.integers(1 << 23, (1 << 24) - 1), st.integers(-100, 100),
)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(st.just(0.0), _normal_f32), min_size=1, max_size=64))
def test_split_bf16x3_is_exact(values):
    _assert_exact_split(torch.tensor(values, dtype=torch.float32)[None])


@pytest.mark.parametrize("b,kf,seed", [(8, 24, 0), (300, 24, 3), (1, 250, 7)])
def test_split_bf16x3_is_exact_on_seeded_queries(b, kf, seed):
    _, q = _make(kf=kf, b=b, seed=seed)
    _assert_exact_split(torch.from_numpy(q))


# -- a float32 plane's six bf16 passes -------------------------------------------

# (item piece, query piece) of each pass, in csrc/topn.cu's order: the
# three cross terms left out (mid.lo, lo.mid, lo.lo) are about 2^-24 of a
# product
_PASSES = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def _six_pass_product(q: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[b, n] float32 scores of queries q [b, kf] against items y [n, kf]
    as the scan computes a float32 plane's: both split in three bf16
    pieces, the six passes' products (each exact in float32) summed in
    float32."""
    qp, yp = _split_bf16x3(q).float(), _split_bf16x3(y).float()
    out = torch.zeros((q.shape[0], y.shape[0]), dtype=torch.float32)
    for a, b in _PASSES:
        out += qp[b] @ yp[a].T
    return out


def _assert_six_passes_within_rtol(q: np.ndarray, y: np.ndarray) -> None:
    """The six-pass product within rtol 1e-5 of the float64 product of the
    float32 operands, relative to the sum of the terms' magnitudes (a dot
    product may cancel to 0; float32 rounding scales with its terms). The
    dropped cross terms alone, summed in float64, stay below 2^-22 of it."""
    got = _six_pass_product(torch.from_numpy(q), torch.from_numpy(y)).double().numpy()
    q64, y64 = q.astype(np.float64), y.astype(np.float64)
    exact = q64 @ y64.T
    scale = np.abs(q64) @ np.abs(y64).T
    assert np.all(np.abs(got - exact) <= 1e-5 * scale)
    qp = _split_bf16x3(torch.from_numpy(q)).double().numpy()
    yp = _split_bf16x3(torch.from_numpy(y)).double().numpy()
    kept = sum(qp[b] @ yp[a].T for a, b in _PASSES)
    assert np.all(np.abs(kept - exact) <= 2.0**-22 * scale)


@pytest.mark.parametrize("b,n,seed", [(8, 500, 0), (256, 64, 1), (1, 2000, 2)])
def test_six_bf16_passes_match_float64_on_seeded_rows(b, n, seed):
    """Queries N(0, 1) and items N(0, 1/250) at 250 features, the scan's
    main-path shape."""
    gen = np.random.default_rng(seed)
    q = gen.standard_normal((b, 250), dtype=np.float32)
    y = gen.standard_normal((n, 250), dtype=np.float32) / np.float32(np.sqrt(250))
    _assert_six_passes_within_rtol(q, y)


# finite f32 values whose products and split remainders stay normal
_moderate_f32 = st.builds(
    lambda sign, mant, exp: float(np.ldexp(np.float32(sign * mant), exp)),
    st.sampled_from([-1, 1]), st.integers(1 << 23, (1 << 24) - 1), st.integers(-50, 6),
)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.just(0.0), _moderate_f32), min_size=500, max_size=500))
def test_six_bf16_passes_match_float64(values):
    """One 250-feature query row against one item row, any values."""
    v = np.asarray(values, dtype=np.float32)
    _assert_six_passes_within_rtol(v[None, :250], v[None, 250:])


# -- the merge ----------------------------------------------------------------------


def _merge_lists(gen, s: int, b: int, m: int):
    """[S, b, m] lists as the scans leave them: each best first, values on
    a coarse grid (equal values within and across lists), ids of list s
    below list s + 1's and ascending among equal values, a random run of
    (-inf, INT_MAX) padding ending each list; row 0 one value throughout,
    and row 1 padding but for the first half of list 0, so that padding
    reaches the merged list."""
    # + 0.0 leaves no -0.0: lax.top_k orders it below 0.0, which the
    # scans' comparisons and a stable sort take as equal
    v = np.round(gen.standard_normal((s, b, m)) * 2) / 4 + 0.0
    v = -np.sort(-v, axis=2).astype(np.float32)
    v[:, 0] = 0.5
    rank = np.arange(m)
    ids = np.broadcast_to(np.arange(s)[:, None, None] * m + rank, (s, b, m)).astype(np.int32)
    kept = m - gen.integers(0, m + 1, (s, b, 1))
    kept[:, 1] = 0
    kept[0, 1] = m // 2
    pad = rank >= kept
    return np.where(pad, -np.inf, v).astype(np.float32), np.where(pad, 2**31 - 1, ids)


@pytest.mark.parametrize("s,m", [(1, 1), (3, 1), (5, 16), (7, 128), (33, 64)])
def test_merge_plain_matches_jax_lax_top_k(s, m):
    """topn_merge_plain against the JAX package's merge of candidate
    lists (lax.top_k over the flattened lists, pallas_topn.py:597-599)."""
    gen = np.random.default_rng(10 + s * m)
    b = 4
    v, ids = _merge_lists(gen, s, b, m)
    allv = jnp.moveaxis(jnp.asarray(v), 0, 1).reshape(b, s * m)
    alli = jnp.moveaxis(jnp.asarray(ids), 0, 1).reshape(b, s * m)
    jv, pos = jax.lax.top_k(allv, m)
    pv, pi = stn.topn_merge_plain(torch.from_numpy(v), torch.from_numpy(ids), m)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jnp.take_along_axis(alli, pos, axis=1)))
    assert np.isneginf(pv[1].numpy()).sum() == m - m // 2  # padding reached row 1


@pytest.mark.parametrize("kernel", ["topn_scan", "topn_candidates"])
@pytest.mark.parametrize("cosine", [False, True])
def test_bf16_plane_wrappers_score_rounded_queries(kernel, cosine):
    """A bfloat16 plane scores the queries rounded to bfloat16, norm
    included, as the tensor-core kernel does: the wrapper given raw
    float32 queries answers exactly as given the rounded ones, and its
    scores are the rounded queries' products in float32."""
    y, q = _make(n=20000, kf=24, b=6, seed=9)
    up = stn.upload_streaming(y, dtype=torch.bfloat16)
    aux = stn._fold_aux(up.norms, None, cosine)
    raw = torch.from_numpy(q)
    rounded = raw.to(torch.bfloat16).float()
    assert not torch.equal(raw, rounded)
    scan = getattr(stn, kernel)
    got = scan(raw, up.mat_t, aux, up.n_items, 10, cosine, False)
    want = scan(rounded, up.mat_t, aux, up.n_items, 10, cosine, False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    v, i = stn.topn_merge(*got, 10)
    ref = rounded @ up.mat_t.float()[:, : up.n_items]
    if cosine:
        ref = ref / torch.clamp_min(
            up.norms[:, : up.n_items] * torch.linalg.vector_norm(rounded, dim=1, keepdim=True),
            1e-12,
        )
    torch.testing.assert_close(v, torch.gather(ref, 1, i.long()), rtol=1e-6, atol=1e-6)


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


# (what, queries, plane, aux, m, message): each breaks one rule
_REFUSED = [
    ("f64 queries", _meta((2, 32), torch.float64), _meta((32, 16384)), _meta((1, 16384)), 8,
     "float32"),
    ("f16 plane", _meta((2, 32)), _meta((32, 16384), torch.float16), _meta((1, 16384)), 8,
     "dtype"),
    ("feature mismatch", _meta((2, 31)), _meta((32, 16384)), _meta((1, 16384)), 8,
     "do not match"),
    ("aux width", _meta((2, 32)), _meta((32, 16384)), _meta((1, 16000)), 8, "aux"),
    ("ragged plane", _meta((2, 32)), _meta((32, 20000)), _meta((1, 20000)), 8, "multiple"),
    ("int8 features", _meta((2, 48)), _meta((48, 16384), torch.int8), _meta((1, 16384)), 8,
     "32 multiple"),
    ("strided queries", _meta((32, 2)).t(), _meta((32, 16384)), _meta((1, 16384)), 8,
     "contiguous"),
    ("m = 0", _meta((2, 32)), _meta((32, 16384)), _meta((1, 16384)), 0, "outside"),
    ("m = 129", _meta((2, 32)), _meta((32, 16384)), _meta((1, 16384)), 129, "outside"),
    ("no queries", _meta((0, 32)), _meta((32, 16384)), _meta((1, 16384)), 8, "no queries"),
    # any feature count scans now (the query pieces stream past 1,024):
    # only the device is left to refuse here
    ("1056 features", _meta((2, 1056)), _meta((1056, 16384), torch.int8), _meta((1, 16384)), 8,
     "CUDA"),
    ("not CUDA", _meta((2, 32)), _meta((32, 16384), torch.bfloat16), _meta((1, 16384)), 8,
     "CUDA"),
]


@pytest.mark.parametrize("what,q,mat_t,aux,m,message", _REFUSED, ids=[c[0] for c in _REFUSED])
def test_check_scan_args_refuses(what, q, mat_t, aux, m, message):
    with pytest.raises(ValueError, match=message):
        stn._check_scan_args(q, mat_t, aux, m)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kf", [1056, 4096])
def test_check_scan_args_takes_wide_planes(dtype, kf):
    """Past 1,024 features the query pieces stream: every shape rule
    holds, and only the device (a meta tensor here) is refused."""
    tdt = DTYPES[dtype][1]
    with pytest.raises(ValueError, match="CUDA tensors"):
        stn._check_scan_args(_meta((8, kf)), _meta((kf, 16384), tdt), _meta((1, 16384)), 64)


def test_check_scan_args_keeps_int8_feature_multiple_on_wide_planes():
    with pytest.raises(ValueError, match="32 multiple"):
        stn._check_scan_args(_meta((8, 1048)), _meta((1048, 16384), torch.int8),
                             _meta((1, 16384)), 64)
    assert stn._ceil_to(1041, stn._INT8_FEAT_MULTIPLE) == 1056


@pytest.mark.parametrize("dtype,cosine,b", [
    ("float32", False, 8), ("float32", True, 300), ("int8", False, 300), ("int8", True, 8),
    ("bfloat16", False, 8),
])
def test_wide_scan_matches_pallas(dtype, cosine, b):
    """1,056 features, the first width past the resident query pieces:
    the plain versions (what the wide kernels are held to on the card)
    against the Pallas scan in interpret mode, as test_scan_matches_pallas
    (int8 also through its 32-feature padding: 1,041 features)."""
    jdt, tdt = DTYPES[dtype]
    kf = 1041 if dtype == "int8" else 1056
    y, q = _make(n=3000, kf=kf, b=b, seed=40 + b)
    y /= np.sqrt(kf)
    ridx, rvals = ptn.top_k_streaming(ptn.upload_streaming(y, dtype=jdt), q, 10,
                                      cosine=cosine, interpret=True)
    idx, vals = stn.top_k_streaming(stn.upload_streaming(y, dtype=tdt), q, 10, cosine=cosine)
    if dtype == "bfloat16":
        for got, ref in zip(idx, ridx):
            assert len(set(got.tolist()) & set(ref.tolist())) >= 8
        np.testing.assert_allclose(vals, rvals, rtol=1e-2, atol=1e-2)
        return
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(vals, rvals, atol=1e-4)


# (what, values, ids, m, message): each breaks one rule of the merge kernel
_MERGE_REFUSED = [
    ("f64 values", _meta((3, 2, 8), torch.float64), _meta((3, 2, 8), torch.int32), 8, "float32"),
    ("int64 ids", _meta((3, 2, 8)), _meta((3, 2, 8), torch.int64), 8, "int32"),
    ("m mismatch", _meta((3, 2, 8)), _meta((3, 2, 8), torch.int32), 4, "not"),
    ("m = 129", _meta((3, 2, 129)), _meta((3, 2, 129), torch.int32), 129, "outside"),
    ("no lists", _meta((0, 2, 8)), _meta((0, 2, 8), torch.int32), 8, "empty"),
    ("strided", _meta((3, 8, 2)).transpose(1, 2), _meta((3, 2, 8), torch.int32), 8, "contiguous"),
    ("not CUDA", _meta((3, 2, 8)), _meta((3, 2, 8), torch.int32), 8, "CUDA"),
]


@pytest.mark.parametrize("what,v,i,m,message", _MERGE_REFUSED, ids=[c[0] for c in _MERGE_REFUSED])
def test_check_merge_args_refuses(what, v, i, m, message):
    with pytest.raises(ValueError, match=message):
        stn._check_merge_args(v, i, m)


def test_cpu_scans_count_no_launches():
    """CPU tensors take the plain versions: no kernel path counts a
    launch or a batch."""
    stn.reset_launch_counts()
    y, q = _make(n=3000, kf=16, b=5, seed=8)
    stn.top_k_streaming(stn.upload_streaming(y, dtype=torch.int8), q, 10)
    assert stn.launch_counts() == {
        "topn_scan.tc": 0, "topn_scan.tc_f32": 0, "topn_candidates.tc": 0,
        "topn_candidates.tc_f32": 0, "topn_merge": 0,
    }
    assert stn.scan_batch_histogram() == {}


def test_cuda_wrappers_refuse_other_devices():
    q = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError):
        stn.topn_scan(q, torch.zeros((4, 16384), device="meta"),
                      torch.zeros((1, 16384), device="meta"), 3, 2, False, False)
