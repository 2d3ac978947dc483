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


def test_cuda_wrappers_refuse_other_devices():
    q = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError):
        stn.topn_scan(q, torch.zeros((4, 16384), device="meta"),
                      torch.zeros((1, 16384), device="meta"), 3, 2, False, False)
