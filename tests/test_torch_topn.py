"""The port's top-N facade (oryx_tpu_torch.ops.topn) against the JAX
package's (oryx_tpu.ops.topn and oryx_tpu.ops.pallas_topn), on the CPU.

Inputs are made from a seed with numpy and fed to both packages.

- float32 facade calls compare with ``oryx_tpu.ops.topn`` directly
  (ids equal, values within 1e-4, as tests/ops/test_pallas_topn.py).
- int8 and bfloat16 facade calls compare with the Pallas scan in
  interpret mode with the same bf16 download rounding: on a CPU the JAX
  facade takes its XLA twin, whose chunked candidate selection differs
  by design. int8 ids must be equal; the returned values are bf16, so
  they agree to one bf16 step (2**-8 relative) — an f32 score a few
  ulps from a rounding boundary may round to either neighbour.
- incremental updates and capacities are bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.ops import pallas_topn as ptn
from oryx_tpu.ops import topn as jtopn
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.ops import streaming_topn as stn
from oryx_tpu_torch.ops import topn

BF16_STEP = 2.0**-8


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


def _data(n=5000, kf=24, b=8, seed=0):
    gen = np.random.default_rng(seed)
    return (gen.standard_normal((n, kf), dtype=np.float32),
            gen.standard_normal((b, kf), dtype=np.float32))


def _planes(h):
    """Every plane of a handle (port or JAX) as float32/int numpy."""
    out = {}
    for name in ("mat_t", "norms", "scales", "resid", "resid_scales"):
        a = getattr(h, name)
        if a is None:
            out[name] = None
        elif isinstance(a, torch.Tensor):
            out[name] = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        else:
            out[name] = np.asarray(a).astype(np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a)
    return out


def _assert_same_planes(port, ref):
    assert port.n_items == ref.n_items and port.features == ref.features
    p, r = _planes(port), _planes(ref)
    for name in p:
        assert (p[name] is None) == (r[name] is None), name
        if p[name] is not None:
            np.testing.assert_array_equal(p[name], r[name], err_msg=name)


# -- capacity and incremental updates ---------------------------------------


@pytest.mark.parametrize("n", [1, 16384, 16385, 40000])
def test_capacity_agrees_with_streaming_layout(n):
    y = np.ones((n, 3), np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.int8, torch.int8)):
        assert topn.capacity(topn.upload(y, dtype=tdt)) == jtopn.capacity(
            ptn.upload_streaming(y, dtype=jdt)
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_update_rows_matches_jax_and_fresh_upload(dtype):
    """A scatter (in-place rows plus an append into the padded capacity)
    leaves every plane bit-identical to the JAX package's scatter and to
    a fresh upload of the updated matrix."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.int8, torch.int8)}[dtype]
    y, _ = _data(n=3000, kf=19, seed=1)
    gen = np.random.default_rng(11)
    rows = np.array([0, 17, 2999, 3000, 3001])  # the last two append
    vals = gen.standard_normal((len(rows), 19), dtype=np.float32)
    vals[1] = 0.0  # an all-zero row requantizes to scale 1.0
    port = topn.update_rows(topn.upload(y, dtype=tdt), rows, vals, n_items=3002)
    ref = jtopn.update_rows(ptn.upload_streaming(y, dtype=jdt), rows, vals, n_items=3002)
    _assert_same_planes(port, ref)
    updated = np.concatenate([y, np.zeros((2, 19), np.float32)])
    updated[rows] = vals
    _assert_same_planes(port, stn.upload_streaming(updated, dtype=tdt))


def test_update_rows_empty_is_identity():
    y, _ = _data(n=100, kf=4)
    h = topn.upload(y, dtype=torch.int8)
    assert topn.update_rows(h, np.zeros(0, np.int64), np.zeros((0, 4), np.float32)) is h


def test_upload_and_update_queries_match_jax():
    x, _ = _data(n=40, kf=6, seed=3)
    rows = np.array([2, 39, 5])
    vals = np.arange(18, dtype=np.float32).reshape(3, 6)
    port = topn.update_query_rows(topn.upload_queries(x), rows, vals)
    ref = jtopn.update_query_rows(jtopn.upload_queries(x), rows, vals)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert topn.update_query_rows(port, np.zeros(0, np.int64), vals[:0]) is port


def test_group_pad_matches_jax():
    a = np.arange(21, dtype=np.int32)
    for batch in (1, 8, 256):
        g, n = topn._group_pad(a, batch)
        jg, jn = jtopn._group_pad(a, batch)
        np.testing.assert_array_equal(g, jg)
        assert n == jn


def test_download_dtype_rounds_bf16_and_int8_only():
    y, _ = _data(n=50, kf=4)
    assert topn._auto_download_dtype(topn.upload(y)) is None
    assert topn._auto_download_dtype(topn.upload(y, dtype=torch.bfloat16)) == torch.bfloat16
    assert topn._auto_download_dtype(topn.upload(y, dtype=torch.int8)) == torch.bfloat16


# -- float32 facade against oryx_tpu.ops.topn --------------------------------


@pytest.mark.parametrize("cosine", [False, True])
def test_float32_scores_match_jax_facade(cosine):
    y, q = _data(n=5003, kf=16, b=300, seed=4)
    port, ref = topn.upload(y), jtopn.upload(y)
    i1, v1 = topn.top_k_scores(port, q[0], 10, cosine=cosine)
    r1, rv1 = jtopn.top_k_scores(ref, q[0], 10, cosine=cosine)
    np.testing.assert_array_equal(i1, r1)
    np.testing.assert_allclose(v1, rv1, atol=1e-4)
    # 300 rows: the candidates kernel's plain version
    ib, vb = topn.top_k_scores_batch(port, q, 10, cosine=cosine)
    rb, rvb = jtopn.top_k_scores_batch(ref, q, 10, cosine=cosine)
    np.testing.assert_array_equal(ib, rb)
    np.testing.assert_allclose(vb, rvb, atol=1e-4)


def test_float32_submits_match_jax_facade():
    y, q = _data(n=5003, kf=16, b=300, seed=5)
    port, ref = topn.upload(y), jtopn.upload(y)
    cases = [
        (topn.submit_top_k(port, q[:8], 16), jtopn.submit_top_k(ref, q[:8], 16)),
        (topn.submit_top_k_multi(port, q, 16, scan_batch=128),
         jtopn.submit_top_k_multi(ref, q, 16, scan_batch=128)),
    ]
    rows = np.array([3, 299, 0, 150, 7])
    cases.append((
        topn.submit_top_k_multi_indexed(port, topn.upload_queries(q), rows, 16, scan_batch=2),
        jtopn.submit_top_k_multi_indexed(ref, jtopn.upload_queries(q), rows, 16, scan_batch=2),
    ))
    for got, want in cases:
        gi, gv = got.result()
        wi, wv = want.result()
        assert gv.dtype == np.float32 and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gv, wv, atol=1e-4)


# -- int8 and bfloat16 facade against the Pallas scan (interpret mode) -------


def _pallas_multi(up, q_kb, k, cosine=False):
    """The JAX reference of a grouped facade call: one interpret-mode
    Pallas scan per group, scores downloaded as bf16."""
    outs = [ptn.top_k_streaming_device(up, g, k, cosine=cosine, interpret=True,
                                       download_dtype=jnp.bfloat16) for g in q_kb]
    return (np.stack([np.asarray(i) for _, i in outs]),
            np.stack([np.asarray(v).astype(np.float32) for v, _ in outs]))


def _assert_bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=1e-6)


@pytest.mark.parametrize("cosine", [False, True])
def test_int8_submit_top_k_matches_pallas(cosine):
    y, q = _data(n=5003, kf=24, b=8, seed=6)
    h = topn.submit_top_k(topn.upload(y, dtype=torch.int8), q, 16, cosine=cosine)
    gi, gv = h.result()
    ri, rv = _pallas_multi(ptn.upload_streaming(y, dtype=jnp.int8), q[None], 16, cosine)
    np.testing.assert_array_equal(gi, ri[0])
    _assert_bf16_close(gv, rv[0])


def test_int8_multi_and_indexed_match_pallas():
    y, q = _data(n=5003, kf=24, b=20, seed=7)
    port = topn.upload(y, dtype=torch.int8)
    ref = ptn.upload_streaming(y, dtype=jnp.int8)
    q_kb, n = topn._group_pad(q, 8)
    ri, rv = _pallas_multi(ref, q_kb, 16)
    ri, rv = ri.reshape(-1, 16)[:n], rv.reshape(-1, 16)[:n]
    gi, gv = topn.submit_top_k_multi(port, q, 16, scan_batch=8).result()
    np.testing.assert_array_equal(gi, ri)
    _assert_bf16_close(gv, rv)
    # index submit: the same rows gathered from the staged query matrix
    xi, xv = topn.submit_top_k_multi_indexed(
        port, topn.upload_queries(q), np.arange(n), 16, scan_batch=8
    ).result()
    np.testing.assert_array_equal(xi, ri)
    np.testing.assert_array_equal(xv, gv)


def test_int8_update_rows_then_scan_matches_pallas():
    """A requantized scatter scans like the JAX package's scatter."""
    y, q = _data(n=4000, kf=24, b=8, seed=8)
    gen = np.random.default_rng(9)
    rows = np.array([1, 2, 3999, 4000])
    vals = 3.0 * gen.standard_normal((4, 24), dtype=np.float32)  # rows that win
    port = topn.update_rows(topn.upload(y, dtype=torch.int8), rows, vals, n_items=4001)
    ref = jtopn.update_rows(ptn.upload_streaming(y, dtype=jnp.int8), rows, vals, n_items=4001)
    gi, gv = topn.submit_top_k(port, q, 10).result()
    ri, rv = _pallas_multi(ref, q[None], 10)
    np.testing.assert_array_equal(gi, ri[0])
    _assert_bf16_close(gv, rv[0])
    assert np.isin(gi, rows).any()


def test_bfloat16_submit_ranks_close_to_pallas():
    y, q = _data(n=5003, kf=24, b=8, seed=10)
    gi, gv = topn.submit_top_k(topn.upload(y, dtype=torch.bfloat16), q, 16).result()
    ri, rv = _pallas_multi(ptn.upload_streaming(y, dtype=jnp.bfloat16), q[None], 16)
    for got, ref in zip(gi, ri[0]):
        assert len(set(got.tolist()) & set(ref.tolist())) >= int(0.8 * 16)
    np.testing.assert_allclose(gv, rv[0], rtol=1e-2, atol=1e-2)
