"""``oryx_tpu_torch.ops.topn.upload_random`` (the counterpart of
``oryx_tpu.ops.topn.upload_random``), on the CPU.

The port draws its matrix with a ``torch.Generator`` on the device, so
its values are not the JAX package's PRNG draws; what must hold:

- the handle has ``upload``'s form for every score dtype (feature-major
  planes padded to BLOCK_N items, int8 codes with scales and a residual
  plane, feature padding to a multiple of 32 for int8);
- it equals ``upload()`` of its own matrix (``random_items``, read back)
  bit for bit in every plane but the norms, which it sums on the device
  in another order than numpy's and which agree within NORM_RTOL
  (relative), padding zero;
- the same seed gives the same handle, another seed another one, and the
  handle stays equal to ``upload()`` of ``random_items`` when a block
  holds fewer rows than the matrix (several blocks);
- the top-10 over it equals the JAX package's on the same numpy matrix:
  float32 through ``oryx_tpu.ops.topn.top_k_scores_batch`` (ids equal,
  values within 1e-4, as tests/test_torch_topn.py), int8 through the
  Pallas scan in interpret mode (ids equal, values to one bf16 step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.ops import pallas_topn as ptn
from oryx_tpu.ops import topn as jtopn
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus import faultbus
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common.ledger import ledger
from oryx_tpu_torch.ops import streaming_topn as stn
from oryx_tpu_torch.ops import topn

BF16_STEP = 2.0**-8
NORM_RTOL = 2e-6  # float32 sums of the same squares in two orders
PLANES = ("mat_t", "scales", "resid", "resid_scales")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    before = ledger.counts()
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    faultbus.reset()
    after = ledger.counts()
    assert all(after.get(k, 0) <= before.get(k, 0) for k in after), (before, after)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_same_handle(got, want):
    assert (got.n_items, got.features, got.num_features) == (
        want.n_items, want.features, want.num_features)
    for name in PLANES:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(_bits(a), _bits(b)), name
    assert got.norms.dtype == want.norms.dtype and got.norms.shape == want.norms.shape
    n = want.n_items
    torch.testing.assert_close(got.norms[0, :n], want.norms[0, :n], rtol=NORM_RTOL, atol=0.0)
    assert torch.all(got.norms[0, n:] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,kf", [(1, 3), (5003, 24), (16385, 10), (40000, 250)])
def test_handle_equals_upload_of_its_matrix_read_back(dtype, n, kf):
    h = topn.upload_random(n, kf, dtype, seed=11)
    mat = topn.random_items(n, kf, seed=11).numpy()
    assert mat.shape == (n, kf) and mat.dtype == np.float32
    _assert_same_handle(h, topn.upload(mat, dtype))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_handle_has_uploads_form(dtype):
    h = topn.upload_random(20_000, 25, dtype, seed=1)
    assert isinstance(h, stn.StreamingItemMatrix)
    assert h.n_items == 20_000 and h.mat_t.shape[1] == 2 * stn.BLOCK_N
    assert h.device.type == "cpu"
    if dtype == "int8":
        assert h.mat_t.dtype == torch.int8 and h.mat_t.shape[0] == 32 and h.features == 25
        assert h.resid.dtype == torch.int8 and h.quantized
        assert torch.all(h.scales[0, 20_000:] == 1.0) and torch.all(h.mat_t[:, 20_000:] == 0)
    else:
        assert h.mat_t.dtype == torch.float32 and h.mat_t.shape[0] == 25
        assert h.features is None and not h.quantized
    assert torch.all(h.norms[0, 20_000:] == 0) and torch.all(h.norms[0, :20_000] > 0)


def test_seed_decides_the_draw_and_several_blocks_agree(monkeypatch):
    a = topn.upload_random(3000, 8, "int8", seed=4)
    _assert_same_handle(a, topn.upload_random(3000, 8, "int8", seed=4))
    assert not torch.equal(a.mat_t, topn.upload_random(3000, 8, "int8", seed=5).mat_t)
    # three blocks of 1,000 rows: drawn, quantized and laid out one by one
    monkeypatch.setattr(topn, "RANDOM_CHUNK_ROWS", 1000)
    small = topn.upload_random(3000, 8, "int8", seed=4)
    assert small.n_items == 3000
    _assert_same_handle(small, topn.upload(topn.random_items(3000, 8, seed=4).numpy(), "int8"))


def test_streaming_false_is_refused():
    with pytest.raises(ValueError, match="streaming"):
        topn.upload_random(10, 4, streaming=False)
    assert topn.upload_random(10, 4, streaming=True).n_items == 10


@pytest.mark.parametrize("cosine", [False, True])
def test_float32_top10_equals_the_jax_facade(cosine):
    h = topn.upload_random(5003, 16, seed=3)
    y = topn.random_items(5003, 16, seed=3).numpy()
    q = np.random.default_rng(3).standard_normal((300, 16), dtype=np.float32)
    ours_i, ours_v = topn.top_k_scores_batch(h, q, 10, cosine=cosine)
    ref_i, ref_v = jtopn.top_k_scores_batch(jtopn.upload(y), q, 10, cosine=cosine)
    np.testing.assert_array_equal(ours_i, ref_i)
    np.testing.assert_allclose(ours_v, ref_v, atol=1e-4)


def test_int8_top10_equals_the_pallas_scan():
    h = topn.upload_random(5003, 24, "int8", seed=6)
    y = topn.random_items(5003, 24, seed=6).numpy()
    q = np.random.default_rng(6).standard_normal((8, 24), dtype=np.float32)
    gi, gv = topn.submit_top_k(h, q, 10).result()
    rv, ri = ptn.top_k_streaming_device(
        ptn.upload_streaming(y, dtype=jnp.int8), q, 10, interpret=True,
        download_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(gi, np.asarray(ri))
    np.testing.assert_allclose(gv, np.asarray(rv).astype(np.float32), rtol=BF16_STEP, atol=1e-6)
