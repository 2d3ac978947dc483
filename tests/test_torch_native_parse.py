"""The port's native columnar parser (``oryx_tpu_torch/native/parse.py``
over ``parse.cpp``) against the JAX package's, and the port's ALS speed
manager with the native parser on against the JAX package's, on the CPU.

Every block of tests/native/test_parse.py's corpus, the adversarial
frames included, goes through both packages' ``parse_text_columns``:
the same typed columns and id prefixes, or both decline. Where the
native parser accepts, its columns reproduce the port's Python parser
exactly (ids byte for byte, values as float32 bit patterns, timestamps);
where it declines, the Python parser owns the error. The two speed
managers then fold the same micro-batches into the same model: the same
``RatingMatrix`` and the same published X/Y messages, byte for byte
where the vectors are equal and within the fold-in tolerance of
tests/test_torch_als_app.py otherwise.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from oryx_tpu.app.als.speed import ALSSpeedModel as JaxSpeedModel
from oryx_tpu.app.als.speed import ALSSpeedModelManager as JaxSpeedManager
from oryx_tpu.bus.core import KeyMessage as JaxKeyMessage
from oryx_tpu.common import config as jconfig
from oryx_tpu.native import get_library as jax_library
from oryx_tpu.native import parse as jparse
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app.als import data as als_data
from oryx_tpu_torch.app.als.speed import ALSSpeedModel, ALSSpeedModelManager
from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as C
from oryx_tpu_torch.common.records import BlockRecords, RecordBlock
from oryx_tpu_torch.native import get_library
from oryx_tpu_torch.native import parse as native_parse

pytestmark = pytest.mark.skipif(
    get_library() is None or jax_library() is None, reason="native library unavailable"
)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


def _seeded_block():
    gen = np.random.default_rng(42)
    n = 20_000
    users = gen.integers(0, 100_000, n)
    items = gen.integers(0, 50_000, n)
    vals = gen.normal(size=n).astype(np.float32)
    ts = gen.integers(0, 2**40, n)
    return [f"u{u},i{i},{float(v)!r},{t}" for u, i, v, t in zip(users, items, vals, ts)]


# tests/native/test_parse.py's corpus: name -> (lines, threads, native accepts)
CORPUS = {
    "parity_basic_with_ts": (["1,7,5.0,1000", "2,7,3.5,2000", "1,9,1.0,3000"], 1, True),
    "parity_no_ts_column": (["1,7,5.0", "2,9,3.5"], 1, True),
    "parity_mixed_ts_presence": (["1,7,5.0,1000", "2,9,3.5", "3,9,1.5,2000"], 1, True),
    "parity_empty_value_is_delete_marker": (["1,7,,1000", "2,9,2.0,2000"], 1, True),
    "parity_empty_ts_field": (["1,7,5.0,", "2,9,3.5,7"], 1, True),
    "parity_prefixed_ids": (["u1,i7,5.0,1", "u2,i9,3.5,2"], 1, True),
    "parity_long_prefix_and_exponent_values": (
        ["user_1,item-7,1e-3,1", "user_22,item-9,2.5e2,2", "user_3,item-11,1E4,3"], 1, True),
    "parity_signs_dotfloat_and_negative_ts": (
        ["1,7,+0.5,-5", "2,9,-3.25,2", "3,11,.5,3", "4,13,2.9,4"], 1, True),
    "parity_float_timestamps": (["1,7,5.0,1000.9", "2,9,3.5,-2.7"], 1, True),
    "parity_int32_extremes": ([f"{2**31 - 1},0,1.0,1", "0,2147483647,2.0,2"], 1, True),
    "parity_seeded_random_block_multithreaded": (_seeded_block(), 4, True),
    "fallback_non_ascii_ids": (["ü1,7,5.0,1", "ü2,9,3.5,2"], 1, False),
    "fallback_mixed_prefixes_within_block": (["u1,i7,5.0,1", "v2,i9,3.5,2"], 1, False),
    "fallback_leading_zero_id": (["01,7,5.0,1"], 1, False),
    "fallback_quoted_csv": (['"u,1",7,5.0,1'], 1, False),
    "fallback_json_lines": (['["u1","i7",5.0,1]'], 1, False),
    "fallback_too_many_fields": (["1,7,5.0,1,extra"], 1, False),
    "fallback_truncated_lines_python_raises": (["1,7,5.0,1", "2,9"], 1, False),
    "fallback_id_overflow": ([f"{2**32},7,5.0,1"], 1, False),
    "fallback_value_overflow": (["1,7,1e400,1"], 1, False),
    "fallback_nan_literal": (["1,7,nan,1"], 1, False),
}


def as_block(lines):
    """Lines (str) -> the S-dtype array a decoded text frame holds."""
    return np.asarray([ln.encode() for ln in lines], dtype="S")


def reconstruct_ids(ints, prefix):
    """prefix + canonical decimal per row, as an S array (what the native
    typed columns denote)."""
    s = np.char.mod("%d", ints).astype("S")
    if prefix:
        s = np.char.add(np.full(len(s), prefix, dtype=f"S{len(prefix)}"), s)
    return s


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_corpus_block_parses_as_the_jax_package_does(name):
    lines, threads, accepts = CORPUS[name]
    block = as_block(lines)
    got = native_parse.parse_text_columns(block, threads=threads)
    want = jparse.parse_text_columns(block, threads=threads)
    assert (got is not None) == (want is not None) == accepts, name
    if not accepts:
        try:
            als_data.parse_interaction_block(block)
        except ValueError:
            # the authoritative Python path owns the error, in both packages
            assert name == "fallback_truncated_lines_python_raises"
        return
    for field in ("users", "items", "timestamps"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got.values.dtype == np.float32
    np.testing.assert_array_equal(got.values.view(np.uint32), want.values.view(np.uint32))
    assert (got.user_prefix, got.item_prefix) == (want.user_prefix, want.item_prefix)
    # and the port's Python parser reads the same block to the same columns
    ref = als_data.parse_interaction_block(block)
    np.testing.assert_array_equal(reconstruct_ids(got.users, got.user_prefix), ref.users.astype("S"))
    np.testing.assert_array_equal(reconstruct_ids(got.items, got.item_prefix), ref.items.astype("S"))
    np.testing.assert_array_equal(got.values.view(np.uint32), ref.values.view(np.uint32))
    ts = got.timestamps if got.timestamps is not None else np.zeros(len(got.users), np.int64)
    np.testing.assert_array_equal(ts, ref.timestamps)


def test_empty_batch_returns_none():
    for parse in (native_parse.parse_text_columns, jparse.parse_text_columns):
        assert parse([]) is None
        assert parse(np.empty(0, "S1")) is None


def test_list_input_and_thread_counts_agree():
    lines = CORPUS["parity_seeded_random_block_multithreaded"][0][:3000]
    as_list = [ln.encode() for ln in lines]
    outs = [native_parse.parse_text_columns(as_list, threads=t) for t in (1, 3, 8)]
    for out in outs[1:]:
        np.testing.assert_array_equal(out.users, outs[0].users)
        np.testing.assert_array_equal(out.values.view(np.uint32), outs[0].values.view(np.uint32))


# -- the speed manager, native parser on, against the JAX package's -----------------


def managers(native: bool = True, extra: str = ""):
    """The port's and the JAX package's speed manager on the same model:
    a few hundred users and items with seeded vectors."""
    gen = np.random.default_rng(17)
    users = [f"u{j}" for j in range(300)]
    items = [f"i{j}" for j in range(200)]
    xs = gen.standard_normal((len(users), 6)).astype(np.float32)
    ys = gen.standard_normal((len(items), 6)).astype(np.float32)
    overlay = f"oryx.speed.parse.native = {str(native).lower()}\n{extra}"
    out = []
    for conf, mgr_cls, model_cls in ((C, ALSSpeedModelManager, ALSSpeedModel),
                                     (jconfig, JaxSpeedManager, JaxSpeedModel)):
        mgr = mgr_cls(conf.get_default().with_overlay(overlay))
        mgr.model = model_cls(6, True, set(), set())
        mgr.model.set_user_vectors(users, xs)
        mgr.model.set_item_vectors(items, ys)
        out.append(mgr)
    return out


def micro_batches(seed: int, n: int = 3):
    gen = np.random.default_rng(seed)
    out = []
    for b in range(n):
        m = 400
        users = gen.integers(0, 330, m)  # some users are new
        items = gen.integers(0, 210, m)
        vals = gen.integers(1, 6, m)
        out.append([f"u{u},i{i},{v}.0,{b * 1000 + j}"
                    for j, (u, i, v) in enumerate(zip(users, items, vals))])
    return out


def assert_same_messages(got, want):
    """Same ids and known lists in the same order; vectors within the
    fold-in tolerance, and byte-equal messages where they are equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gj, wj = json.loads(g), json.loads(w)
        assert gj[:2] + gj[3:] == wj[:2] + wj[3:]
        gv, wv = np.asarray(gj[2], np.float32), np.asarray(wj[2], np.float32)
        np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)
        if np.array_equal(gv, wv):
            assert g == w


@pytest.mark.parametrize("parser", ["native", "python"])
@pytest.mark.parametrize("framing", ["lines", "blocks"])
def test_speed_manager_matches_jax(framing, parser):
    port, jax = managers(native=parser == "native")
    assert port.native_parse == (parser == "native") and port.parse_threads == jax.parse_threads
    for batch in micro_batches(23):
        if framing == "lines":
            p_in = [KeyMessage(None, e) for e in batch]
            j_in = [JaxKeyMessage(None, e) for e in batch]
        else:
            from oryx_tpu.common.records import BlockRecords as JaxBlockRecords
            from oryx_tpu.common.records import RecordBlock as JaxRecordBlock

            half = len(batch) // 2
            p_in = BlockRecords([RecordBlock(None, as_block(batch[:half])),
                                 RecordBlock(None, as_block(batch[half:]))])
            j_in = JaxBlockRecords([JaxRecordBlock(None, as_block(batch[:half])),
                                    JaxRecordBlock(None, as_block(batch[half:]))])
        p_rm, j_rm = port.parse_batch(p_in), jax.parse_batch(j_in)
        assert p_rm.user_ids == j_rm.user_ids and p_rm.item_ids == j_rm.item_ids
        np.testing.assert_array_equal(p_rm.user_idx, j_rm.user_idx)
        np.testing.assert_array_equal(p_rm.item_idx, j_rm.item_idx)
        np.testing.assert_array_equal(p_rm.values.view(np.uint32), j_rm.values.view(np.uint32))
        assert_same_messages(port.fold_parsed(p_rm), jax.fold_parsed(j_rm))
    # the self-applied deltas left both models in the same state
    for side in ("x", "y"):
        p, j = getattr(port.model, side), getattr(jax.model, side)
        assert p.ids() == j.ids()
        np.testing.assert_allclose(p.to_matrix()[1], j.to_matrix()[1], rtol=1e-4, atol=1e-5)


def test_native_and_python_parsers_publish_identical_updates():
    """parse_batch |> fold_parsed gives the same messages whether the
    native parse ran or the batch took the Python parser, in the port as
    in the JAX package (tests/native/test_parse.py's manager case). The
    int columns order ids by their codes, the Python parser by their
    text, so the messages compare as sets."""
    events = ["u1,i2,3.0,1", "u2,i1,2.0,2", "u1,i2,1.5,3"]

    def run(native, jax):
        mgr = managers(native=native)[jax]
        km = JaxKeyMessage if jax else KeyMessage
        return sorted(mgr.fold_parsed(mgr.parse_batch([km(None, e) for e in events])))

    assert run(True, 0) == run(False, 0)
    assert run(True, 1) == run(False, 1)
    assert_same_messages(run(True, 0), run(True, 1))


def test_a_declined_block_takes_the_python_parser():
    port, jax = managers(native=True)
    mixed = ["u1,i2,3.0,1", "v2,i3,1.0,2", "u3,i4,2.0,3"]  # mixed prefixes: native declines
    assert native_parse.parse_text_columns(as_block(mixed)) is None
    p_rm = port.parse_batch([KeyMessage(None, e) for e in mixed])
    j_rm = jax.parse_batch([JaxKeyMessage(None, e) for e in mixed])
    assert p_rm.user_ids == j_rm.user_ids == ["u1", "u3", "v2"]
    with pytest.raises(ValueError):
        port.parse_batch([KeyMessage(None, "u1,i2")])


def test_parse_threads_divide_among_shards():
    port, jax = managers(native=True, extra="oryx.speed.parse.threads = 8")
    assert port.parse_threads == jax.parse_threads == 8
    port.configure_sharding(3)
    jax.configure_sharding(3)
    assert port.parse_threads == jax.parse_threads == 2
    port.configure_sharding(16)
    assert port.parse_threads == 1
