"""The port's bus (oryx_tpu_torch.bus: the file bus and its block codec)
against the JAX package's, on the CPU.

The port's counterparts of tests/bus/test_bus.py (the inproc and file
cases), test_segments.py and test_torn_records.py, the block codec's
round trips, and read-across: a bus directory written by either
package's FileBroker is read record for record (keys, messages,
offsets, the group ledger) by the other, rolled segments and a torn
tail included, and kind-2 frames encoded by one decode in the other.
"""

import threading
import time
import zlib

import numpy as np
import pytest

from oryx_tpu.bus import blockcodec as jax_codec
from oryx_tpu.bus.filebus import FileBroker as JaxFileBroker
from oryx_tpu_torch import bus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus import blockcodec, filebus
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import crashpoints, metrics
from oryx_tpu_torch.common.records import RecordBlock


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    crashpoints.reset()
    yield
    crashpoints.reset()
    port_device.set_device(None)
    InProcessBroker.reset_all()


@pytest.fixture(params=["inproc", "file"])
def locator(request, tmp_path):
    if request.param == "inproc":
        return "inproc://test-broker"
    return f"file:{tmp_path}/bus"


# -- tests/bus/test_bus.py ------------------------------------------------------


def test_topic_admin(locator):
    assert not bus.topic_exists(locator, "T")
    bus.maybe_create_topic(locator, "T", partitions=4)
    assert bus.topic_exists(locator, "T")
    bus.maybe_create_topic(locator, "T", partitions=4)  # idempotent
    bus.delete_topic(locator, "T")
    assert not bus.topic_exists(locator, "T")


def test_produce_consume_from_beginning(locator):
    broker = bus.get_broker(locator)
    broker.create_topic("In", partitions=2)
    with broker.producer("In") as p:
        for i in range(20):
            p.send(f"k{i}", f"m{i}")
    consumer = broker.consumer("In", from_beginning=True)
    got = consumer.poll(max_records=100, timeout=1.0)
    assert sorted(m.message for m in got) == sorted(f"m{i}" for i in range(20))
    by_key = {m.key: m.message for m in got}
    assert by_key["k3"] == "m3"
    consumer.close()


def test_consumer_from_latest_sees_only_new(locator):
    broker = bus.get_broker(locator)
    broker.create_topic("T", 1)
    with broker.producer("T") as p:
        p.send(None, "old")
    consumer = broker.consumer("T")  # latest
    with broker.producer("T") as p:
        p.send(None, "new")
    got = consumer.poll(timeout=1.0)
    assert [m.message for m in got] == ["new"]
    consumer.close()


def test_group_offsets_resume(locator):
    broker = bus.get_broker(locator)
    broker.create_topic("T", 2)
    with broker.producer("T") as p:
        for i in range(10):
            p.send(f"k{i}", f"m{i}")
    c1 = broker.consumer("T", group="g1", from_beginning=True)
    assert len(c1.poll(max_records=100, timeout=1.0)) == 10
    c1.commit()
    c1.close()
    with broker.producer("T") as p:
        for i in range(10, 15):
            p.send(f"k{i}", f"m{i}")
    c2 = broker.consumer("T", group="g1")
    rest = c2.poll(max_records=100, timeout=1.0)
    assert sorted(m.message for m in rest) == [f"m{i}" for i in range(10, 15)]
    c2.close()


def test_get_set_offsets_api(locator):
    bus.maybe_create_topic(locator, "T", 2)
    bus.set_offsets(locator, "grp", "T", {0: 5, 1: 7})
    assert bus.get_offsets(locator, "grp", "T") == {0: 5, 1: 7}


def test_large_message(locator):
    broker = bus.get_broker(locator)
    broker.create_topic("U", 1)
    big = "x" * (1 << 20)
    with broker.producer("U") as p:
        p.send("MODEL", big)
    got = broker.consumer("U", from_beginning=True).poll(timeout=1.0)
    assert got[0].key == "MODEL"
    assert len(got[0].message) == len(big)


def test_blocking_poll_wakes_on_send():
    broker = bus.get_broker("inproc://wake-test")
    broker.create_topic("T", 1)
    consumer = broker.consumer("T", from_beginning=True)
    result = []
    t = threading.Thread(target=lambda: result.extend(consumer.poll(timeout=5.0)))
    t.start()
    with broker.producer("T") as p:
        p.send(None, "ping")
    t.join(timeout=5.0)
    assert [m.message for m in result] == ["ping"]
    consumer.close()


def test_file_bus_cross_instance(tmp_path):
    loc = f"file:{tmp_path}/shared"
    b1 = bus.get_broker(loc)
    b2 = bus.get_broker(loc)
    b1.create_topic("T", 1)
    with b1.producer("T") as p:
        p.send("a", "1")
    got = b2.consumer("T", from_beginning=True).poll(timeout=1.0)
    assert [(m.key, m.message) for m in got] == [("a", "1")]


@pytest.mark.parametrize("locator_form", ["file:{}", "file://{}", "{}"])
def test_file_locator_forms(tmp_path, locator_form):
    """file:<dir>, file://<dir> and a bare path all name the same bus."""
    broker = bus.get_broker(locator_form.format(tmp_path / "bus"))
    assert isinstance(broker, filebus.FileBroker)
    assert broker.root == tmp_path / "bus"


def test_file_consumer_incremental_polls_no_dupes(tmp_path):
    broker = bus.get_broker(f"file:{tmp_path}/bus")
    broker.create_topic("T", 1)
    c = broker.consumer("T", from_beginning=True)
    seen = []
    with broker.producer("T") as p:
        for batch in range(5):
            for i in range(10):
                p.send(None, f"b{batch}-m{i}")
            seen.extend(m.message for m in c.poll(max_records=100, timeout=1.0))
    assert len(seen) == 50 and len(set(seen)) == 50
    c.close()


def test_send_many_round_trips(locator):
    broker = bus.get_broker(locator)
    broker.create_topic("T", partitions=2)
    with broker.producer("T") as p:
        n = p.send_many((f"k{i}", f"m{i}") for i in range(50))
    assert n == 50
    got = broker.consumer("T", from_beginning=True).poll(max_records=100, timeout=1.0)
    assert sorted(m.message for m in got) == sorted(f"m{i}" for i in range(50))
    assert {m.key: m.message for m in got}["k7"] == "m7"


def test_file_send_many_one_lock_per_partition_batch(tmp_path, monkeypatch):
    broker = bus.get_broker(f"file:{tmp_path}/bus")
    broker.create_topic("T", partitions=1)
    locks = []
    real_enter = filebus._Flock.__enter__

    def counting_enter(self):
        locks.append(self._path)
        return real_enter(self)

    monkeypatch.setattr(filebus._Flock, "__enter__", counting_enter)
    with broker.producer("T") as p:
        p.send_many((None, f"m{i}") for i in range(1000))
    assert len(locks) == 1
    got = broker.consumer("T", from_beginning=True).poll(max_records=2000, timeout=1.0)
    assert len(got) == 1000
    assert got[0].message == "m0" and got[-1].message == "m999"


# hostile keys and messages for the text format
NASTY = [
    ("k\twith\ttabs", "m\nwith\nnewlines"),
    ("back\\slash", "tab\tand\\mix\r\n"),
    ("\x00k", "looks-like-none-key"),
    (None, "json-ish {\"k\":\"UP\"} message"),
    ('{"k":', "key that mimics the legacy prefix"),
    ("ünïcode-κλειδί", "ünïcode message ✓"),
    ("UP", '["X","u1",[1.5,2.5],["i1"]]'),
]


def test_file_wire_format_escapes_round_trip(tmp_path):
    broker = bus.get_broker(f"file:{tmp_path}/bus")
    broker.create_topic("T", 1)
    with broker.producer("T") as p:
        p.send_many(NASTY)
    with open(tmp_path / "bus" / "T" / "partition-0.log", "a", encoding="utf-8") as f:
        f.write('{"k":"legacy","m":"old format"}\n')
    want = NASTY + [("legacy", "old format")]
    got = broker.consumer("T", from_beginning=True).poll(max_records=100, timeout=1.0)
    assert [(m.key, m.message) for m in got] == want
    blk = broker.consumer("T", from_beginning=True).poll_block(max_records=100, timeout=1.0)
    assert [(m.key, m.message) for m in blk.iter_key_messages()] == want


# -- tests/bus/test_segments.py ----------------------------------------------------


def make_segmented(tmp_path, segment_bytes=200, retention_hours=None):
    broker = bus.get_broker(f"file:{tmp_path}/bus")
    cfg = {"segment-bytes": segment_bytes}
    if retention_hours is not None:
        cfg["retention-hours"] = retention_hours
    broker.create_topic("T", partitions=1, config=cfg)
    return broker


def test_roll_and_cross_segment_read(tmp_path):
    broker = make_segmented(tmp_path, segment_bytes=150)
    with broker.producer("T") as p:
        for j in range(40):
            p.send(None, f"m{j:04d}")
    assert len(sorted((tmp_path / "bus" / "T").glob("partition-0.seg*.log"))) >= 2
    got = broker.consumer("T", from_beginning=True).poll(max_records=100, timeout=1.0)
    assert [m.message for m in got] == [f"m{j:04d}" for j in range(40)]
    assert broker.latest_offsets("T") == {0: 40}
    assert broker.earliest_offsets("T") == {0: 0}


def test_incremental_consumption_across_rolls(tmp_path):
    broker = make_segmented(tmp_path, segment_bytes=120)
    c = broker.consumer("T", from_beginning=True)
    seen = []
    with broker.producer("T") as p:
        for batch in range(6):
            p.send_many((None, f"b{batch}-m{j}") for j in range(8))
            seen.extend(m.message for m in c.poll(max_records=100, timeout=1.0))
    assert seen == [f"b{b}-m{j}" for b in range(6) for j in range(8)]


def test_send_many_rolls_at_slice_granularity(tmp_path):
    broker = make_segmented(tmp_path, segment_bytes=100)
    with broker.producer("T") as p:
        p.send_many((None, f"x{j:05d}") for j in range(50))
    got = broker.consumer("T", from_beginning=True).poll(max_records=200, timeout=1.0)
    assert len(got) == 50 and got[-1].message == "x00049"


def test_retention_deletes_aged_segments_and_clamps_offsets(tmp_path):
    import os

    broker = make_segmented(tmp_path, segment_bytes=100, retention_hours=1)
    with broker.producer("T") as p:
        for j in range(30):
            p.send(None, f"old{j:03d}")
    past = time.time() - 7200
    for seg in (tmp_path / "bus" / "T").glob("partition-0.seg*.log"):
        os.utime(seg, (past, past))
    assert broker.apply_retention("T")
    earliest = broker.earliest_offsets("T")[0]
    assert earliest > 0
    broker.set_offsets("g", "T", {0: 0})
    c = broker.consumer("T", group="g", from_beginning=True)
    got = c.poll(max_records=100, timeout=1.0)
    assert [m.message for m in got] == [f"old{j:03d}" for j in range(earliest, 30)]
    c.commit()
    assert broker.get_offsets("g", "T") == {0: 30}


def test_large_record_spans_roll_boundary(tmp_path):
    broker = make_segmented(tmp_path, segment_bytes=64)
    big = "B" * 500
    with broker.producer("T") as p:
        p.send(None, "small-1")
        p.send("k", big)
        p.send(None, "small-2")
    got = broker.consumer("T", from_beginning=True).poll(max_records=10, timeout=1.0)
    assert [m.message for m in got] == ["small-1", big, "small-2"]
    assert got[1].key == "k"


def test_topic_config_reaches_the_file_bus(tmp_path):
    """oryx.<which>-topic.* retention and segment sizes reach the file
    bus through topic_config_from, as in the JAX package."""
    from oryx_tpu_torch.bus.core import topic_config_from
    from oryx_tpu_torch.common import config as tconfig

    cfg = tconfig.get_default().with_overlay(
        "oryx.update-topic.retention-hours = 2\noryx.update-topic.segment-bytes = 4096"
    )
    topic_cfg = topic_config_from(cfg, "update")
    assert topic_cfg["retention-hours"] == 2 and topic_cfg["segment-bytes"] == 4096
    broker = bus.get_broker(f"file:{tmp_path}/bus")
    broker.create_topic("U", 1, topic_cfg)
    assert broker._topic_config("U") == topic_cfg
    assert broker.producer("U")._segment_bytes == 4096


# -- tests/bus/test_torn_records.py ---------------------------------------------------


def _counter(name: str) -> float:
    return metrics.registry.counter(name).snapshot()["value"]


def _tear(path, cut):
    size = path.stat().st_size
    with open(path, "rb+") as f:
        f.truncate(max(0, size - cut))


def test_append_after_torn_tail_does_not_weld_records(tmp_path):
    broker = make_segmented(tmp_path, segment_bytes=10_000)
    with broker.producer("T") as p:
        for j in range(5):
            p.send(None, f"m{j:04d}")
    before = _counter("bus.repair.truncated")
    _tear(tmp_path / "bus" / "T" / "partition-0.log", 3)
    with broker.producer("T") as p:
        p.send(None, "fresh")
    assert _counter("bus.repair.truncated") == before + 1
    got = [m.message for m in broker.consumer("T", from_beginning=True).poll(100, 1.0)]
    assert got == ["m0000", "m0001", "m0002", "m0003", "fresh"]


def test_tear_destroying_every_newline_truncates_to_empty(tmp_path):
    broker = make_segmented(tmp_path, segment_bytes=10_000)
    with broker.producer("T") as p:
        p.send(None, "only-record")
    log = tmp_path / "bus" / "T" / "partition-0.log"
    with open(log, "rb+") as f:
        f.truncate(4)
    assert broker.repair("T")["truncated"] == 1
    assert log.stat().st_size == 0
    assert broker.repair("T")["truncated"] == 0
    with broker.producer("T") as p:
        p.send(None, "reborn")
    got = [m.message for m in broker.consumer("T", from_beginning=True).poll(100, 1.0)]
    assert got == ["reborn"]
    assert broker.latest_offsets("T") == {0: 1}


def test_repair_truncates_torn_tail_without_a_producer(tmp_path):
    broker = make_segmented(tmp_path, segment_bytes=10_000)
    with broker.producer("T") as p:
        for j in range(4):
            p.send(None, f"m{j:04d}")
    _tear(tmp_path / "bus" / "T" / "partition-0.log", 3)
    assert broker.repair("T")["truncated"] == 1
    got = [m.message for m in broker.consumer("T", from_beginning=True).poll(100, 1.0)]
    assert got == ["m0000", "m0001", "m0002"]


def _crash_one_roll(broker, start, segment_bytes=60):
    crashpoints.arm("bus.file.roll.mid", action="raise")
    acked = []
    p = broker.producer("T")
    try:
        for j in range(start, start + 3 * segment_bytes):
            p.send(None, f"m{j:04d}")
            acked.append(j)
        raise AssertionError("segment never rolled")
    except crashpoints.CrashPointReached:
        pass
    finally:
        crashpoints.reset()
    return acked


def test_mid_roll_crash_repair_rebuilds_stale_base(tmp_path):
    broker = make_segmented(tmp_path, segment_bytes=60)
    acked = _crash_one_roll(broker, 0)
    assert acked
    assert len(list((tmp_path / "bus" / "T").glob("partition-0.seg*.log"))) == 1
    report = broker.repair("T")
    assert report["bases-rebuilt"] == 1
    assert broker.latest_offsets("T") == {0: len(acked)}
    got = [m.message for m in broker.consumer("T", from_beginning=True).poll(100, 1.0)]
    assert got == [f"m{j:04d}" for j in acked]
    assert broker.repair("T")["bases-rebuilt"] == 0


def test_mid_roll_crash_next_roll_self_heals_without_losing_records(tmp_path):
    broker = make_segmented(tmp_path, segment_bytes=60)
    acked = _crash_one_roll(broker, 0)
    before = _counter("bus.repair.base-rebuilt")
    with broker.producer("T") as p:
        for j in range(len(acked), len(acked) + 11):
            p.send(None, f"m{j:04d}")
            acked.append(j)
    assert _counter("bus.repair.base-rebuilt") == before + 1
    got = [m.message for m in broker.consumer("T", from_beginning=True).poll(100, 1.0)]
    assert got == [f"m{j:04d}" for j in acked]
    assert broker.latest_offsets("T") == {0: len(acked)}


def test_unreadable_ledger_is_quarantined_and_group_replays(tmp_path):
    """A group ledger that no longer parses is moved aside and the group
    resumes from the earliest retained offset (at-least-once)."""
    broker = make_segmented(tmp_path, segment_bytes=10_000)
    with broker.producer("T") as p:
        p.send_many((None, f"m{j}") for j in range(6))
    c = broker.consumer("T", group="g", from_beginning=True)
    assert len(c.poll(100, 1.0)) == 6
    c.commit()
    ledger = tmp_path / "bus" / filebus._OFFSETS_DIR / "g.json"
    ledger.write_text("{not json")
    # the group's own open finds it: quarantined, replay from the earliest
    got = broker.consumer("T", group="g").poll(100, 1.0)
    assert [m.message for m in got] == [f"m{j}" for j in range(6)]
    assert len(list(ledger.parent.glob("g.json.corrupt-*"))) == 1
    # and the fsck sweep finds one too
    ledger.write_text("{not json")
    assert broker.repair()["ledgers-quarantined"] == 1
    assert not ledger.exists()


# -- the block codec ---------------------------------------------------------------


@pytest.mark.parametrize("key,message", NASTY + [("", ""), ("plain", "plain")])
def test_text_record_round_trip_matches_jax_bytes(key, message):
    line = blockcodec.encode_record(key, message)
    assert line == jax_codec.encode_record(key, message)
    assert "\n" not in line
    rec = blockcodec.decode_line(line.encode("utf-8"))
    assert (rec.key, rec.message) == (key, message)


def test_none_key_is_a_lone_nul_and_a_real_nul_is_escaped():
    assert blockcodec.encode_record(None, "m") == "\x00\tm"
    assert blockcodec.encode_record("\x00", "m") == "\\0\tm"
    assert blockcodec.decode_line(b"\x00\tm").key is None
    assert blockcodec.decode_line(b"\\0\tm").key == "\x00"


def test_legacy_json_and_corrupt_lines():
    rec = blockcodec.decode_line(b'{"k":"UP","m":"[1,2]"}')
    assert (rec.key, rec.message) == ("UP", "[1,2]")
    assert blockcodec.decode_line(b"no tab here") is None


def test_wire_lines_and_block_lines_match_jax():
    records = NASTY + [("UP", f"[{j}]") for j in range(5)] + [(None, "x")] * 3
    port = list(blockcodec.encode_wire_lines(records, slice_bytes=64))
    ref = list(jax_codec.encode_wire_lines(records, slice_bytes=64))
    assert port == ref and len(port) > 1
    decoded = [kv for blob, _ in port for kv in blockcodec.decode_wire_lines(blob)]
    assert decoded == records
    raw = [ln for blob, _ in port for ln in blob.split(b"\n") if ln]
    block = blockcodec.lines_to_block(raw, RecordBlock)
    assert [(m.key, m.message) for m in block.iter_key_messages()] == records
    assert list(blockcodec.decode_wire_lines(blockcodec.encode_block_lines(block))) == records


@pytest.mark.parametrize("timestamps", [False, True])
def test_columnar_frame_round_trip_both_ways(timestamps):
    gen = np.random.default_rng(3)
    n = 37
    users = gen.integers(0, 1 << 30, n).astype(np.int32)
    items = gen.integers(0, 1 << 30, n).astype(np.int32)
    values = gen.standard_normal(n).astype(np.float32)
    ts = gen.integers(0, 1 << 62, n).astype(np.int64) if timestamps else None
    port = blockcodec.encode_interaction_frame(99, users, items, values, b"u", b"item", ts)
    ref = jax_codec.encode_interaction_frame(99, users, items, values, b"u", b"item", ts)
    assert port == ref
    assert len(port) % 8 == 0
    for codec, wire in ((blockcodec, ref), (jax_codec, port)):
        frame = codec.decode_frame(wire)
        assert (frame.kind, frame.seqno, frame.count) == (codec.KIND_COLS, 99, n)
        u, i, v, t, up, ip = frame.columns()
        np.testing.assert_array_equal(u, users)
        np.testing.assert_array_equal(i, items)
        np.testing.assert_array_equal(v, values)
        assert (up, ip) == (b"u", b"item")
        if timestamps:
            np.testing.assert_array_equal(t, ts)
        else:
            assert t is None


def test_text_frame_and_frame_errors():
    blob = b"".join(b for b, _ in blockcodec.encode_wire_lines([("UP", "a"), (None, "b")]))
    wire = blockcodec.encode_text_frame(5, blob, 2)
    assert wire == jax_codec.encode_text_frame(5, blob, 2)
    head = blockcodec.HEADER.unpack_from(wire, 0)
    assert head[0] == blockcodec.MAGIC and head[-1] == zlib.crc32(blob)
    frame = blockcodec.decode_frame(wire)
    assert frame.text_lines() == [b"UP\ta", b"\x00\tb"]
    assert frame.wire_bytes() == len(wire)
    torn = bytearray(wire)
    torn[blockcodec.HEADER_BYTES] ^= 0xFF  # flip a payload byte
    with pytest.raises(blockcodec.FrameCrcError):
        blockcodec.decode_frame(bytes(torn))
    blockcodec.decode_frame(bytes(torn), check_crc=False)  # the header alone still parses
    with pytest.raises(blockcodec.FrameError, match="magic"):
        blockcodec.decode_frame(b"\x00" * 64)
    with pytest.raises(blockcodec.FrameError, match="overruns"):
        blockcodec.decode_frame(wire[:-16])
    with pytest.raises(blockcodec.FrameError, match="truncated"):
        blockcodec.decode_frame(wire[:10])


# -- read-across: one package writes, the other reads ------------------------------


def _write_topic(broker, root):
    """Rolled segments, a multi-partition topic, hostile records, a
    committed group and a torn tail on the active segment."""
    broker.create_topic("T", partitions=2, config={"segment-bytes": 120})
    records = NASTY + [(f"k{j}", f"m{j:03d}") for j in range(60)] + [(None, "tail")]
    with broker.producer("T") as p:
        p.send_many(records[:30])
        for key, message in records[30:]:
            p.send(key, message)
    c = broker.consumer("T", group="readers", from_beginning=True)
    assert len(c.poll(25, 1.0)) == 25
    c.commit()
    with open(root / "T" / "partition-0.log", "ab") as f:
        f.write(b"half-a-rec")  # a writer died mid-append
    return records


def _read_all(broker):
    c = broker.consumer("T", from_beginning=True)
    got = []
    while True:
        batch = c.poll(1000, 0.2)
        if not batch:
            break
        got.extend((m.key, m.message) for m in batch)
    return got, c.positions()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_across_packages(tmp_path, writer):
    root = tmp_path / "bus"
    jax_broker, port_broker = JaxFileBroker(str(root)), filebus.FileBroker(str(root))
    write, read = (jax_broker, port_broker) if writer == "jax" else (port_broker, jax_broker)
    records = _write_topic(write, root)
    assert len(list((root / "T").glob("partition-*.seg*.log"))) >= 2
    before = sorted(p.name for p in (root / "T").iterdir())
    # the reader sees the same records at the same offsets, the same
    # committed group offsets and the same segment chain as the writer
    got_read, pos_read = _read_all(read)
    got_write, pos_write = _read_all(write)
    assert got_read == got_write
    assert sorted(got_read, key=repr) == sorted(records, key=repr)
    assert pos_read == pos_write
    assert read.get_offsets("readers", "T") == write.get_offsets("readers", "T")
    assert read.latest_offsets("T") == write.latest_offsets("T")
    assert read.earliest_offsets("T") == write.earliest_offsets("T")
    assert sorted(p.name for p in (root / "T").iterdir()) == before
    # a group resumes across packages from what the other committed
    rest = read.consumer("T", group="readers").poll(1000, 0.5)
    assert len(rest) == len(records) - 25
    # and the reader's appends land where the writer reads them
    with read.producer("T") as p:
        p.send("k-late", "late")
    tail = write.consumer("T", group="readers").poll(1000, 0.5)
    assert ("k-late", "late") in [(m.key, m.message) for m in tail]
