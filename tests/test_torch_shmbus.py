"""The port's shared-memory ring bus (oryx_tpu_torch.bus.shmbus) on the CPU.

The port's counterpart of tests/bus/test_shmbus.py (typed columns over
the ring, cross-process wrap-around, bounded backpressure, guard slots,
CRC resync, mid-frame offsets), the three shm cases of
tests/lambda_/test_speed_pipeline.py, and the ring held against the JAX
package's: a ring one package writes the other reads to the same
records, both ways; identical sends leave identical ring files; frames
torn by ``common/corruption.py`` are skipped with the same
``bus.shm.crc-resyncs`` count; and a speed layer whose consumer lags a
wrapping ring publishes the JAX package's ALS updates. Blocks parsed
from ring views own their data once the consumer releases the ring.
"""

import os
import time

import numpy as np
import pytest

from oryx_tpu.bus import shmbus as jax_shmbus
from oryx_tpu.common import corruption as jax_corruption
from oryx_tpu.common import metrics as jax_metrics
from oryx_tpu_torch import bus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus import faultbus, shmbus
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.bus.shmbus import ShmBroker
from oryx_tpu_torch.common import config as C
from oryx_tpu_torch.common import corruption, metrics
from oryx_tpu_torch.lambda_.speed import SpeedLayer


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    faultbus.reset()
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    faultbus.reset()


def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def make_broker(tmp_path, **kw):
    return ShmBroker(str(tmp_path / "bus"), **kw)


# -- columnar round-trip -------------------------------------------------------


def test_typed_columns_round_trip_zero_copy(tmp_path):
    broker = make_broker(tmp_path)
    broker.create_topic("T", 1)
    users = np.arange(1000, dtype=np.int32)
    items = (users * 7 % 113).astype(np.int32)
    values = (users / 3.0).astype(np.float32)
    ts = np.arange(1000, dtype=np.int64) + 1_700_000_000_000
    with broker.producer("T") as p:
        assert p.send_interactions(users, items, values, timestamps=ts) == 1000
    c = broker.consumer("T", from_beginning=True)
    block = c.poll_block(max_records=2000, timeout=1.0)
    assert len(block) == 1000
    np.testing.assert_array_equal(block.users, users)
    np.testing.assert_array_equal(block.items, items)
    np.testing.assert_array_equal(block.values, values)
    np.testing.assert_array_equal(block.timestamps, ts)
    # zero-copy: the columns are views over ring memory, not copies
    assert not block.users.flags.owndata
    owned = block.materialize()
    assert owned.users.flags.owndata
    # text compatibility rendering round-trips through the line format
    assert block.messages[0] == b"u0,i0,0,1700000000000"
    c.close()


def test_text_and_typed_frames_interleave(tmp_path):
    """TEXT frames (send/send_many, MODEL messages) and COLS frames share
    one ring; consumers see them in order as separate blocks."""
    broker = make_broker(tmp_path)
    broker.create_topic("T", 1)
    with broker.producer("T") as p:
        p.send("MODEL", "line one\nline two")  # newline must survive escaping
        p.send_interactions(
            np.array([1, 2], np.int32),
            np.array([3, 4], np.int32),
            np.array([1.0, 2.0], np.float32),
        )
        p.send(None, "tail")
    c = broker.consumer("T", from_beginning=True)
    b1 = c.poll_block(timeout=1.0)
    assert list(b1.keys.tolist()) == [b"MODEL"]
    assert b1.messages[0] == b"line one\nline two"
    b2 = c.poll_block(timeout=1.0)
    assert hasattr(b2, "users") and len(b2) == 2
    b3 = c.poll_block(timeout=1.0)
    assert b3.messages[0] == b"tail"
    c.close()


# -- cross-process -------------------------------------------------------------


@pytest.mark.skipif(not hasattr(os, "fork"), reason="requires fork")
def test_cross_process_wrap_around(tmp_path):
    """A child process produces several ring-fulls of typed records while
    the parent concurrently consumes: reclaim + wrap-around must lose
    nothing across the process boundary."""
    n_total = 200_000
    chunk = 10_000
    broker = make_broker(tmp_path, ring_bytes=1 << 20)  # ~7 wraps
    broker.create_topic("T", 1)
    pid = os.fork()
    if pid == 0:  # child: producer
        try:
            child_broker = ShmBroker(str(tmp_path / "bus"), ring_bytes=1 << 20)
            with child_broker.producer("T") as p:
                for start in range(0, n_total, chunk):
                    u = np.arange(start, start + chunk, dtype=np.int32)
                    p.send_interactions(
                        u, u % 997, (u % 11).astype(np.float32)
                    )
            os._exit(0)
        except BaseException:
            os._exit(1)
    c = broker.consumer("T", from_beginning=True)
    got = 0
    checksum = 0
    deadline = time.monotonic() + 60.0
    while got < n_total and time.monotonic() < deadline:
        block = c.poll_block(max_records=50_000, timeout=0.1)
        if block is None:
            continue
        got += len(block)
        checksum += int(block.users.astype(np.int64).sum())
    _, status = os.waitpid(pid, 0)
    assert os.waitstatus_to_exitcode(status) == 0
    assert got == n_total
    assert checksum == n_total * (n_total - 1) // 2
    c.close()


# -- backpressure --------------------------------------------------------------


def test_slow_consumer_backpressure_bounded_never_drops(tmp_path):
    """A registered consumer's guard blocks reclaim: the producer gets a
    BOUNDED BlockingIOError (not a hang, not a silent overwrite), and
    after the consumer drains, everything produced is still readable."""
    broker = make_broker(tmp_path, ring_bytes=1 << 17, full_block_ms=150.0)
    broker.create_topic("T", 1)
    c = broker.consumer("T", from_beginning=True)  # idle: guard pins tail
    u = np.arange(2000, dtype=np.int32)
    sent = 0
    t0 = time.monotonic()
    with broker.producer("T") as p:
        with pytest.raises(BlockingIOError):
            for _ in range(100):  # far more than a 128KB ring holds
                p.send_interactions(u, u, u.astype(np.float32))
                sent += 2000
        blocked_for = time.monotonic() - t0
        assert blocked_for < 10.0  # bounded wait, not a hang
        # drain: the stalled producer's data was never overwritten
        got = 0
        while got < sent:
            block = c.poll_block(max_records=10_000, timeout=1.0)
            assert block is not None, f"lost records: {got} < {sent}"
            got += len(block)
        assert got == sent
        # with the guard advanced, producing works again
        assert p.send_interactions(u, u, u.astype(np.float32)) == 2000
    c.close()


def test_pinned_consumer_blocks_reclaim_release_unblocks(tmp_path):
    broker = make_broker(tmp_path, ring_bytes=1 << 17, full_block_ms=100.0)
    broker.create_topic("T", 1)
    c = broker.consumer("T", from_beginning=True)
    u = np.arange(1000, dtype=np.int32)
    with broker.producer("T") as p:
        p.send_interactions(u, u, u.astype(np.float32))
        c.pin()
        first = c.poll_block(max_records=10_000, timeout=1.0)
        assert first is not None
        # pinned: even after the poll, the guard holds the polled frames,
        # so a ring's worth of new data cannot reclaim them
        with pytest.raises(BlockingIOError):
            for _ in range(50):
                p.send_interactions(u, u, u.astype(np.float32))
        # the pinned views are still intact (nothing overwrote them)
        np.testing.assert_array_equal(first.users, u)
        c.release()
        drained = 0
        while True:
            b = c.poll_block(max_records=100_000, timeout=0.2)
            if b is None:
                break
            drained += len(b)
        assert p.send_interactions(u, u, u.astype(np.float32)) == 1000
    c.close()


def test_dead_consumer_slot_is_evicted(tmp_path):
    """A consumer whose process died (pid gone) must not wedge the ring:
    its slot is evicted at the next reclaim scan."""
    broker = make_broker(tmp_path, ring_bytes=1 << 17, full_block_ms=200.0)
    broker.create_topic("T", 1)
    c = broker.consumer("T", from_beginning=True)
    # forge a dead pid in the consumer's slot table entry
    ring = broker._ring("T", 0)
    for slot in range(shmbus._MAX_SLOTS):
        off = shmbus._SLOTS_OFF + slot * shmbus._SLOT_BYTES
        if ring.u64(off) == os.getpid():
            ring.set_u64(off, 2**31 - 7)  # unlikely-live pid
            break
    else:
        pytest.fail("consumer slot not found")
    u = np.arange(2000, dtype=np.int32)
    with broker.producer("T") as p:
        for _ in range(60):  # several ring-fulls: would block if not evicted
            p.send_interactions(u, u, u.astype(np.float32))


# -- torn blocks / CRC ---------------------------------------------------------


def test_torn_block_crc_rejected_and_resynced(tmp_path):
    """Externally corrupted frame payload: the CRC rejects the block, the
    consumer resyncs to the next frame, and the corruption is counted."""
    from oryx_tpu_torch.common import metrics

    broker = make_broker(tmp_path)
    broker.create_topic("T", 1)
    u1 = np.arange(10, dtype=np.int32)
    u2 = np.arange(10, 15, dtype=np.int32)
    with broker.producer("T") as p:
        p.send_interactions(u1, u1, u1.astype(np.float32))
        p.send_interactions(u2, u2, u2.astype(np.float32))
    # poke a byte inside frame 0's payload (past the 32B header)
    ring_path = tmp_path / "bus" / "T" / "partition-0.ring"
    with open(ring_path, "r+b") as f:
        f.seek(shmbus._HEADER_PAGE + shmbus.blockcodec.HEADER_BYTES + 8)
        f.write(b"\xff\xff\xff\xff")
    resyncs0 = metrics.registry.counter("bus.shm.crc-resyncs").value
    c = broker.consumer("T", from_beginning=True)
    block = c.poll_block(max_records=100, timeout=1.0)
    # the torn frame's 10 records are lost (rejected), the next survives
    assert block is not None and len(block) == 5
    np.testing.assert_array_equal(block.users, u2)
    assert c.poll_block(timeout=0.1) is None
    assert metrics.registry.counter("bus.shm.crc-resyncs").value > resyncs0
    c.close()


# -- offsets, seek, at-least-once parity --------------------------------------


def test_mid_frame_positions_and_group_resume(tmp_path):
    """Record-granular offsets inside one 100-record frame: a committed
    group consumer resumes mid-frame without redelivery or loss."""
    broker = make_broker(tmp_path)
    broker.create_topic("T", 1)
    u = np.arange(100, dtype=np.int32)
    with broker.producer("T") as p:
        p.send_interactions(u, u, u.astype(np.float32))
    c = broker.consumer("T", group="g", from_beginning=True)
    first = c.poll_block(max_records=30, timeout=1.0)
    assert len(first) == 30 and c.positions() == {0: 30}
    c.commit()
    c.close()
    c2 = broker.consumer("T", group="g")
    rest = []
    while True:
        b = c2.poll_block(max_records=100, timeout=0.2)
        if b is None:
            break
        rest.append(b)
    assert sum(len(b) for b in rest) == 70
    np.testing.assert_array_equal(rest[0].users[:5], np.arange(30, 35))
    c2.close()


@pytest.mark.parametrize("scheme", ["file", "shm"])
def test_seek_redelivers_identically_across_schemes(tmp_path, scheme):
    """seek() back to captured positions redelivers the same records —
    the at-least-once rewind contract, identical on file and shm."""
    loc = f"{scheme}:{tmp_path}/bus-{scheme}"
    broker = bus.get_broker(loc)
    broker.create_topic("T", 1)
    with broker.producer("T") as p:
        p.send_many([(None, f"m{i}") for i in range(50)])
    c = broker.consumer("T", from_beginning=True)
    pos0 = dict(c.positions())
    first = [km.message for km in c.poll(max_records=20, timeout=1.0)]
    assert first == [f"m{i}" for i in range(20)]
    c.seek(pos0)
    again = [km.message for km in c.poll(max_records=20, timeout=1.0)]
    assert again == first
    c.close()


def test_latest_and_earliest_offsets(tmp_path):
    broker = make_broker(tmp_path)
    broker.create_topic("T", 1)
    assert broker.latest_offsets("T") == {0: 0}
    u = np.arange(10, dtype=np.int32)
    with broker.producer("T") as p:
        p.send_interactions(u, u, u.astype(np.float32))
    assert broker.latest_offsets("T") == {0: 10}
    assert broker.earliest_offsets("T") == {0: 0}


def test_oversized_frame_rejected(tmp_path):
    """One frame larger than half the ring can never fit: explicit error,
    not a deadlock. (send_interactions chunks under this bound itself;
    a single huge TEXT record cannot be split.)"""
    broker = make_broker(tmp_path, ring_bytes=1 << 17)
    broker.create_topic("T", 1)
    with broker.producer("T") as p:
        with pytest.raises(ValueError, match="exceeds half"):
            p.send(None, "x" * (1 << 18))


# -- tests/lambda_/test_speed_pipeline.py, over the ring ------------------------


def test_pipeline_staged_als_over_shm(tmp_path):
    """Full integration: typed columnar frames over the shm ring, staged
    parse/fold on the pipeline workers, deltas published and offsets
    committed: the shm transport's wiring end to end."""
    broker_loc = f"shm:{tmp_path}/pipebus?ring_mb=4"
    from oryx_tpu_torch.app import pmml as app_pmml
    from oryx_tpu_torch.common import pmml as pmml_io

    root = pmml_io.build_skeleton_pmml()
    app_pmml.add_extension(root, "features", 2)
    app_pmml.add_extension(root, "implicit", "true")
    app_pmml.add_extension_content(root, "XIDs", ["u1", "u2"])
    app_pmml.add_extension_content(root, "YIDs", ["i1", "i2"])
    model_msg = pmml_io.to_string(root)

    cfg = C.get_default().with_overlay(
        f"""
        oryx {{
          id = "ShmPipeIT"
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          speed {{
            streaming.generation-interval-sec = 1
            model-manager-class = "oryx_tpu_torch.app.als.speed:ALSSpeedModelManager"
            pipeline.enabled = true
            pipeline.min-batch-ms = 50
            min-model-load-fraction = 0.0
          }}
        }}
        """
    )
    layer = SpeedLayer(cfg)
    layer.init_topics()
    broker = bus.get_broker(broker_loc)
    with broker.producer("OryxUpdate") as p:
        p.send("MODEL", model_msg)
        p.send("UP", '["X","u1",[1.0,0.1]]')
        p.send("UP", '["X","u2",[0.2,1.0]]')
        p.send("UP", '["Y","i1",[0.9,0.3]]')
        p.send("UP", '["Y","i2",[0.4,0.8]]')
    layer.start()
    try:
        assert wait_until(
            lambda: layer.manager.model is not None
            and layer.manager.model.x.size() == 2
        )
        tail = broker.consumer("OryxUpdate")  # latest: skip the seeding
        with broker.producer("OryxInput") as p:
            p.send_interactions(
                np.array([1, 2], np.int32),
                np.array([2, 1], np.int32),
                np.array([3.0, 2.0], np.float32),
            )
        assert wait_until(lambda: layer.batch_count >= 1)
        ups = tail.poll(max_records=100, timeout=5.0)
        assert len(ups) == 4  # X u1, X u2, Y i1, Y i2
        ids = sorted(m.message.split(",")[0].strip('["]') for m in ups)
        assert " ".join(ids).count("X") == 2 and " ".join(ids).count("Y") == 2
        assert wait_until(
            lambda: sum(
                broker.get_offsets(layer.group_id, "OryxInput").values()
            ) >= 2
        )
    finally:
        layer.close()


def seed_als_model(broker):
    """Publish a 2-feature implicit ALS model + vectors on OryxUpdate."""
    from oryx_tpu_torch.app import pmml as app_pmml
    from oryx_tpu_torch.common import pmml as pmml_io

    root = pmml_io.build_skeleton_pmml()
    app_pmml.add_extension(root, "features", 2)
    app_pmml.add_extension(root, "implicit", "true")
    app_pmml.add_extension_content(root, "XIDs", ["u1", "u2"])
    app_pmml.add_extension_content(root, "YIDs", ["i1", "i2"])
    with broker.producer("OryxUpdate") as p:
        p.send("MODEL", pmml_io.to_string(root))
        p.send("UP", '["X","u1",[1.0,0.1]]')
        p.send("UP", '["X","u2",[0.2,1.0]]')
        p.send("UP", '["Y","i1",[0.9,0.3]]')
        p.send("UP", '["Y","i2",[0.4,0.8]]')


def sharded_als_config(broker_loc, oryx_id, shards=2, extra=""):
    return C.get_default().with_overlay(
        f"""
        oryx {{
          id = "{oryx_id}"
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          speed {{
            streaming.generation-interval-sec = 1
            model-manager-class = "oryx_tpu_torch.app.als.speed:ALSSpeedModelManager"
            pipeline.enabled = true
            pipeline.min-batch-ms = 50
            pipeline.shards = {shards}
            min-model-load-fraction = 0.0
            {extra}
          }}
        }}
        """
    )


def test_sharded_pipeline_staged_als_over_shm(tmp_path):
    """Two independent parse->fold->publish chains over disjoint partition
    subsets of the shm ring: updates flow, per-shard commits merge, both
    shards' counters account for every event."""
    from oryx_tpu_torch.common import metrics

    broker_loc = f"shm:{tmp_path}/shardbus?ring_mb=4"
    layer = SpeedLayer(sharded_als_config(broker_loc, "ShardIT"))
    layer.init_topics()
    broker = bus.get_broker(broker_loc)
    seed_als_model(broker)
    s0_0 = metrics.registry.counter("speed.pipeline.shard.0.events").value
    s1_0 = metrics.registry.counter("speed.pipeline.shard.1.events").value
    layer.start()
    try:
        assert layer._pipeline.shards == 2
        names = sorted(t.name for t in layer._pipeline.threads)
        assert sum(n.endswith("-0") for n in names) == 3
        assert sum(n.endswith("-1") for n in names) == 3
        assert wait_until(
            lambda: layer.manager.model is not None
            and layer.manager.model.x.size() == 2
        )
        tail = broker.consumer("OryxUpdate")  # latest: skip the seeding
        with broker.producer("OryxInput") as p:
            for j in range(40):
                # keys spread rows over the input partitions -> both shards
                p.send(f"u{(j % 2) + 1}", f"u{(j % 2) + 1},i{(j % 2) + 1},1.0,{j}")
        assert wait_until(lambda: layer.batch_count >= 1)
        assert wait_until(
            lambda: sum(
                broker.get_offsets(layer.group_id, "OryxInput").values()
            ) >= 40
        )
        ups = tail.poll(max_records=200, timeout=5.0)
        assert len(ups) >= 2  # folded X/Y deltas made it out
        s0 = metrics.registry.counter("speed.pipeline.shard.0.events").value - s0_0
        s1 = metrics.registry.counter("speed.pipeline.shard.1.events").value - s1_0
        assert s0 + s1 >= 40  # every event accounted to a shard
        assert s0 > 0 and s1 > 0  # ... and both shards actually worked
    finally:
        layer.close()


def test_sharded_pipeline_at_least_once_under_chaos(tmp_path):
    """Sharded pipeline over fault+shm with delivery drop/dup: every input
    partition's offsets are eventually committed (nothing lost, commits
    still strictly after publish), and the pipeline stays healthy."""
    inner_loc = f"shm:{tmp_path}/chaosbus"
    broker_loc = f"fault+{inner_loc}?drop=0.15&dup=0.1&seed=5"
    layer = SpeedLayer(sharded_als_config(broker_loc, "ShardChaosIT"))
    layer.init_topics()
    inner = bus.get_broker(inner_loc)
    seed_als_model(inner)  # seed un-faulted: chaos is on the layer's side
    layer.start()
    try:
        assert wait_until(
            lambda: layer.manager.model is not None
            and layer.manager.model.x.size() == 2
        )
        with inner.producer("OryxInput") as p:
            for j in range(60):
                p.send(f"u{(j % 2) + 1}", f"u{(j % 2) + 1},i{(j % 2) + 1},1.0,{j}")
        latest = inner.latest_offsets("OryxInput")
        assert wait_until(
            lambda: layer.batch_count >= 1
            and inner.get_offsets(layer.group_id, "OryxInput") == latest,
            timeout=30.0,
        ), (inner.get_offsets(layer.group_id, "OryxInput"), latest)
        assert all(t.is_alive() for t in layer._pipeline.threads)
    finally:
        layer.close()


# -- rings across the packages --------------------------------------------------


def _send_script(broker, topic="T"):
    """One fixed sequence of TEXT and COLS frames over two partitions."""
    broker.create_topic(topic, 2)
    users = np.arange(300, dtype=np.int32)
    with broker.producer(topic) as p:
        p.send("MODEL", "line one\nline two")
        p.send_many([(f"k{j}", f"m{j},{j * 7}") for j in range(40)])
        p.send_interactions(users, users % 97, (users / 3.0).astype(np.float32),
                            timestamps=np.arange(300, dtype=np.int64) + 1_700_000_000_000)
        p.send_interactions(users[:50], users[:50], np.ones(50, np.float32), partition=1)
        p.send(None, "tail")


def _read_blocks(broker, topic="T", group=None):
    """Every block from the start, as plain values: (kind, columns), and
    the positions after."""
    c = broker.consumer(topic, group=group, from_beginning=True)
    out = []
    while True:
        b = c.poll_block(max_records=1000, timeout=0.2)
        if b is None:
            break
        if hasattr(b, "users"):
            out.append(("cols", b.users.tolist(), b.items.tolist(), b.values.tolist(),
                        None if b.timestamps is None else b.timestamps.tolist()))
        else:
            out.append(("text", [None if k is None else bytes(k) for k in b.keys.tolist()]
                        if b.keys is not None else None, [bytes(m) for m in b.messages]))
    positions = dict(c.positions())
    if group is not None:
        c.commit()
    c.close()
    return out, positions


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rings_read_across_packages(tmp_path, writer):
    root = str(tmp_path / "bus")
    jax_broker = jax_shmbus.ShmBroker(root, ring_bytes=1 << 20)
    port_broker = ShmBroker(root, ring_bytes=1 << 20)
    write, read = (jax_broker, port_broker) if writer == "jax" else (port_broker, jax_broker)
    _send_script(write)
    got_read, pos_read = _read_blocks(read, group="readers")
    got_write, pos_write = _read_blocks(write)
    assert got_read == got_write
    assert sum(len(b[1]) if b[0] == "cols" else len(b[2]) for b in got_read) == 1 + 40 + 300 + 50 + 1
    assert pos_read == pos_write
    assert read.latest_offsets("T") == write.latest_offsets("T")
    assert read.earliest_offsets("T") == write.earliest_offsets("T")
    # the group the reader committed is the writer's to resume, and the
    # reader's appends land where the writer reads them
    assert write.get_offsets("readers", "T") == pos_read
    with read.producer("T") as p:
        p.send_interactions(np.array([5], np.int32), np.array([6], np.int32),
                            np.array([7.0], np.float32))
    c = write.consumer("T", group="readers")
    late = c.poll_block(max_records=10, timeout=1.0)
    c.close()
    assert late.users.tolist() == [5] and late.items.tolist() == [6]


def test_identical_sends_leave_identical_rings(tmp_path):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    _send_script(jax_shmbus.ShmBroker(str(jax_root), ring_bytes=1 << 20))
    _send_script(ShmBroker(str(port_root), ring_bytes=1 << 20))
    for part in (0, 1):
        a = (jax_root / "T" / f"partition-{part}.ring").read_bytes()
        b = (port_root / "T" / f"partition-{part}.ring").read_bytes()
        assert len(a) == len(b) == shmbus._HEADER_PAGE + (1 << 20)
        assert a[shmbus._HEADER_PAGE:] == b[shmbus._HEADER_PAGE:]  # the data region
        assert a[: shmbus._SLOTS_OFF] == b[: shmbus._SLOTS_OFF]  # the header words


def _tear_and_read(root, broker_cls, metrics_mod, tear):
    broker = broker_cls(str(root), ring_bytes=1 << 20)
    broker.create_topic("T", 1)
    with broker.producer("T") as p:
        for start in (0, 10, 20):
            u = np.arange(start, start + 10, dtype=np.int32)
            p.send_interactions(u, u, u.astype(np.float32))
    tear(root / "T" / "partition-0.ring")
    before = metrics_mod.registry.counter("bus.shm.crc-resyncs").value
    broker = broker_cls(str(root), ring_bytes=1 << 20)  # a fresh open: repair-on-open
    got, _ = _read_blocks(broker)
    return got, metrics_mod.registry.counter("bus.shm.crc-resyncs").value - before


@pytest.mark.parametrize("tear", [
    "garble_shm_frame",  # the newest unconsumed frame's payload
    "flip_first_payload",  # the first frame's payload, past its 32-byte header
    "garble_shm_header",  # impossible head/tail geometry: fsck on open
])
def test_torn_frames_skipped_like_the_jax_package(tmp_path, tear):
    def tearer(mod):
        if tear == "flip_first_payload":
            return lambda path: mod.flip_byte(
                path, shmbus._HEADER_PAGE + shmbus.blockcodec.HEADER_BYTES + 8, 4)
        return getattr(mod, tear)

    ours = _tear_and_read(tmp_path / "port", ShmBroker, metrics, tearer(corruption))
    ref = _tear_and_read(tmp_path / "jax", jax_shmbus.ShmBroker, jax_metrics,
                         tearer(jax_corruption))
    assert ours == ref
    got, resyncs = ours
    if tear == "garble_shm_header":
        assert got == [] and resyncs == 0  # the ring was reset on open
    else:
        assert resyncs == 1 and sum(len(b[1]) for b in got) == 20


# -- a lagging speed layer over a wrapping ring ------------------------------------

WRAP_USERS, WRAP_ITEMS, WRAP_FEATURES = 60, 40, 4


def _wrapping_run(pkg, tmp_path):
    """The speed layer of package ``pkg`` folding events off a 256 KiB shm
    ring, its micro-batches capped at 3,000 events while the producer sends
    4,000 per round: the consumer lags, the producer blocks on the full
    ring and waits for a batch. Returns the published UP messages in order
    and the ring's head."""
    if pkg == "jax":
        from oryx_tpu import bus as bus_mod
        from oryx_tpu.common import config as cfg_mod
        from oryx_tpu.common import pmml as pmml_mod
        from oryx_tpu.app import pmml as app_pmml
        from oryx_tpu.lambda_.speed import SpeedLayer as Layer
        prefix = "oryx_tpu"
    else:
        from oryx_tpu_torch import bus as bus_mod
        from oryx_tpu_torch.common import config as cfg_mod
        from oryx_tpu_torch.common import pmml as pmml_mod
        from oryx_tpu_torch.app import pmml as app_pmml
        Layer = SpeedLayer
        prefix = "oryx_tpu_torch"
    shm_loc = f"shm:{tmp_path}/{pkg}-ring?ring_bytes={1 << 18}&full_block_ms=20"
    upd_loc = f"inproc://wrap-{pkg}"
    gen = np.random.default_rng(5)
    root = pmml_mod.build_skeleton_pmml()
    app_pmml.add_extension(root, "features", WRAP_FEATURES)
    app_pmml.add_extension(root, "implicit", "true")
    app_pmml.add_extension_content(root, "XIDs", [f"u{j}" for j in range(WRAP_USERS)])
    app_pmml.add_extension_content(root, "YIDs", [f"i{j}" for j in range(WRAP_ITEMS)])
    x = gen.standard_normal((WRAP_USERS, WRAP_FEATURES)).astype(np.float32)
    y = gen.standard_normal((WRAP_ITEMS, WRAP_FEATURES)).astype(np.float32)
    upd = bus_mod.get_broker(upd_loc)
    upd.create_topic("OryxUpdate", 1)
    with upd.producer("OryxUpdate") as p:
        p.send("MODEL", pmml_mod.to_string(root))
        p.send_many([("UP", f'["X","u{j}",{x[j].tolist()}]') for j in range(WRAP_USERS)])
        p.send_many([("UP", f'["Y","i{j}",{y[j].tolist()}]') for j in range(WRAP_ITEMS)])
    cfg = cfg_mod.get_default().with_overlay(f"""
        oryx {{
          id = "Wrap"
          input-topic {{ broker = "{shm_loc}", message.partitions = 1 }}
          update-topic.broker = "{upd_loc}"
          als.hyperparams.features = {WRAP_FEATURES}
          speed {{
            streaming.generation-interval-sec = 3600
            streaming.max-batch-events = 3000
            model-manager-class = "{prefix}.app.als.speed:ALSSpeedModelManager"
            fold-in-backend = "host"
          }}
        }}""")
    layer = Layer(cfg)
    layer.start()
    tail = upd.consumer("OryxUpdate")
    try:
        assert wait_until(lambda: layer.manager.model is not None
                          and layer.manager.model.get_fraction_loaded() >= 1.0)
        shm = bus_mod.get_broker(shm_loc)
        ev = np.random.default_rng(6)
        n_rounds, per_round, blocked = 60, 4000, 0
        with shm.producer("OryxInput") as p:
            for _ in range(n_rounds):
                u = ev.integers(0, WRAP_USERS, per_round).astype(np.int32)
                i = ev.integers(0, WRAP_ITEMS, per_round).astype(np.int32)
                v = ev.integers(1, 4, per_round).astype(np.float32)
                while True:
                    try:
                        p.send_interactions(u, i, v)
                        break
                    except BlockingIOError:
                        blocked += 1
                        layer.run_one_batch()
                layer.run_one_batch()
        while layer.run_one_batch():
            pass
        ups = []
        while True:
            got = tail.poll(max_records=10_000, timeout=0.2)
            if not got:
                break
            ups.extend(km.message for km in got if km.key == "UP")
        head = shm._ring("OryxInput", 0).u64(shmbus._OFF_HEAD)
        group = layer.group_id
        committed = sum(shm.get_offsets(group, "OryxInput").values())
    finally:
        tail.close()
        layer.close()
    return ups, head, blocked, committed


def test_lagging_speed_layer_over_a_wrapping_ring_matches_the_jax_package(tmp_path):
    import json

    ours, head, blocked, committed = _wrapping_run("port", tmp_path)
    ref, ref_head, ref_blocked, ref_committed = _wrapping_run("jax", tmp_path)
    assert head == ref_head and head >= 10 * (1 << 18)  # the ring wrapped ten times over
    assert blocked == ref_blocked and blocked > 0  # the producer waited on the lagging consumer
    assert committed == ref_committed == 60 * 4000
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        a, b = json.loads(a), json.loads(b)
        assert a[:2] == b[:2] and a[3:] == b[3:]
        np.testing.assert_allclose(a[2], b[2], rtol=1e-4, atol=1e-5)


def test_parsed_batch_outlives_the_ring_views(tmp_path):
    """The staged parse copies out of the ring: a RatingMatrix built from
    zero-copy blocks stays right after release() lets the producer wrap
    the ring over the bytes those blocks viewed."""
    from oryx_tpu_torch.app.als.speed import ALSSpeedModelManager
    from oryx_tpu_torch.common.records import BlockRecords

    broker = ShmBroker(str(tmp_path / "bus"), ring_bytes=1 << 17, full_block_ms=50.0)
    broker.create_topic("T", 1)
    gen = np.random.default_rng(3)
    cols = [(gen.integers(0, 500, 2000).astype(np.int32),
             gen.integers(0, 300, 2000).astype(np.int32),
             gen.integers(1, 5, 2000).astype(np.float32)) for _ in range(3)]
    mgr = ALSSpeedModelManager(C.get_default())
    c = broker.consumer("T", from_beginning=True)
    with broker.producer("T") as p:
        for u, i, v in cols:
            p.send_interactions(u, i, v)
        c.pin()
        blocks = []
        while True:
            b = c.poll_block(max_records=100_000, timeout=0.2)
            if b is None:
                break
            blocks.append(b)
        assert not blocks[0].users.flags.owndata  # views over the ring
        parsed = mgr.parse_batch(BlockRecords(blocks))
        want = mgr.parse_batch(BlockRecords([b.materialize() for b in blocks]))
        c.release()
        # several ring-fulls of other events over the same bytes
        for _ in range(40):
            z = np.full(2000, 7, np.int32)
            p.send_interactions(z, z, np.full(2000, 9.0, np.float32))
            while c.poll_block(max_records=100_000, timeout=0.01) is not None:
                pass
    head = broker._ring("T", 0).u64(shmbus._OFF_HEAD)
    assert head > 4 * (1 << 17)
    for name in ("user_ids", "item_ids"):
        assert getattr(parsed, name) == getattr(want, name)
    for name in ("user_idx", "item_idx", "values"):
        np.testing.assert_array_equal(getattr(parsed, name), getattr(want, name))
    c.close()
