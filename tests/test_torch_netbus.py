"""The port's TCP bus (oryx_tpu_torch.bus.netbus) on the CPU.

The port's counterpart of tests/bus/test_netbus.py (the Broker SPI over
sockets, group offsets across clients, a speed layer on a ``tcp://``
locator, dedicated consumer channels) and of the netbus case of
tests/lambda_/test_resilience_e2e.py (a client resuming across a server
restart), and the wire held against the JAX package's both ways: the
JAX package's client against the port's ``BusServer`` and the port's
client against the JAX package's, with records and group offsets equal.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from oryx_tpu import bus as jax_bus
from oryx_tpu.bus import netbus as jax_netbus
from oryx_tpu_torch import bus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus import faultbus
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.bus.netbus import BusServer, NetBroker
from oryx_tpu_torch.common import metrics


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    faultbus.reset()
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    faultbus.reset()


def _serve(server_cls, data_dir, port=0):
    server = server_cls(("127.0.0.1", port), str(data_dir))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _stop(server):
    server.shutdown()
    server.server_close()



@pytest.fixture()
def served(tmp_path):
    server = BusServer(("127.0.0.1", 0), str(tmp_path / "busdata"))
    import threading

    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield f"tcp://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()


def test_admin_produce_consume_roundtrip(served):
    broker = bus.get_broker(served)
    assert not broker.topic_exists("T")
    broker.create_topic("T", 2)
    assert broker.topic_exists("T")
    with broker.producer("T") as p:
        p.send("k1", "hello")
        p.send_many([(None, "a,b"), ("k\ttab", "line1\nline2"), ("k1", "bye")])
    import time

    c = broker.consumer("T", from_beginning=True)
    got = []
    deadline = time.time() + 15
    while len(got) < 4 and time.time() < deadline:
        got.extend(c.poll(timeout=0.5))
    by_msg = {km.message: km.key for km in got}
    assert by_msg == {
        "hello": "k1",
        "a,b": None,
        "line1\nline2": "k\ttab",
        "bye": "k1",
    }
    assert sum(broker.latest_offsets("T").values()) == 4
    c.close()
    broker.delete_topic("T")
    assert not broker.topic_exists("T")


def test_poll_block_columnar(served):
    broker = bus.get_broker(served)
    broker.create_topic("B", 1)
    with broker.producer("B") as p:
        p.send_many(("UP", f"m{j}") for j in range(50))
    c = broker.consumer("B", from_beginning=True)
    blk = c.poll_block(max_records=100, timeout=0.5)
    assert blk is not None and len(blk) == 50
    assert blk.keys is not None
    assert blk.keys[0] == b"UP" and blk.messages[49] == b"m49"
    c.close()


def test_group_offsets_resume_across_clients(served):
    """The offset-ledger contract over the network: a committed group
    position survives the client process (here: a fresh broker/consumer),
    and uncommitted reads are re-delivered."""
    import time

    broker = bus.get_broker(served)
    broker.create_topic("G", 1)
    with broker.producer("G") as p:
        p.send_many((None, f"e{j}") for j in range(10))

    # fresh group, no stored offsets: from_beginning reads the backlog
    c1 = broker.consumer("G", group="g1", from_beginning=True)
    first = []
    deadline = time.time() + 15
    while len(first) < 4 and time.time() < deadline:
        first.extend(c1.poll(max_records=4 - len(first), timeout=0.5))
    assert len(first) == 4
    c1.commit()
    # read more but do NOT commit: these must be re-delivered
    more = c1.poll(max_records=3, timeout=0.5)
    assert more
    c1.close()
    assert broker.get_offsets("g1", "G") == {0: 4}

    # a brand-new client connection resumes from the COMMITTED offset
    # (stored offsets win; the uncommitted reads come again)
    broker2 = bus.get_broker(served)
    c2 = broker2.consumer("G", group="g1")
    rest = []
    deadline = time.time() + 15
    while len(rest) < 6 and time.time() < deadline:
        rest.extend(c2.poll(timeout=0.5))
    assert [km.message for km in first + rest] == [f"e{j}" for j in range(10)]
    c2.close()

    # explicit ledger writes round-trip too
    broker2.set_offsets("g1", "G", {0: 2})
    assert broker.get_offsets("g1", "G") == {0: 2}


def test_speed_layer_runs_over_tcp(served, tmp_path):
    """A REAL SpeedLayer against the tcp:// locator: model replay from the
    update topic, micro-batch fold-in, delta publish, offset commit."""
    from oryx_tpu_torch.app.pmml import add_extension, add_extension_content
    from oryx_tpu_torch.common import config as C
    from oryx_tpu_torch.common import pmml as pmml_io
    from oryx_tpu_torch.lambda_.speed import SpeedLayer

    broker = bus.get_broker(served)
    broker.create_topic("OryxInput", 2)
    broker.create_topic("OryxUpdate", 1)

    root = pmml_io.build_skeleton_pmml()
    add_extension(root, "features", 2)
    add_extension(root, "implicit", "true")
    add_extension_content(root, "XIDs", ["u0", "u1"])
    add_extension_content(root, "YIDs", ["i0", "i1"])
    with broker.producer("OryxUpdate") as p:
        p.send("MODEL", pmml_io.to_string(root))

    cfg = C.get_default().with_overlay(
        f"""
        oryx.id = "TcpSpeed"
        oryx.speed.model-manager-class = "oryx_tpu_torch.app.als.speed:ALSSpeedModelManager"
        oryx.als.implicit = true
        oryx.als.no-known-items = true
        oryx.input-topic.broker = "{served}"
        oryx.update-topic.broker = "{served}"
        oryx.speed.streaming.generation-interval-sec = 3600
        oryx.speed.streaming.max-batch-events = 10000
        """
    )
    layer = SpeedLayer(cfg)
    layer.start()
    try:
        import time

        deadline = time.time() + 20
        while layer.manager.model is None and time.time() < deadline:
            time.sleep(0.05)
        assert layer.manager.model is not None
        m = layer.manager.model
        gen = np.random.default_rng(3)
        m.set_user_vectors(["u0", "u1"], gen.standard_normal((2, 2)).astype(np.float32))
        m.set_item_vectors(["i0", "i1"], gen.standard_normal((2, 2)).astype(np.float32))
        with broker.consumer("OryxUpdate", from_beginning=True) as tail:
            with broker.producer("OryxInput") as p:
                p.send_many((None, f"u{j % 2},i{j % 2},1.0,{j}") for j in range(40))
            deadline = time.time() + 20
            sent = 0
            while sent == 0 and time.time() < deadline:
                sent = layer.run_one_batch()
            assert sent > 0
            # the published deltas are visible to any bus subscriber
            seen = []
            deadline = time.time() + 10
            while time.time() < deadline and not any(k.key == "UP" for k in seen):
                seen.extend(tail.poll(timeout=0.5))
            assert any(k.key == "UP" for k in seen)
        # the layer committed its input offsets over the wire under its
        # consumer-group name (AbstractLayer: OryxGroup-<layer>-<id>)
        offs = bus.get_broker(served).get_offsets("OryxGroup-speed-TcpSpeed", "OryxInput")
        assert sum(offs.values()) == 40
    finally:
        layer.close()


def test_blocking_poll_does_not_stall_producer(served):
    """A consumer parked in a long server-side poll must not hold up
    produces on the same broker handle: consumers run on dedicated
    connections, so the shared producer/admin channel stays free."""
    import threading
    import time

    broker = bus.get_broker(served)
    broker.create_topic("T", 1)
    c = broker.consumer("T", group="g")
    in_poll = threading.Event()
    polled: list = []

    def poller():
        in_poll.set()
        polled.extend(c.poll(timeout=3.0))  # empty topic: blocks server-side

    t = threading.Thread(target=poller, daemon=True)
    t.start()
    assert in_poll.wait(5.0)
    time.sleep(0.2)  # let the poll request actually hit the server
    with broker.producer("T") as p:
        t0 = time.monotonic()
        p.send("k", "v")
        stalled = time.monotonic() - t0
    # on the old shared socket this waited out the remaining poll timeout
    # (~2.8s) for the I/O lock; the dedicated channels make it immediate
    assert stalled < 1.0, f"produce stalled {stalled:.2f}s behind a blocking poll"
    t.join(10.0)
    assert not t.is_alive()
    c.close()


def test_two_consumers_poll_concurrently(served):
    """Two consumers on one broker handle poll in parallel: total wall
    time for simultaneous empty polls is ~one timeout, not the serialized
    sum the single shared socket used to impose."""
    import threading
    import time

    broker = bus.get_broker(served)
    broker.create_topic("T", 1)
    consumers = [broker.consumer("T", group=f"g{i}") for i in range(2)]
    t0 = time.monotonic()
    threads = [
        threading.Thread(target=lambda c=c: c.poll(timeout=1.5), daemon=True)
        for c in consumers
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    wall = time.monotonic() - t0
    assert wall < 2.7, f"two 1.5s polls took {wall:.2f}s — serialized, not concurrent"
    for c in consumers:
        c.close()


# -- the wire across the packages --------------------------------------------------


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_wire_crosses_packages(tmp_path, server_side):
    """One package serves, the other's client produces, consumes, commits
    and reads the ledger; both clients then see the same records, offsets
    and group positions."""
    server_cls = BusServer if server_side == "port" else jax_netbus.BusServer
    server = _serve(server_cls, tmp_path / "busdata")
    try:
        loc = f"tcp://127.0.0.1:{server.server_address[1]}"
        client_bus, other_bus = (jax_bus, bus) if server_side == "port" else (bus, jax_bus)
        client, other = client_bus.get_broker(loc), other_bus.get_broker(loc)
        client.create_topic("W", 2)
        assert other.topic_exists("W")
        records = [(f"k{j % 5}", f"m{j}") for j in range(30)] + [(None, "a,b"), ("k\ttab", "l1\nl2")]
        with client.producer("W") as p:
            p.send_many(records)
        got = {}
        for name, broker in (("client", client), ("other", other)):
            c = broker.consumer("W", group=f"g-{name}", from_beginning=True)
            seen = []
            deadline = time.time() + 15
            while len(seen) < len(records) and time.time() < deadline:
                seen.extend((km.key, km.message) for km in c.poll(timeout=0.3))
            c.commit()
            c.close()
            got[name] = seen
        assert sorted(got["client"], key=repr) == sorted(got["other"], key=repr)
        assert sorted(got["client"], key=repr) == sorted(records, key=repr)
        assert client.latest_offsets("W") == other.latest_offsets("W")
        assert sum(client.latest_offsets("W").values()) == len(records)
        for g in ("g-client", "g-other"):
            assert client.get_offsets(g, "W") == other.get_offsets(g, "W") == client.latest_offsets("W")
        other.set_offsets("g-x", "W", {0: 1, 1: 2})
        assert client.get_offsets("g-x", "W") == {0: 1, 1: 2}
        # columnar polls decode the other package's wire
        c = other.consumer("W", from_beginning=True)
        n = 0
        deadline = time.time() + 15
        while n < len(records) and time.time() < deadline:
            blk = c.poll_block(1000, 0.3)
            n += 0 if blk is None else len(blk)
        c.close()
        assert n == len(records)
    finally:
        _stop(server)


def test_server_reads_the_file_bus_it_serves(tmp_path):
    """The served directory is a file bus: what the server's clients
    write, the port's FileBroker reads, and the JAX package's too."""
    from oryx_tpu.bus.filebus import FileBroker as JaxFileBroker
    from oryx_tpu_torch.bus.filebus import FileBroker

    server = _serve(BusServer, tmp_path / "busdata")
    try:
        net = bus.get_broker(f"tcp://127.0.0.1:{server.server_address[1]}")
        net.create_topic("F", 1)
        with net.producer("F") as p:
            p.send_many([("UP", f"v{j}") for j in range(12)])
    finally:
        _stop(server)
    for broker in (FileBroker(str(tmp_path / "busdata")), JaxFileBroker(str(tmp_path / "busdata"))):
        got = broker.consumer("F", from_beginning=True).poll(100, 1.0)
        assert [(km.key, km.message) for km in got] == [("UP", f"v{j}") for j in range(12)]


def test_locator_options_match_the_jax_package():
    query = ("connect_timeout=5&retry_max_attempts=100&retry_initial_backoff_ms=20"
             "&retry_max_backoff_ms=50")
    ours = NetBroker.options_from_query(query)
    ref = jax_netbus.NetBroker.options_from_query(query)
    assert ours.keys() == ref.keys() == {"connect_timeout", "retry"}
    assert ours["connect_timeout"] == ref["connect_timeout"] == 5.0
    fields = ("max_attempts", "initial_backoff", "max_backoff", "multiplier", "jitter")
    assert [getattr(ours["retry"], f) for f in fields] == [getattr(ref["retry"], f) for f in fields]


def test_client_resumes_across_a_server_restart(tmp_path):
    """The resilience suite's netbus case: the server bounced mid-stream,
    the client reconnects and its consumer resumes at its wire positions,
    with no loss and no duplicates."""
    data_dir = tmp_path / "busdata"
    server = _serve(BusServer, data_dir)
    port = server.server_address[1]
    loc = (f"tcp://127.0.0.1:{port}?connect_timeout=5"
           "&retry_max_attempts=100&retry_initial_backoff_ms=20&retry_max_backoff_ms=50")
    broker = bus.get_broker(loc)
    broker.create_topic("T", 1)
    producer = broker.producer("T")
    producer.send_many([(None, f"a{j}") for j in range(5)])
    consumer = broker.consumer("T", group="g", from_beginning=True)
    got = []
    deadline = time.monotonic() + 15
    while len(got) < 5 and time.monotonic() < deadline:
        got.extend(consumer.poll(timeout=0.2))
    reconnects_before = metrics.registry.counter("bus.net.reconnects").value
    _stop(server)
    server = _serve(BusServer, data_dir, port)
    try:
        producer.send_many([(None, f"b{j}") for j in range(5)])
        deadline = time.monotonic() + 20
        while len(got) < 10 and time.monotonic() < deadline:
            got.extend(consumer.poll(timeout=0.2))
        assert [km.message for km in got] == [f"a{j}" for j in range(5)] + [f"b{j}" for j in range(5)]
        assert consumer.poll(timeout=0.3) == []
        assert metrics.registry.counter("bus.net.reconnects").value > reconnects_before
        consumer.close()
        producer.close()
    finally:
        _stop(server)
