"""The port's fault bus (oryx_tpu_torch.bus.faultbus) on the CPU.

The port's counterpart of tests/bus/test_faultbus.py (seeded drop, delay
and dup over the inproc, file and shm buses, connect-failure budgets,
outages, levers and scheduled phases), and the fault schedule held
against the JAX package's: one ``fault+inproc://`` locator and one
traffic, sent through each package over its own in-proc broker, give the
same delivered sequences, the same exceptions on the same sends and the
same ``bus.fault.*`` counts, since both draw every fault from one
``np.random.default_rng(seed)``.
"""

import time

import pytest

from oryx_tpu import bus as jax_bus
from oryx_tpu.bus import faultbus as jax_faultbus
from oryx_tpu.common import metrics as jax_metrics
from oryx_tpu_torch import bus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus import faultbus
from oryx_tpu_torch.bus.faultbus import FaultBroker, get_state, set_outage
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import metrics


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    faultbus.reset()
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    faultbus.reset()


def _drain(consumer, want, timeout=10.0, max_records=1000):
    """Poll until `want` messages arrive (drops redeliver, so this must
    terminate); returns the messages in arrival order."""
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < want and time.monotonic() < deadline:
        got.extend(km.message for km in consumer.poll(max_records, timeout=0.05))
    return got


def _produce_all(producer, records, timeout=10.0):
    """send_many with retry around injected transient produce failures."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return producer.send_many(records)
        except ConnectionError:
            if time.monotonic() >= deadline:
                raise


@pytest.fixture(params=["inproc", "file", "shm"])
def inner_locator(request, tmp_path):
    if request.param == "inproc":
        return "inproc://fault-under-test"
    if request.param == "shm":
        # block-framed transport: chaos levers must hold on columnar
        # frames exactly as they do on line-framed buses
        return f"shm:{tmp_path}/bus"
    return f"file:{tmp_path}/bus"


def test_fault_locator_resolves_via_get_broker(inner_locator):
    broker = bus.get_broker(f"fault+{inner_locator}?drop=0.5&seed=1")
    assert isinstance(broker, FaultBroker)
    broker.create_topic("T", 1)
    assert broker.topic_exists("T")  # admin passes through un-faulted


def test_at_least_once_under_drop_and_dup(inner_locator):
    loc = f"fault+{inner_locator}?drop=0.2&dup=0.1&seed=7"
    broker = bus.get_broker(loc)
    broker.create_topic("T", 1)
    msgs = [f"m{j}" for j in range(40)]
    with broker.producer("T") as p:
        for m in msgs:  # one roll per send: plenty of injected failures
            _produce_all(p, [(None, m)])
    c = broker.consumer("T", from_beginning=True)
    got = _drain(c, want=40, timeout=20.0)
    # at-least-once: every message arrives; dups allowed, loss is not
    assert set(msgs).issubset(set(got))
    c.close()
    st = get_state(loc)
    assert st.injected_errors > 0 or st.dropped_records > 0  # chaos actually ran


def test_poll_drop_rewinds_and_redelivers(inner_locator):
    loc = f"fault+{inner_locator}?drop=0.5&seed=3"
    broker = bus.get_broker(loc)
    broker.create_topic("T", 1)
    with broker.producer("T") as p:
        _produce_all(p, [(None, f"r{j}") for j in range(10)])
    c = broker.consumer("T", from_beginning=True)
    # one record per poll = one drop roll per record: at drop=0.5 some of
    # the >= 10 rolls inject a drop
    got = _drain(c, want=10, timeout=20.0, max_records=1)
    assert got.count("r0") >= 1 and set(got) == {f"r{j}" for j in range(10)}
    assert get_state(loc).dropped_records > 0
    c.close()


def test_same_seed_same_fault_schedule(inner_locator):
    """Determinism: with one consumer driving all rolls, the same seed
    yields the same drop pattern (the property chaos e2e relies on)."""

    def run(tag):
        faultbus.reset()
        loc = f"fault+{inner_locator}?drop=0.4&seed=11"
        broker = bus.get_broker(loc)
        topic = f"D{tag}"
        broker.create_topic(topic, 1)
        with bus.get_broker(inner_locator).producer(topic) as p:  # un-faulted feed
            p.send_many([(None, f"x{j}") for j in range(12)])
        c = broker.consumer(topic, from_beginning=True)
        pattern = []
        for _ in range(40):
            batch = c.poll(max_records=1, timeout=0.05)
            pattern.append(len(batch))
            if sum(pattern) >= 12:
                break
        c.close()
        return pattern

    assert run("a") == run("b")


def test_delay_adds_latency():
    loc = "fault+inproc://fault-delay?delay_ms=50&seed=0"
    broker = bus.get_broker(loc)
    broker.create_topic("T", 1)
    with broker.producer("T") as p:
        t0 = time.monotonic()
        p.send_many([(None, "slow")])
        assert time.monotonic() - t0 >= 0.05


def test_fail_connect_budget():
    loc = "fault+inproc://fault-conn?fail_connect=2&seed=0"
    broker = bus.get_broker(loc)
    broker.create_topic("T", 1)
    with pytest.raises(ConnectionError):
        broker.producer("T")
    with pytest.raises(ConnectionError):
        broker.consumer("T")
    # budget spent: connections succeed from now on
    with broker.producer("T") as p:
        p.send(None, "through")
    c = broker.consumer("T", from_beginning=True)
    assert _drain(c, want=1) == ["through"]
    c.close()


def test_programmatic_outage_lever():
    loc = "fault+inproc://fault-outage?seed=0"
    broker = bus.get_broker(loc)
    broker.create_topic("T", 1)
    producer = broker.producer("T")
    consumer = broker.consumer("T", from_beginning=True)
    producer.send(None, "before")
    assert _drain(consumer, want=1) == ["before"]

    set_outage(loc, True)
    with pytest.raises(ConnectionError):
        producer.send(None, "during")
    with pytest.raises(ConnectionError):
        consumer.poll(timeout=0.05)

    set_outage(loc, False)
    producer.send(None, "after")
    assert _drain(consumer, want=1) == ["after"]
    producer.close()
    consumer.close()


def test_fault_state_shared_across_get_broker_calls():
    loc = "fault+inproc://fault-shared?fail_connect=1&seed=0"
    b1 = bus.get_broker(loc)
    b2 = bus.get_broker(loc)
    b1.create_topic("T", 1)
    with pytest.raises(ConnectionError):
        b1.producer("T")
    # the budget was consumed by b1: b2 sees the same (exhausted) schedule
    with b2.producer("T") as p:
        p.send(None, "ok")


def test_unknown_query_keys_pass_through_to_inner(tmp_path):
    """Non-fault query params stay on the inner locator (e.g. a netbus
    connect_timeout travels through the fault+ wrapper)."""
    from oryx_tpu_torch.bus.faultbus import _split_locator

    inner, params, canon = _split_locator(
        "fault+tcp://h:1234?connect_timeout=5&drop=0.1&seed=2"
    )
    assert inner == "tcp://h:1234?connect_timeout=5"
    assert params == {"drop": "0.1", "seed": "2"}
    assert "drop=0.1" in canon and "connect_timeout" not in canon


# -- scenario scripting (the fleet harness's chaos control surface) ----------


def test_set_levers_reconfigures_mid_run():
    locator = "fault+inproc://levers?drop=0&seed=1"
    broker = bus.get_broker(locator)
    broker.create_topic("t", 1)
    with broker.producer("t") as p:
        p.send("k", "m0")  # drop=0: always succeeds
        faultbus.set_levers(locator, drop=1.0)
        with pytest.raises(ConnectionError):
            p.send("k", "m1")
        faultbus.set_levers(locator, drop=0.0)
        p.send("k", "m2")
    # outage lever works through the same surface
    faultbus.set_levers(locator, outage=True)
    with broker.producer("t") as p:
        with pytest.raises(ConnectionError, match="outage"):
            p.send("k", "m3")
    faultbus.set_levers(locator, outage=False)


def test_scheduled_phases_apply_lazily_on_data_path():
    """A timed chaos window: phases arm levers at offsets, applied by the
    data path's own consultations — no scheduler thread, deterministic
    under an injected clock."""
    locator = "fault+inproc://phases?seed=2"
    state = get_state(locator)
    clock_t = [0.0]
    faultbus.schedule_phases(
        locator,
        [
            {"at": 5.0, "drop": 1.0},
            {"at": 1.0, "delay_ms": 0.0, "dup": 0.5},  # out of order on purpose
        ],
        clock=lambda: clock_t[0],
    )
    assert state.phases_applied == 0
    state.roll()  # t=0: nothing due
    assert state.phases_applied == 0 and state.drop == 0.0
    clock_t[0] = 1.5  # first phase due
    state.roll()
    assert state.phases_applied == 1
    assert state.dup == 0.5 and state.drop == 0.0
    clock_t[0] = 6.0  # second phase due
    state.check_outage("poll")  # outage checks also tick the schedule
    assert state.phases_applied == 2
    assert state.drop == 1.0


def test_scheduled_phases_drive_real_traffic():
    locator = "fault+inproc://phasetraffic?seed=3"
    broker = bus.get_broker(locator)
    broker.create_topic("t", 1)
    clock_t = [0.0]
    faultbus.schedule_phases(
        locator, [{"at": 1.0, "drop": 1.0}], clock=lambda: clock_t[0]
    )
    with broker.producer("t") as p:
        p.send("k", "before")  # phase not due: clean
        clock_t[0] = 2.0
        with pytest.raises(ConnectionError):
            p.send("k", "during")


def test_chaos_levers_on_block_framed_transport(tmp_path):
    """drop + dup over typed columnar shm frames: the rewind lever works
    through seek() on record seqnos (mid-frame positions included) and
    the dup stash holds materialized copies, so at-least-once holds with
    zero-copy blocks exactly as it does line-framed."""
    import numpy as np

    loc = f"fault+shm:{tmp_path}/bus?drop=0.25&dup=0.15&seed=13"
    broker = bus.get_broker(loc)
    broker.create_topic("t", 1)
    consumer = broker.consumer("t", from_beginning=True)
    n = 5000
    with broker.producer("t") as p:
        _send_retry(
            p,
            None,
            users=np.arange(n, dtype=np.int32),
            items=np.arange(n, dtype=np.int32) % 97,
            values=np.arange(n, dtype=np.float32),
        )
    got = []
    deadline = time.monotonic() + 20.0
    while len(set(got)) < n and time.monotonic() < deadline:
        block = consumer.poll_block(max_records=2000, timeout=0.05)
        if block is None:
            continue
        # typed blocks surface users/items/values columns directly
        assert hasattr(block, "users")
        got.extend(block.users.tolist())
    assert set(got) == set(range(n))  # complete despite drops
    assert len(got) >= n  # dups redeliver, never silently vanish
    consumer.close()


def _send_retry(producer, _key, users, items, values, timeout=10.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            return producer.send_interactions(users, items, values)
        except ConnectionError:
            if time.monotonic() >= deadline:
                raise


def test_scheduled_phases_on_block_framed_transport(tmp_path):
    """schedule_phases arms levers on a block-framed bus: a drop phase
    triggers the ConnectionError/rewind path mid-columnar-stream."""
    import numpy as np

    loc = f"fault+shm:{tmp_path}/bus?seed=5"
    broker = bus.get_broker(loc)
    broker.create_topic("t", 1)
    clock_t = [0.0]
    faultbus.schedule_phases(
        loc, [{"at": 1.0, "drop": 1.0}], clock=lambda: clock_t[0]
    )
    cols = (
        np.arange(10, dtype=np.int32),
        np.arange(10, dtype=np.int32),
        np.ones(10, dtype=np.float32),
    )
    with broker.producer("t") as p:
        p.send_interactions(*cols)  # phase not due: clean
        clock_t[0] = 2.0
        with pytest.raises(ConnectionError):
            p.send_interactions(*cols)


def test_partition_subset_consumers_at_least_once_under_chaos(inner_locator):
    """Two consumers owning disjoint partition subsets (the sharded speed
    pipeline's consumer shape) under drop/dup faults: every record still
    arrives at its owner, and their disjoint commits merge in the ledger
    without clobbering each other."""
    loc = f"fault+{inner_locator}?drop=0.2&dup=0.1&seed=13"
    broker = bus.get_broker(loc)
    broker.create_topic("S", 4)
    msgs = [(f"k{j}", f"m{j}") for j in range(40)]
    with broker.producer("S") as p:
        for rec in msgs:
            _produce_all(p, [rec])
    # ground truth per subset from un-faulted consumers (producer-side dup
    # faults write real duplicate records, so the log is authoritative)
    inner = bus.get_broker(inner_locator)
    latest = inner.latest_offsets("S")

    def truth(parts):
        c = inner.consumer("S", from_beginning=True, partitions=parts)
        want = sum(latest.get(p, 0) for p in parts)
        out = _drain(c, want=want, timeout=10.0)
        c.close()
        return set(out)

    want0, want1 = truth([0, 2]), truth([1, 3])
    c0 = broker.consumer("S", group="g", from_beginning=True, partitions=[0, 2])
    c1 = broker.consumer("S", group="g", from_beginning=True, partitions=[1, 3])

    def drain_unique(consumer, want, timeout=20.0):
        # dups inflate raw counts; drops redeliver — poll until every
        # distinct record owned by this consumer has arrived
        got = set()
        deadline = time.monotonic() + timeout
        while not want.issubset(got) and time.monotonic() < deadline:
            got.update(km.message for km in consumer.poll(1000, timeout=0.05))
        return got

    got0 = drain_unique(c0, want0)
    got1 = drain_unique(c1, want1)
    assert got0 == want0 and got1 == want1
    assert got0.isdisjoint(got1)  # disjoint ownership held under faults
    c0.commit()
    c1.commit()
    merged = broker.get_offsets("g", "S")
    assert merged == latest  # both subsets landed; neither clobbered the other
    c0.close()
    c1.close()


# -- the fault schedule, against the JAX package's ----------------------------

FAULT_COUNTERS = ("dropped", "duplicated", "injected-errors")


def _scripted_traffic(bus_mod, faultbus_mod, metrics_mod, locator):
    """One fixed script through ``locator``: 40 single-record sends (each
    one roll), then 60 polls of at most 3 records. Returns what each send
    did, what each poll delivered, the bus.fault.* counter deltas and the
    fault state's own counts."""
    faultbus_mod.reset()
    before = {n: metrics_mod.registry.counter(f"bus.fault.{n}").value for n in FAULT_COUNTERS}
    broker = bus_mod.get_broker(locator)
    broker.create_topic("T", 1)
    sends = []
    with broker.producer("T") as p:
        for j in range(40):
            try:
                sends.append(("sent", p.send_many([(f"k{j % 3}", f"m{j}")])))
            except ConnectionError as e:
                sends.append((type(e).__name__, str(e)))
    consumer = broker.consumer("T", from_beginning=True)
    polls = [
        [(km.key, km.message) for km in consumer.poll(max_records=3, timeout=0.01)]
        for _ in range(60)
    ]
    consumer.close()
    counts = {
        n: metrics_mod.registry.counter(f"bus.fault.{n}").value - before[n]
        for n in FAULT_COUNTERS
    }
    st = faultbus_mod.get_state(locator)
    return sends, polls, counts, (st.rolls, st.dropped_records, st.duplicated_records,
                                  st.injected_errors)


@pytest.mark.parametrize("query", [
    "drop=0.3&seed=11",
    "drop=0.2&dup=0.2&seed=7",
    "dup=0.5&delay_ms=1&seed=3",
])
def test_fault_schedule_matches_the_jax_package(query):
    locator = f"fault+inproc://schedule?{query}"
    port = _scripted_traffic(bus, faultbus, metrics, locator)
    ref = _scripted_traffic(jax_bus, jax_faultbus, jax_metrics, locator)
    sends, polls, counts, state = port
    assert sends == ref[0]
    assert polls == ref[1]
    assert counts == ref[2]
    assert state == ref[3]
    # the script did meet faults, and every record came through
    assert state[0] > 0 and sum(counts.values()) > 0
    delivered = {m for batch in polls for _, m in batch}
    assert delivered == {f"m{j}" for j, s in enumerate(sends) if s[0] == "sent"}


def test_fault_state_draws_match_the_jax_package():
    """The levers' state: the same seed, the same draws, the same phases."""
    loc = "fault+inproc://draws?drop=0.25&dup=0.1&seed=9"
    ours, ref = faultbus.get_state(loc), jax_faultbus.get_state(loc)
    assert [ours.roll() for _ in range(100)] == [ref.roll() for _ in range(100)]
    for mod in (faultbus, jax_faultbus):
        mod.set_levers(loc, drop=0.5, dup=0.0)
    assert (ours.drop, ours.dup, ours.delay) == (ref.drop, ref.dup, ref.delay)
    assert faultbus._split_locator(loc) == jax_faultbus._split_locator(loc)


def test_get_broker_resolves_every_fault_inner(tmp_path):
    for inner in ("inproc://x", f"file:{tmp_path}/f", f"shm:{tmp_path}/s"):
        broker = bus.get_broker(f"fault+{inner}?drop=0.1&seed=1")
        assert isinstance(broker, FaultBroker)
        assert type(broker._inner).__module__.startswith("oryx_tpu_torch.bus.")
