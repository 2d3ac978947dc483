"""The port's fleet autoscaler (``oryx_tpu_torch/serving/autoscale.py``)
against the JAX package's (``oryx_tpu/serving/autoscale.py``), on the CPU.

- ``fit_raised_cosine``: both packages' predictors agree within 1e-12
  on the same samples, recover a diurnal curve, and refuse degenerate
  sample sets alike.
- ``FleetAutoscaler.step(now)`` over one scripted trace (a diurnal ramp,
  burn-rate spikes, queue-wait spikes, refused drains and cooldowns)
  makes the same decisions in both packages: the same events at the
  same instants, for the same reasons, with the same replica counts and
  predicted rates; the port's metrics carry the JAX package's names.
- ``AutoscaleConfig.from_config`` reads the packaged defaults alike, and
  the thread drives ``step`` until stopped.
"""

import dataclasses
import math
import time

import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.serving import autoscale as jauto
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus import faultbus
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.common.ledger import ledger
from oryx_tpu_torch.serving import autoscale as tauto

FIT_ATOL = 1e-12  # the two fits run the same float operations in the same order


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    before = ledger.counts()
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    faultbus.reset()
    deadline = time.monotonic() + 5.0
    while True:
        after = ledger.counts()
        if all(after.get(k, 0) <= before.get(k, 0) for k in after) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert all(after.get(k, 0) <= before.get(k, 0) for k in after), (before, after)


def _diurnal(base, swing, period, phase=0.0):
    return lambda t: base + swing * (1.0 - math.cos(2.0 * math.pi * (t / period + phase)))


@pytest.mark.parametrize("base,swing,period,phase,step,n", [
    (50.0, 22.5, 100.0, 0.0, 2.0, 20),
    (15.0, 15.0, 14.0, 0.0, 0.25, 30),
    (200.0, 80.0, 86400.0, 0.3, 900.0, 40),
    (10.0, 0.0, 60.0, 0.0, 1.0, 12),
])
def test_fit_raised_cosine_agrees_with_the_reference(base, swing, period, phase, step, n):
    rate = _diurnal(base, swing, period, phase)
    ts = [step * i for i in range(n)]
    ours = tauto.fit_raised_cosine(ts, [rate(t) for t in ts], period)
    ref = jauto.fit_raised_cosine(ts, [rate(t) for t in ts], period)
    assert ours is not None and ref is not None
    for t in [period * f for f in (0.0, 0.1, 0.25, 0.5, 0.8, 1.3)]:
        assert abs(ours(t) - ref(t)) <= FIT_ATOL
        assert abs(ours(t) - max(0.0, rate(t))) < 1e-6 * max(1.0, base + 2 * swing)


@pytest.mark.parametrize("times,rates,period", [
    ([0.0, 1.0], [1.0, 2.0], 100.0),
    ([5.0] * 10, [1.0] * 10, 100.0),
    ([0.0, 1.0, 2.0, 3.0], [1.0] * 4, 0.0),
])
def test_fit_raised_cosine_refuses_degenerate_samples_alike(times, rates, period):
    assert tauto.fit_raised_cosine(times, rates, period) is None
    assert jauto.fit_raised_cosine(times, rates, period) is None


class FakeActuator:
    """Scripted actuator: counts replicas, refuses drains when told to."""

    def __init__(self, n=1):
        self.n = n
        self.refuse_in = False

    def replica_count(self):
        return self.n

    def scale_out(self):
        self.n += 1
        return True

    def scale_in(self):
        if self.refuse_in:
            return False
        self.n -= 1
        return True


def _trace():
    """One scripted trace of (t, rate, queue_wait_ms, burn_short,
    burn_long, refuse_in, tenant_rates): a full diurnal period at 2 s
    steps, with a two-window burn spike, a one-window spike (which must
    not trigger), a queue-wait blow-up, and a stretch of refused drains."""
    rate = _diurnal(50.0, 45.0, 100.0)
    rows = []
    for i in range(80):
        t = 2.0 * i
        burn_short = burn_long = 0.0
        queue = 0.0
        if 30 <= i < 33:
            burn_short = burn_long = 5.0
        if i == 36:
            burn_short = 5.0
        if 60 <= i < 62:
            queue = 500.0
        rows.append((t, rate(t), queue, burn_short, burn_long, 64 <= i < 70,
                     {"a": rate(t) * 0.75, "b": rate(t) * 0.25}))
    return rows


def _run_trace(mod, cfg_kw):
    actuator = FakeActuator(n=1)
    now = {"row": None}

    def signals():
        _, rate, queue, bs, bl, _, tenants = now["row"]
        return mod.AutoscaleSignals(rate=rate, queue_wait_ms=queue, burn_short=bs,
                                    burn_long=bl, tenant_rates=tenants)

    policy = mod.FleetAutoscaler(actuator, signals, mod.AutoscaleConfig(**cfg_kw))
    counts, predicted = [], []
    for row in _trace():
        now["row"] = row
        actuator.refuse_in = row[5]
        counts.append(policy.step(now=row[0]))
        predicted.append(policy.last_predicted_rate)
    events = [(e.t, e.direction, e.reason, e.replicas) for e in policy.events]
    return events, counts, predicted


CONFIGS = [
    dict(enabled=True, min_replicas=1, max_replicas=4, lead_s=10.0, period_s=100.0,
         per_replica_rate=100.0, cooldown_s=0.0, scale_in_quiet_evals=3, min_fit_samples=8),
    dict(enabled=True, min_replicas=1, max_replicas=3, lead_s=3.0, period_s=100.0,
         per_replica_rate=30.0, cooldown_s=5.0, burn_hi=2.0, queue_wait_hi_ms=200.0,
         scale_in_quiet_evals=2, min_fit_samples=6),
    dict(enabled=True, min_replicas=2, max_replicas=8, lead_s=30.0, period_s=100.0,
         per_replica_rate=40.0, cooldown_s=1.0, scale_in_quiet_evals=5, min_fit_samples=10_000),
]


@pytest.mark.parametrize("case", range(len(CONFIGS)))
def test_step_makes_the_reference_decisions_on_one_trace(case):
    ours = _run_trace(tauto, CONFIGS[case])
    ref = _run_trace(jauto, CONFIGS[case])
    assert ours[0] == ref[0] and ours[1] == ref[1]
    assert all(abs(a - b) <= FIT_ATOL * max(1.0, abs(b)) for a, b in zip(ours[2], ref[2]))
    assert {d for _, d, _, _ in ours[0]} == {"out", "in"}, ours[0]


def test_scale_out_lands_before_the_peak_and_in_after():
    rate = _diurnal(50.0, 45.0, 100.0)  # trough 50, peak 140 at t=50
    actuator = FakeActuator(n=1)
    sig = {"t": 0.0}
    policy = tauto.FleetAutoscaler(
        actuator,
        lambda: tauto.AutoscaleSignals(rate=rate(sig["t"]), queue_wait_ms=0.0,
                                       burn_short=0.0, burn_long=0.0),
        tauto.AutoscaleConfig(**CONFIGS[0]),
    )
    for t in [2.0 * i for i in range(50)]:
        sig["t"] = t
        policy.step(now=t)
    outs = [e for e in policy.events if e.direction == "out"]
    ins = [e for e in policy.events if e.direction == "in"]
    assert len(outs) == 1 and outs[0].reason == "predictive"
    assert outs[0].t < 50.0 and rate(outs[0].t) < 100.0
    assert ins and ins[0].reason == "quiet" and ins[0].t > 50.0
    assert actuator.n == 1


def test_reactive_override_needs_both_windows_and_respects_refusals():
    cfg = tauto.AutoscaleConfig(enabled=True, min_replicas=1, max_replicas=4,
                                per_replica_rate=100.0, cooldown_s=0.0, burn_hi=2.0,
                                scale_in_quiet_evals=2, min_fit_samples=10_000)
    actuator = FakeActuator(n=1)
    sig = {"burn": 5.0}
    policy = tauto.FleetAutoscaler(
        actuator,
        lambda: tauto.AutoscaleSignals(rate=10.0, queue_wait_ms=0.0,
                                       burn_short=sig["burn"], burn_long=sig["burn"]),
        cfg,
    )
    policy.step(now=0.0)
    assert actuator.n == 2 and policy.events[-1].reason == "reactive"
    one_sided = tauto.AutoscaleSignals(rate=10.0, queue_wait_ms=0.0, burn_short=5.0,
                                       burn_long=0.0)
    other = tauto.FleetAutoscaler(FakeActuator(n=1), lambda: one_sided, cfg)
    other.step(now=0.0)
    assert other.actuator.n == 1
    sig["burn"] = 0.0
    actuator.refuse_in = True
    for t in (1.0, 2.0, 3.0, 4.0):
        policy.step(now=t)
    assert actuator.n == 2
    actuator.refuse_in = False
    policy.step(now=5.0)
    policy.step(now=6.0)
    assert actuator.n == 1 and policy.events[-1].direction == "in"


def test_metrics_carry_the_reference_names():
    outs0 = metrics.registry.counter("fleet.autoscale.scale-outs").value
    policy = tauto.FleetAutoscaler(
        FakeActuator(n=1),
        lambda: tauto.AutoscaleSignals(rate=250.0, queue_wait_ms=0.0, burn_short=0.0,
                                       burn_long=0.0, tenant_rates={"shop": 12.5}),
        tauto.AutoscaleConfig(per_replica_rate=100.0, cooldown_s=0.0, max_replicas=8),
    )
    policy.step(now=0.0)
    assert metrics.registry.counter("fleet.autoscale.scale-outs").value == outs0 + 1
    assert metrics.registry.gauge("fleet.autoscale.replicas").value == 2
    assert metrics.registry.gauge("fleet.autoscale.predicted-rate").value == 250.0
    assert metrics.registry.gauge("fleet.autoscale.rate.tenant.shop").value == 12.5


def test_config_reads_the_packaged_defaults_alike():
    ours = tauto.AutoscaleConfig.from_config(tconfig.get_default())
    ref = jauto.AutoscaleConfig.from_config(jconfig.get_default())
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    overlay = 'oryx.fleet.autoscale { enabled = true, max-replicas = 5, lead-s = 3.5 }'
    ours = tauto.AutoscaleConfig.from_config(tconfig.get_default().with_overlay(overlay))
    ref = jauto.AutoscaleConfig.from_config(jconfig.get_default().with_overlay(overlay))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.enabled, ours.max_replicas, ours.lead_s) == (True, 5, 3.5)


def test_thread_steps_until_stopped_and_counts_errors():
    calls = []
    errors0 = metrics.registry.counter("fleet.autoscale.errors").value

    def signals():
        calls.append(time.monotonic())
        if len(calls) == 2:
            raise RuntimeError("a signal source failed")
        return tauto.AutoscaleSignals(rate=0.0, queue_wait_ms=0.0, burn_short=0.0, burn_long=0.0)

    policy = tauto.FleetAutoscaler(FakeActuator(), signals, tauto.AutoscaleConfig(interval_s=0.02))
    thread = tauto.AutoscalerThread(policy)
    thread.start()
    deadline = time.monotonic() + 5.0
    while len(calls) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    thread.stop()
    n = len(calls)
    time.sleep(0.1)
    assert n >= 5 and len(calls) == n
    assert metrics.registry.counter("fleet.autoscale.errors").value == errors0 + 1
