"""The port's open-loop load generator (``oryx_tpu_torch/loadgen/``)
against the JAX package's (``oryx_tpu/loadgen/``), on the CPU.

- Arrivals and user skew: the same seeds give the same arrival offsets
  and the same user ids, exactly (both draw from numpy's generator).
- ``classify_error`` maps the same exceptions to the same kinds.
- ``LoadResult.summary()``, ``evaluate_slo``, ``evaluate_tenant_slos``
  and ``burn_from_metrics`` give equal dicts and verdicts on the same
  records and snapshots (exact: the same float operations in the same
  order).
- Scenario files parse to the same scenario; the runner fires the
  timeline in order and records handler failures.
- The engine against a stub HTTP server: counts and rates, queueing
  delay measured from the scheduled arrival, failures classified,
  readiness routing, crash failover, trace headers and the tenant mix;
  and the two engines schedule the same arrivals for the same users.
  These carry the reference's ``fleet`` marker (they start threads and
  servers); the pure functions above them carry none.
"""

import dataclasses
import gc
import json
import math
import socket
import threading
import time
import urllib.error
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import oryx_tpu.loadgen as jloadgen
from oryx_tpu.loadgen import engine as jengine
from oryx_tpu.loadgen import feedback as jfeedback
from oryx_tpu.loadgen import slo as jslo
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch import loadgen
from oryx_tpu_torch.bus import faultbus
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import tracing
from oryx_tpu_torch.common.ledger import ledger
from oryx_tpu_torch.loadgen import engine as tengine
from oryx_tpu_torch.loadgen import feedback as tfeedback
from oryx_tpu_torch.loadgen import slo as tslo

PACKAGES = {
    "jax": dict(lg=jloadgen, engine=jengine, slo=jslo, feedback=jfeedback),
    "torch": dict(lg=loadgen, engine=tengine, slo=tslo, feedback=tfeedback),
}


def _settled_counts(before: dict, timeout: float = 5.0) -> dict:
    """The port's live resources, once they are back to ``before`` (or
    the timeout passed): threads need a beat to leave is_alive(), and
    garbage a collection."""
    deadline = time.monotonic() + timeout
    while True:
        after = ledger.counts()
        if all(after.get(k, 0) <= before.get(k, 0) for k in after):
            return after
        if time.monotonic() > deadline:
            return after
        gc.collect()
        time.sleep(0.05)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    before = ledger.counts()
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    faultbus.reset()
    after = _settled_counts(before)
    assert all(after.get(k, 0) <= before.get(k, 0) for k in after), (before, after)


# -- arrivals and skew: equal to the JAX package's, exactly ------------------


@pytest.mark.parametrize("rate,seconds,seed", [(150.0, 10.0, 7), (0.5, 30.0, 0), (2000.0, 1.0, 3)])
def test_poisson_arrivals_equal_the_reference(rate, seconds, seed):
    ours = list(loadgen.PoissonProcess(rate, seed=seed).times(seconds))
    ref = list(jloadgen.PoissonProcess(rate, seed=seed).times(seconds))
    assert ours == ref and len(ours) > 0
    p = loadgen.PoissonProcess(rate, seed=seed)
    assert p.offered_rate(1.0) == rate
    assert p.expected_arrivals(seconds) == jloadgen.PoissonProcess(rate).expected_arrivals(seconds)


@pytest.mark.parametrize("base,peak,period,phase,seed", [
    (15.0, 45.0, 14.0, 0.0, 17), (50.0, 200.0, 10.0, 0.25, 2), (1.0, 1.0, 3.0, 0.0, 5),
])
def test_diurnal_arrivals_equal_the_reference(base, peak, period, phase, seed):
    ours = loadgen.DiurnalRampProcess(base, peak, period, seed=seed, phase=phase)
    ref = jloadgen.DiurnalRampProcess(base, peak, period, seed=seed, phase=phase)
    assert list(ours.times(period)) == list(ref.times(period))
    for t in np.linspace(0.0, period, 9):
        assert ours.offered_rate(t) == ref.offered_rate(t)
    assert ours.expected_arrivals(period) == ref.expected_arrivals(period)


@pytest.mark.parametrize("kw", [
    dict(n_users=2_000_000, exponent=1.1, hot_count=16, hot_weight=0.2, seed=7),
    dict(n_users=1_000_000, seed=0),
    dict(n_users=600, exponent=0.2, seed=11),
    dict(n_users=1000, exponent=1.0, seed=3),
    dict(n_users=50, exponent=3.0, hot_count=5, hot_weight=1.0, seed=9),
])
def test_power_law_users_equal_the_reference(kw):
    ours, ref = loadgen.PowerLawUsers(**kw), jloadgen.PowerLawUsers(**kw)
    np.testing.assert_array_equal(ours.sample(5000), ref.sample(5000))
    singles = [ours.one() for _ in range(200)]
    assert singles == [ref.one() for _ in range(200)]
    assert all(type(u) is int and 0 <= u < kw["n_users"] for u in singles)


@pytest.mark.parametrize("make", [
    lambda m: m.PoissonProcess(0.0),
    lambda m: m.DiurnalRampProcess(0.0, 1.0, 1.0),
    lambda m: m.DiurnalRampProcess(2.0, 1.0, 1.0),
    lambda m: m.DiurnalRampProcess(1.0, 2.0, 0.0),
    lambda m: m.PowerLawUsers(0),
    lambda m: m.PowerLawUsers(10, exponent=0.0),
    lambda m: m.PowerLawUsers(10, hot_weight=1.5),
    lambda m: m.PowerLawUsers(10, hot_weight=0.5),
])
def test_invalid_shapes_raise_alike(make):
    with pytest.raises(ValueError) as ours:
        make(loadgen)
    with pytest.raises(ValueError) as ref:
        make(jloadgen)
    assert str(ours.value) == str(ref.value)


# -- classify_error -----------------------------------------------------------


def _http_error(code):
    return urllib.error.HTTPError("http://x/", code, "msg", {}, None)


@pytest.mark.parametrize("make", [
    lambda: _http_error(500), lambda: _http_error(503), lambda: _http_error(404),
    lambda: _http_error(429), lambda: _http_error(302),
    lambda: socket.timeout("timed out"), lambda: TimeoutError(),
    lambda: urllib.error.URLError(socket.timeout("t")),
    lambda: urllib.error.URLError(ConnectionRefusedError()),
    lambda: ConnectionRefusedError(), lambda: ConnectionResetError(), lambda: OSError("x"),
    lambda: ValueError("not a transport error"),
])
def test_classify_error_agrees(make):
    assert tengine.classify_error(make()) == jengine.classify_error(make())


def test_client_header_constants_mirror_the_serving_side():
    from oryx_tpu_torch.experiments.routing import ARM_HEADER
    from oryx_tpu_torch.serving.overload import SHED_HEADER, STAGE_NAMES
    from oryx_tpu_torch.tenancy.context import TENANT_HEADER, TENANT_PATH_PREFIX

    assert tengine.SHED_HEADER == SHED_HEADER == jengine.SHED_HEADER
    assert tengine.SHED_STAGES == STAGE_NAMES == jengine.SHED_STAGES
    assert tengine.ARM_HEADER == ARM_HEADER
    assert (tengine.TENANT_HEADER, tengine.TENANT_PATH_PREFIX) == (TENANT_HEADER, TENANT_PATH_PREFIX)


# -- summaries and SLO verdicts on the same records ---------------------------


KINDS = ("ok", "ok", "ok", "ok", "shed", "timeout", "http-5xx", "connection")
STAGES = ("full", "full", "reduced-probe", "stale")


def _records(pkg: str, seed: int, n: int = 400, tenants=("a", "b", None)):
    m = PACKAGES[pkg]
    gen = np.random.default_rng(seed)
    records = []
    for i in range(n):
        kind = KINDS[int(gen.integers(len(KINDS)))]
        latency = float(gen.exponential(0.05))
        records.append(m["engine"].RequestRecord(
            t_sched=i * 0.01, latency=latency, service=latency * 0.7,
            target=f"r{i % 3}", ok=kind == "ok", kind=kind,
            shed_stage="shed" if kind == "shed" else STAGES[int(gen.integers(len(STAGES)))],
            user=int(gen.integers(1000)), tenant=tenants[i % len(tenants)],
            connect_ms=float(gen.choice([0.0, 0.0, 1.5])),
        ))
    return records


def _result(pkg: str, seed: int, **kw):
    m = PACKAGES[pkg]
    records = _records(pkg, seed, **kw)
    targets = {}
    for r in records:
        t = targets.setdefault(r.target, m["engine"].Target(r.target, "http://127.0.0.1:1"))
        if r.kind != "shed":
            t.slo.record(r.ok, r.latency)
        if r.ok:
            t.ok += 1
        elif r.kind == "shed":
            t.shed += 1
        else:
            t.failed += 1
            t.error_kinds[r.kind] += 1
    n_ok = sum(r.ok for r in records)
    n_shed = sum(r.kind == "shed" for r in records)
    return m["engine"].LoadResult(
        duration_s=4.0, offered=len(records) + 3, completed=len(records), ok=n_ok,
        failed=len(records) - n_ok - n_shed,
        error_kinds=Counter(r.kind for r in records if not r.ok and r.kind != "shed"),
        records=records, queued_arrivals=5, peak_inflight=17, per_target=targets,
        shed=n_shed, retried=2,
    )


def _verdict_fields(v) -> dict:
    return {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_summary_quantiles_and_quality_equal_the_reference(seed):
    ours, ref = _result("torch", seed), _result("jax", seed)
    assert ours.summary() == ref.summary()
    assert ours.quality() == ref.quality()
    for q in (0.5, 0.9, 0.99, 1.0):
        assert ours.latency_quantile(q) == ref.latency_quantile(q)
        assert ours.service_quantile(q) == ref.service_quantile(q)
    assert (ours.offered_rate, ours.achieved_rate, ours.error_rate) == (
        ref.offered_rate, ref.achieved_rate, ref.error_rate)
    assert {k: len(v) for k, v in ours.tenant_records().items()} == {
        k: len(v) for k, v in ref.tenant_records().items()}


@pytest.mark.parametrize("spec", [
    dict(), dict(p99_ms=100.0), dict(p99_ms=1000.0, error_rate=0.0),
    dict(p99_ms=1000.0, error_rate=0.3, max_burn=math.inf),
    dict(p99_ms=1000.0, error_rate=0.05, window_s=60.0),
    dict(p99_ms=1000.0, error_rate=0.5, min_full_quality=0.9),
])
def test_evaluate_slo_equals_the_reference(spec):
    ours = tslo.evaluate_slo(_result("torch", 4), loadgen.SLOSpec(**spec))
    ref = jslo.evaluate_slo(_result("jax", 4), jloadgen.SLOSpec(**spec))
    assert _verdict_fields(ours) == _verdict_fields(ref)
    assert bool(ours) == bool(ref)


def test_evaluate_slo_passes_a_clean_run_and_fails_one_failure():
    clean = dataclasses.replace(_result("torch", 5, n=50), failed=0, error_kinds=Counter())
    clean.records = [dataclasses.replace(r, ok=True, kind="ok") for r in clean.records]
    assert tslo.evaluate_slo(clean, loadgen.SLOSpec(p99_ms=1e6))
    one_failure = _result("torch", 5, n=50)
    verdict = tslo.evaluate_slo(one_failure, loadgen.SLOSpec(p99_ms=1e6))
    assert not verdict and any("zero-downtime" in v for v in verdict.violations)


def test_evaluate_tenant_slos_equals_the_reference():
    specs = {"a": dict(p99_ms=100.0), "b": dict(p99_ms=1e6, error_rate=0.5, max_burn=math.inf),
             "absent": dict()}
    ours = tslo.evaluate_tenant_slos(
        _result("torch", 6), {k: loadgen.SLOSpec(**v) for k, v in specs.items()})
    ref = jslo.evaluate_tenant_slos(
        _result("jax", 6), {k: jloadgen.SLOSpec(**v) for k, v in specs.items()})
    assert {k: _verdict_fields(v) for k, v in ours.items()} == {
        k: _verdict_fields(v) for k, v in ref.items()}
    assert not ours["absent"].passed


@pytest.mark.parametrize("before,after,budget", [
    ({}, {}, 0.01),
    ({"serving.responses.2xx": {"value": 100}}, {"serving.responses.2xx": {"value": 190},
                                                 "serving.responses.5xx": {"value": 10}}, 0.01),
    ({"serving.responses.2xx": {"value": 100}}, {"serving.responses.2xx": {"value": 190},
                                                 "serving.responses.5xx": {"value": 10}}, 0.0),
    ({"serving.responses.4xx": {"value": 3}}, {"serving.responses.4xx": {"value": 9}}, 0.0),
])
def test_burn_from_metrics_equals_the_reference(before, after, budget):
    assert tslo.burn_from_metrics(before, after, 60.0, budget) == jslo.burn_from_metrics(
        before, after, 60.0, budget)


# -- scenarios ----------------------------------------------------------------


SCENARIOS = [
    {
        "duration_s": 8,
        "template": "/probe/recommend/u%d",
        "arrivals": {"process": "poisson", "rate": 150, "seed": 7},
        "skew": {"users": 2_000_000, "exponent": 1.1, "hot_count": 16, "hot_weight": 0.2},
        "slo": {"p99_ms": 800, "error_rate": 0.0, "window_s": 5},
        "actions": [
            {"at": 6.0, "do": "rollback", "generation": "first"},
            {"at": 2.0, "do": "publish", "metric": 0.95},
            {"at": 2.5, "do": "chaos", "drop": 0.2, "delay_ms": 5, "dup": 0.2},
        ],
    },
    {
        "duration_s": 14,
        "arrivals": {"process": "diurnal", "base_rate": 15, "peak_rate": 45, "seed": 17},
        "skew": {"users": 100_000, "seed": 17},
        "slo": {"p99_ms": 1000, "error_rate": 0.01, "min_full_quality": 0.5},
        "actions": [{"at": 1.0, "do": "scale", "direction": "out"}],
    },
    {},
]


def _scenario_fields(sc) -> dict:
    return {
        "duration_s": sc.duration_s, "template": sc.template,
        "arrivals_spec": sc.arrivals_spec, "skew_spec": sc.skew_spec,
        "slo": dataclasses.asdict(sc.slo),
        "actions": [(a.at, a.do, a.args) for a in sc.actions],
    }


@pytest.mark.parametrize("case", range(len(SCENARIOS)))
def test_scenario_parses_as_the_reference_does(case, tmp_path):
    path = tmp_path / "scenario.json"
    path.write_text(json.dumps(SCENARIOS[case]))
    ours = loadgen.Scenario.from_file(str(path))
    ref = jloadgen.Scenario.from_file(str(path))
    assert _scenario_fields(ours) == _scenario_fields(ref)
    assert [a.at for a in ours.actions] == sorted(a.at for a in ours.actions)
    seconds = min(ours.duration_s, 3.0)
    assert list(ours.build_arrivals().times(seconds)) == list(ref.build_arrivals().times(seconds))
    np.testing.assert_array_equal(ours.build_skew().sample(1000), ref.build_skew().sample(1000))


def test_scenario_rejects_an_unknown_process():
    sc = loadgen.Scenario.from_dict({"arrivals": {"process": "bursty"}})
    with pytest.raises(ValueError, match="bursty"):
        sc.build_arrivals()


@pytest.mark.fleet
def test_runner_fires_actions_in_order_and_records_failures():
    fired = []

    def boom(**kw):
        raise RuntimeError("handler failed")

    runner = loadgen.ScenarioRunner(
        [loadgen.Action(0.10, "b", {"x": 2}), loadgen.Action(0.05, "a", {"x": 1}),
         loadgen.Action(0.12, "boom"), loadgen.Action(0.15, "nope")],
        {"a": lambda x: fired.append(("a", x)), "b": lambda x: fired.append(("b", x)),
         "boom": boom},
    )
    runner.start()
    runner.join(timeout=5)
    assert fired == [("a", 1), ("b", 2)]
    assert [a.do for a in runner.executed] == ["a", "b"]
    assert [(a.do, type(e).__name__) for a, e in runner.errors] == [
        ("boom", "RuntimeError"), ("nope", "ValueError")]


@pytest.mark.fleet
def test_runner_stop_halts_the_timeline():
    fired = []
    runner = loadgen.ScenarioRunner(
        [loadgen.Action(0.0, "a"), loadgen.Action(30.0, "a")], {"a": lambda: fired.append(1)})
    runner.start()
    time.sleep(0.2)
    runner.stop()
    runner.join(timeout=5)
    assert fired == [1] and not runner.is_alive()


# -- scripted feedback --------------------------------------------------------


def test_feedback_rolls_and_sends_as_the_reference_does():
    for seed, user, index in ((7, 3, 0), (7, "u9", 12), (1, 0, 5)):
        assert tfeedback.roll(seed, user, index) == jfeedback.roll(seed, user, index)
    sent = {"torch": [], "jax": []}
    hooks = {
        pkg: PACKAGES[pkg]["feedback"].ScriptedFeedback(
            sent[pkg].append, lambda gen: {"1000": 0.9}.get(gen, 0.2), seed=7)
        for pkg in PACKAGES
    }
    gen = np.random.default_rng(0)
    for i in range(300):
        body = json.dumps({"user": f"u{i % 40}", "generation_id": "1000" if i % 3 else "2000",
                           "items": [f"i{j}" for j in gen.integers(0, 99, 10)]}).encode()
        status = 200 if i % 17 else 500
        for hook in hooks.values():
            hook.on_response(i, status, {}, body)
        for hook in hooks.values():
            hook.on_response(i, 200, {}, b"not json")
    assert sent["torch"] == sent["jax"] and len(sent["torch"]) > 50
    assert hooks["torch"].sent == hooks["jax"].sent


# -- the engine against a stub server -----------------------------------------


class FixedUsers:
    def one(self) -> int:
        return 7


class CountingUsers:
    def __init__(self) -> None:
        self.n = 0

    def one(self) -> int:
        self.n += 1
        return self.n


class ControlServer:
    """A local HTTP server with scriptable latency, status and readiness;
    it records each request's path and traceparent header."""

    def __init__(self) -> None:
        self.latency_s = 0.0
        self.status = 200
        self.ready = True
        self.shed_stage = None
        self.paths: list[str] = []
        self.traceparents: list[str | None] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive, as the serving fronts

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                if self.path == "/readyz":
                    self.send_response(200 if outer.ready else 503)
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(b"{}")
                    return
                outer.paths.append(self.path)
                outer.traceparents.append(self.headers.get("traceparent"))
                if outer.latency_s:
                    time.sleep(outer.latency_s)
                self.send_response(outer.status)
                if outer.shed_stage:
                    self.send_header(tengine.SHED_HEADER, outer.shed_stage)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base = f"http://127.0.0.1:{self._srv.server_address[1]}"
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()

    @property
    def hits(self) -> int:
        return len(self.paths)

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(5)


@pytest.fixture()
def server():
    s = ControlServer()
    yield s
    s.close()


def _dead_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(engine, rate=50.0, seconds=1.0, seed=1, users=None):
    return engine.run(loadgen.PoissonProcess(rate=rate, seed=seed), users or FixedUsers(), seconds)


@pytest.mark.fleet
def test_engine_clean_run_counts_and_rates(server):
    engine = loadgen.OpenLoopEngine([loadgen.Target("t0", server.base)], template="/probe/u%d")
    result = _run(engine, rate=60.0, seconds=1.0)
    assert result.offered == len(list(loadgen.PoissonProcess(60.0, seed=1).times(1.0))) > 0
    assert result.completed == result.ok == result.offered and result.failed == 0
    assert result.error_rate == 0.0 and result.offered_rate == result.offered / 1.0
    assert server.hits == result.offered and set(server.paths) == {"/probe/u7"}
    assert result.quality()["full"] == 1.0


@pytest.mark.fleet
def test_engines_schedule_the_same_arrivals_for_the_same_users(server):
    """The port's engine and the JAX package's, on the same arrival
    process and user draws: the same scheduled offsets, the same users,
    the same paths asked."""
    runs = {}
    for pkg in ("torch", "jax"):
        lg = PACKAGES[pkg]["lg"]
        server.paths.clear()
        eng = lg.OpenLoopEngine([lg.Target("t0", server.base)], template="/r/u%d",
                                readiness_poll_s=0)
        res = eng.run(lg.PoissonProcess(80.0, seed=4), lg.PowerLawUsers(5000, seed=4), 0.8)
        recs = sorted(res.records, key=lambda r: r.t_sched)
        runs[pkg] = ([r.t_sched for r in recs], [r.user for r in recs], sorted(server.paths),
                     res.offered, res.ok)
    assert runs["torch"] == runs["jax"] and runs["torch"][3] > 0


@pytest.mark.fleet
def test_engine_queueing_delay_is_measured_not_hidden(server):
    server.latency_s = 0.10
    engine = loadgen.OpenLoopEngine(
        [loadgen.Target("t0", server.base)], template="/probe/u%d", max_inflight=1)
    result = _run(engine, rate=40.0, seconds=0.5)
    assert result.queued_arrivals > 0
    assert result.service_quantile(0.99) < 0.35
    assert result.latency_quantile(0.99) > 2.0 * result.service_quantile(0.99)


@pytest.mark.fleet
@pytest.mark.parametrize("status,kind", [(500, "http-5xx"), (503, "http-5xx"), (404, "http-4xx")])
def test_engine_http_errors_classified(server, status, kind):
    server.status = status
    engine = loadgen.OpenLoopEngine([loadgen.Target("t0", server.base)], template="/probe/u%d")
    result = _run(engine, rate=40.0, seconds=0.5)
    assert result.ok == 0 and result.failed == result.completed > 0
    assert set(result.error_kinds) == {kind}
    assert result.per_target["t0"].error_kinds[kind] == result.failed


@pytest.mark.fleet
def test_engine_shed_429_is_counted_apart_from_failures(server):
    server.status, server.shed_stage = 429, "shed"
    engine = loadgen.OpenLoopEngine([loadgen.Target("t0", server.base)], template="/probe/u%d")
    result = _run(engine, rate=40.0, seconds=0.5)
    assert result.failed == 0 and result.shed == result.completed > 0
    assert result.quality()["shed"] == 1.0
    assert tslo.evaluate_slo(result, loadgen.SLOSpec(p99_ms=1e6)).passed


@pytest.mark.fleet
def test_engine_timeout_classified_as_timeout(server):
    server.latency_s = 2.0
    engine = loadgen.OpenLoopEngine(
        [loadgen.Target("t0", server.base)], template="/probe/u%d", timeout_s=0.2)
    result = _run(engine, rate=6.0, seconds=0.5)
    assert result.failed > 0 and set(result.error_kinds) == {"timeout"}


@pytest.mark.fleet
def test_engine_connection_refused_and_no_survivor():
    t = loadgen.Target("t0", f"http://127.0.0.1:{_dead_port()}")
    engine = loadgen.OpenLoopEngine([t], template="/probe/u%d", readiness_poll_s=0)
    result = _run(engine, rate=10.0, seconds=0.3)
    assert result.failed == result.completed > 0
    assert set(result.error_kinds) == {"connection"}
    assert result.retried == 0 and t.ready is True


@pytest.mark.fleet
def test_engine_readiness_gates_routing(server):
    draining = ControlServer()
    draining.ready = False
    try:
        t_ok, t_drain = loadgen.Target("ok", server.base), loadgen.Target("drain", draining.base)
        t_drain.ready = False
        engine = loadgen.OpenLoopEngine([t_ok, t_drain], template="/probe/u%d",
                                        readiness_poll_s=0.05)
        result = _run(engine, rate=50.0, seconds=0.6)
        assert result.failed == 0
        assert result.per_target["drain"].ok == 0 and draining.hits == 0
        assert result.per_target["ok"].ok == result.ok > 0
    finally:
        draining.close()


@pytest.mark.fleet
def test_engine_no_ready_replica_is_a_recorded_failure(server):
    t = loadgen.Target("t0", server.base)
    t.ready = False
    engine = loadgen.OpenLoopEngine([t], template="/probe/u%d", readiness_poll_s=0)
    result = _run(engine, rate=30.0, seconds=0.3)
    assert result.completed == result.offered > 0 and result.ok == 0
    assert set(result.error_kinds) == {"no-ready-replica"} and server.hits == 0


@pytest.mark.fleet
def test_engine_fails_over_from_a_dead_replica(server):
    t_dead = loadgen.Target("dead", f"http://127.0.0.1:{_dead_port()}")
    t_ok = loadgen.Target("ok", server.base)
    engine = loadgen.OpenLoopEngine([t_dead, t_ok], template="/probe/u%d", readiness_poll_s=0)
    result = _run(engine, rate=50.0, seconds=0.5)
    assert result.failed == 0 and result.ok == result.completed > 0
    assert result.retried > 0 and t_dead.ready is False
    assert result.per_target["ok"].ok == result.ok


@pytest.mark.fleet
def test_engine_requires_targets():
    with pytest.raises(ValueError):
        loadgen.OpenLoopEngine([])


@pytest.mark.fleet
def test_engine_traced_requests_carry_traceparent(server):
    tracing.reset()
    tracing.configure(sample_rate=1.0)
    try:
        engine = loadgen.OpenLoopEngine([loadgen.Target("t0", server.base)], template="/r/u%d",
                                        readiness_poll_s=0.05)
        result = _run(engine, rate=40.0, seconds=0.6)
        assert result.ok > 0 and all(r.trace_id for r in result.records)
        roots = {s["trace"]: s for s in tracing.spans() if s["name"] == "client.request"}
        assert all(roots[r.trace_id]["parent"] is None for r in result.records)
        sent = {tracing.parse_traceparent(h).trace_id for h in server.traceparents if h}
        assert sent == {r.trace_id for r in result.records}
    finally:
        tracing.reset()


@pytest.mark.fleet
def test_engine_tenant_mix_routes_and_stamps_records(server):
    engine = loadgen.OpenLoopEngine(
        [loadgen.Target("t0", server.base)], template="/probe/u%d", readiness_poll_s=0,
        tenant_mix={"a": 3.0, "b": 1.0}, tenant_templates={"b": "/other/u%d"}, tenant_seed=5)
    result = _run(engine, rate=200.0, seconds=0.6, users=CountingUsers())
    grouped = result.tenant_records()
    assert sorted(grouped) == ["a", "b"] and len(grouped["a"]) > len(grouped["b"])
    assert {p.split("/u")[0] for p in server.paths} == {"/t/a/probe", "/t/b/other"}
    engine.set_tenant_mix({"b": 1.0})
    server.paths.clear()
    result = _run(engine, rate=100.0, seconds=0.3, seed=2)
    assert {r.tenant for r in result.records} == {"b"}
    with pytest.raises(RuntimeError):
        loadgen.OpenLoopEngine([loadgen.Target("t0", server.base)]).set_tenant_mix({"a": 1.0})


@pytest.mark.fleet
def test_keep_alive_client_reuses_its_connection(server):
    client = tengine.KeepAliveClient(timeout_s=5.0)
    try:
        first = client.request(server.base + "/x")
        second = client.request(server.base + "/y")
    finally:
        client.close()
    assert first[0] == second[0] == 200 and first[2] == b"ok"
    assert first[3] > 0.0 and second[3] == 0.0  # connect time only on the first
