"""The serving layer's observability routes on the port against the JAX
package's, on the CPU: GET /trace (Chrome export and the span list,
filtered by a request's trace id), POST /debug/profile (503 without a
profile dir, the 30 s cap, the ``serving.debug.profiles`` counter), and
``cli trace`` (tests/serving/test_observability.py:107-217). The port's
capture is a real ``torch.profiler`` one: on the CPU it writes a Chrome
trace, and a second capture while one runs answers 503."""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from oryx_tpu import bus as jbus
from oryx_tpu import cli as jcli
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import metrics as jmetrics
from oryx_tpu.common import profiling as jprofiling
from oryx_tpu.common import tracing as jtracing
from oryx_tpu.serving.layer import ServingLayer as JaxServingLayer
from oryx_tpu_torch import bus as tbus
from oryx_tpu_torch import cli as tcli
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import metrics as tmetrics
from oryx_tpu_torch.common import profiling as tprofiling
from oryx_tpu_torch.common import tracing as ttracing
from oryx_tpu_torch.serving.layer import ServingLayer

PACKAGES = {
    "jax": dict(name="oryx_tpu", config=jconfig, bus=jbus, layer=JaxServingLayer,
                tracing=jtracing, metrics=jmetrics, profiling=jprofiling, cli=jcli),
    "torch": dict(name="oryx_tpu_torch", config=tconfig, bus=tbus, layer=ServingLayer,
                  tracing=ttracing, metrics=tmetrics, profiling=tprofiling, cli=tcli),
}


@pytest.fixture(autouse=True)
def _traced(monkeypatch):
    """Sample every root in both packages (the env override reaches each
    layer's configure_from), and leave clean tracers behind."""
    port_device.set_device("cpu")
    monkeypatch.setenv("ORYX_TRACING_SAMPLE_RATE", "1.0")
    for p in PACKAGES.values():
        p["tracing"].reset()
    yield
    monkeypatch.delenv("ORYX_TRACING_SAMPLE_RATE", raising=False)
    for p in PACKAGES.values():
        p["tracing"].reset()
    port_device.set_device(None)
    InProcessBroker.reset_all()


def make_config(pkg, broker, **overrides):
    p = PACKAGES[pkg]
    extra = "\n".join(f"{k} = {v}" for k, v in overrides.items())
    return p["config"].get_default().with_overlay(
        f"""
        oryx {{
          input-topic.broker = "{broker}"
          update-topic.broker = "{broker}"
          serving {{
            api.port = 0
            model-manager-class = "{p['name']}.example.serving:ExampleServingModelManager"
            application-resources = "{p['name']}.example.serving"
            {extra}
          }}
        }}
        """
    )


def http(method, url, body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def ready_layer(pkg, broker_loc, **overrides):
    p = PACKAGES[pkg]
    layer = p["layer"](make_config(pkg, broker_loc, **overrides))
    layer.start()
    base = f"http://127.0.0.1:{layer.port}"
    with p["bus"].get_broker(broker_loc).producer("OryxUpdate") as prod:
        prod.send("MODEL", json.dumps({"a": 2, "b": 1}))
    assert wait_for(lambda: http("GET", f"{base}/ready")[0] == 200)
    return layer, base


def traced_request(pkg, base):
    """GET /distinct under a sampled traceparent; returns its context."""
    ctx = PACKAGES[pkg]["tracing"].sample_root()
    assert ctx is not None
    status, _, _ = http("GET", f"{base}/distinct", headers={"traceparent": ctx.traceparent()})
    assert status == 200
    return ctx


def request_span_view(pkg):
    """The request span's GET /trace?format=spans view, less ids and times."""
    layer, base = ready_layer(pkg, f"inproc://tobs-spans-{pkg}")
    try:
        ctx = traced_request(pkg, base)
        status, body, headers = http("GET", f"{base}/trace?format=spans&trace={ctx.trace_id}")
        assert status == 200 and headers["Content-Type"].startswith("application/json")
        doc = json.loads(body)
    finally:
        layer.close()
    (span,) = [s for s in doc["spans"] if s["name"] == "serving.request"]
    assert span["trace"] == ctx.trace_id
    assert span["parent"] == ctx.span_id  # joined, not re-rooted
    return {"enabled": doc["enabled"], "keys": sorted(doc), "span_keys": sorted(span),
            "attrs": span["attrs"], "names": sorted({s["name"] for s in doc["spans"]})}


def test_trace_spans_join_the_incoming_traceparent():
    got = request_span_view("torch")
    assert got == request_span_view("jax")
    assert got["enabled"] is True
    assert got["attrs"]["path"] == "/distinct" and got["attrs"]["status"] == 200


def chrome_view(pkg):
    layer, base = ready_layer(pkg, f"inproc://tobs-chrome-{pkg}")
    try:
        ctx = traced_request(pkg, base)
        traced_request(pkg, base)  # another trace, filtered out below
        status, body, _ = http("GET", f"{base}/trace?trace={ctx.trace_id}")
        assert status == 200
        doc = json.loads(body)
        unfiltered = json.loads(http("GET", f"{base}/trace")[1])
    finally:
        layer.close()
    assert doc["displayTimeUnit"] == "ms"
    (ev,) = [e for e in doc["traceEvents"] if e["args"]["trace"] == ctx.trace_id]
    assert ev["ph"] == "X" and ev["dur"] >= 0
    assert all(e["args"]["trace"] == ctx.trace_id for e in doc["traceEvents"])
    return {"keys": sorted(doc), "event_keys": sorted(ev), "name": ev["name"],
            "traces": len({e["args"]["trace"] for e in unfiltered["traceEvents"]})}


def test_trace_chrome_export_filtered():
    got = chrome_view("torch")
    assert got == chrome_view("jax")
    assert got["name"] == "serving.request" and got["traces"] >= 2


def profile_statuses(pkg, tmp_path, monkeypatch):
    p = PACKAGES[pkg]
    layer, base = ready_layer(pkg, f"inproc://tobs-prof-{pkg}")
    try:
        status, body, _ = http("POST", f"{base}/debug/profile")
        out = {"no_dir": (status, b"profile-dir" in body)}
    finally:
        layer.close()
    captured = {}

    def fake_capture(profile_dir, name, seconds):
        captured.update(dir=profile_dir, name=name, seconds=seconds)
        return f"{profile_dir}/{name}"

    monkeypatch.setattr(p["profiling"], "capture", fake_capture)
    layer, base = ready_layer(pkg, f"inproc://tobs-prof2-{pkg}",
                              **{"compute.profile-dir": f'"{tmp_path}/{pkg}"'})
    try:
        before = p["metrics"].registry.counter("serving.debug.profiles").value
        status, body, _ = http("POST", f"{base}/debug/profile?seconds=99")
        doc = json.loads(body)
        after = p["metrics"].registry.counter("serving.debug.profiles").value
    finally:
        layer.close()
    assert doc["path"].startswith(f"{tmp_path}/{pkg}")
    out.update(status=status, seconds=doc["seconds"], captured=captured["seconds"],
               name=captured["name"], dir_ok=captured["dir"] == f"{tmp_path}/{pkg}",
               counted=after - before)
    return out


def test_debug_profile_needs_a_dir_and_caps_the_window(tmp_path, monkeypatch):
    got = profile_statuses("torch", tmp_path, monkeypatch)
    assert got == profile_statuses("jax", tmp_path, monkeypatch)
    assert got["no_dir"] == (503, True)
    assert got["status"] == 200 and got["seconds"] == got["captured"] == 30.0  # capped
    assert got["dir_ok"] and got["counted"] == 1


def test_debug_profile_writes_a_chrome_trace(tmp_path):
    """A real torch.profiler capture on the CPU: 200 with the trace's
    directory, a Chrome trace whose window is the capture's annotation,
    and 503 for a second capture while the first runs."""
    layer, base = ready_layer("torch", "inproc://tobs-real",
                              **{"compute.profile-dir": f'"{tmp_path}"'})
    try:
        before = tmetrics.registry.counter("serving.debug.profiles").value
        first = {}
        t = threading.Thread(target=lambda: first.update(
            r=http("POST", f"{base}/debug/profile?seconds=1.5")))
        t.start()
        assert wait_for(lambda: tprofiling._session_lock.locked())
        second = http("POST", f"{base}/debug/profile?seconds=0.1")
        t.join(30)
        assert not t.is_alive()
        after = tmetrics.registry.counter("serving.debug.profiles").value
    finally:
        layer.close()
    assert second[0] == 503 and b"already running" in second[1]
    status, body, _ = first["r"]
    assert status == 200
    doc = json.loads(body)
    assert doc["seconds"] == 1.5 and after == before + 1
    assert os.path.basename(doc["path"]).startswith("serving-ondemand-")
    trace = json.loads(open(os.path.join(doc["path"], tprofiling.TRACE_FILE)).read())
    (window,) = [e for e in trace["traceEvents"] if e.get("name") == "serving-ondemand"]
    assert window["ph"] == "X" and window["dur"] >= 1.5e6  # microseconds


def test_maybe_trace_body_exception_propagates(tmp_path):
    """tests/common/test_profiling.py on the port: no-op without a dir,
    the body's own exception propagates, the trace is still written."""
    ran = []
    with tprofiling.maybe_trace(None, "x"):
        ran.append(True)
    assert ran and not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="body failure"):
        with tprofiling.maybe_trace(str(tmp_path), "boom"):
            raise RuntimeError("body failure")
    (target,) = os.listdir(tmp_path)
    assert target.startswith("boom-")
    assert os.path.exists(os.path.join(tmp_path, target, tprofiling.TRACE_FILE))


def cli_trace_view(pkg):
    p = PACKAGES[pkg]
    layer, base = ready_layer(pkg, f"inproc://tobs-cli-{pkg}")
    try:
        ctx = traced_request(pkg, base)
        probe = make_config(pkg, f"inproc://tobs-cli-{pkg}").with_overlay(
            f"oryx.serving.api.port = {layer.port}")
        out = io.StringIO()
        rc_all = p["cli"].run_trace(probe, out=out)
        doc = json.loads(out.getvalue())
        out2 = io.StringIO()
        rc_one = p["cli"].run_trace(probe, ctx.trace_id, out=out2)
        doc2 = json.loads(out2.getvalue())
    finally:
        layer.close()
    out3 = io.StringIO()
    rc_gone = p["cli"].run_trace(probe, out=out3)  # layer gone: unreachable
    return {
        "rcs": (rc_all, rc_one, rc_gone),
        "all_has_it": any(e["args"]["trace"] == ctx.trace_id for e in doc["traceEvents"]),
        "one_only": bool(doc2["traceEvents"]) and all(
            e["args"]["trace"] == ctx.trace_id for e in doc2["traceEvents"]),
        "unreachable": out3.getvalue().startswith("/trace: unreachable"),
    }


def test_cli_trace_dumps_span_ring():
    got = cli_trace_view("torch")
    assert got == cli_trace_view("jax")
    assert got == {"rcs": (0, 0, 1), "all_has_it": True, "one_only": True, "unreachable": True}
    args = tcli._build_parser().parse_args(["trace", "0af7651916cd43dd8448eb211c80319c"])
    assert args.command == "trace" and args.subcommand == "0af7651916cd43dd8448eb211c80319c"
