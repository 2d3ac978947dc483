"""``GET /metrics`` of the port's serving layer against the JAX
package's (``oryx_tpu/serving/layer.py:323-376``), on the CPU.

Both handlers read registries of the same contents and the same model
state (loaded fraction, live generation). For each way a client asks,
they answer the same status and content type: Prometheus text 0.0.4 for
``?format=prometheus`` or an ``Accept`` naming ``text/plain`` or
``openmetrics``, with ``?format=json`` winning, JSON otherwise. The
bodies are equal but for the port's own gauges (the scan kernels'
launches and the IVF tier's batches by path). A non-numeric live
generation stays in the JSON and out of the text. A real port layer
negotiates the same way behind both of its fronts, and the handler
refreshes the resource ledger when it is on.
"""

from __future__ import annotations

import json
import urllib.request

import pytest

from oryx_tpu.common import metrics as jmetrics
from oryx_tpu.serving import layer as jlayer
from oryx_tpu.serving import web as jweb
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import ledger as tledger
from oryx_tpu_torch.common import metrics as tmetrics
from oryx_tpu_torch.native import get_library
from oryx_tpu_torch.serving import layer as tlayer
from oryx_tpu_torch.serving import web as tweb

PORT_ONLY = ("kernels.", "serving.ann.")

CASES = {
    "no-accept": ({}, {}),
    "format-prometheus": ({"format": ["prometheus"]}, {}),
    "accept-text-plain": ({}, {"Accept": "text/plain;version=0.0.4"}),
    "accept-openmetrics": ({}, {"accept": "application/openmetrics-text"}),
    "format-json-wins": ({"format": ["json"]}, {"Accept": "text/plain;version=0.0.4"}),
}
TEXT_CASES = {"format-prometheus", "accept-text-plain", "accept-openmetrics"}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    """The port on the CPU; each package's handler reads a fresh registry
    of the same contents, the resource ledger off (its gauges count each
    package's own live resources)."""
    port_device.set_device("cpu")
    monkeypatch.setenv("ORYX_RESOURCE_LEDGER", "0")
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("serving.requests.GET").inc(7)
        reg.counter("serving.responses.2xx").inc(6)
        reg.gauge("serving.update-stream.healthy").set(1)
        for v in (0.004, 0.02, 0.3):
            reg.histogram("serving.request.seconds").observe(v)
        monkeypatch.setattr(mod, "registry", reg)
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


class _Model:
    def get_fraction_loaded(self) -> float:
        return 0.75


class _Manager:
    def get_model(self):
        return _Model()


class _Health:
    def __init__(self, generation):
        self.live_generation = generation


def _answer(layer_mod, web_mod, query, headers, generation):
    ctx = web_mod.ServingContext(_Manager(), None, None, health=_Health(generation))
    req = web_mod.Request("GET", "/metrics", {}, query, headers)
    resp = layer_mod._metrics(ctx, req)
    accept = next((v for k, v in headers.items() if k.lower() == "accept"), "")
    status, payload, ct, _ = web_mod.render(resp, accept)
    return status, payload.decode("utf-8"), ct


def _port_only_line(line: str) -> bool:
    name = line.split(" ")[2] if line.startswith("# ") else line
    return name.startswith(tuple(p.replace(".", "_") for p in PORT_ONLY))


@pytest.mark.parametrize("generation", ["1700000000000", "gen-a"], ids=["numeric", "named"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_negotiates_as_the_jax_layer_does(case, generation):
    query, headers = CASES[case]
    j_status, j_body, j_ct = _answer(jlayer, jweb, query, headers, generation)
    t_status, t_body, t_ct = _answer(tlayer, tweb, query, headers, generation)
    assert (t_status, t_ct) == (j_status, j_ct) == (
        200, tmetrics.PROMETHEUS_CONTENT_TYPE if case in TEXT_CASES else "application/json")
    if case in TEXT_CASES:
        port_lines = [ln for ln in t_body.splitlines() if not _port_only_line(ln)]
        assert port_lines == j_body.splitlines()
        assert "serving_model_fraction_loaded 0.75" in port_lines
        assert any(ln.startswith("kernels_") for ln in t_body.splitlines())
        live = [ln for ln in port_lines if ln.startswith("serving_model_live_generation")]
        if generation.isdigit():
            assert len(live) == 1 and float(live[0].split()[1]) == float(generation)
        else:
            assert live == []
    else:
        got, want = json.loads(t_body), json.loads(j_body)
        assert {k: v for k, v in got.items() if not k.startswith(PORT_ONLY)} == want
        assert got["serving.model.fraction_loaded"] == {"type": "gauge", "value": 0.75}
        assert got["serving.model.live_generation"]["value"] == generation
        assert any(k.startswith("kernels.") for k in got)


def test_metrics_without_a_model_or_generation():
    ctx = tweb.ServingContext(None, None, None, health=_Health(None))
    body = tlayer._metrics(ctx, tweb.Request("GET", "/metrics", {}, {}, {})).body
    assert "serving.model.fraction_loaded" not in body
    assert "serving.model.live_generation" not in body


def test_metrics_refreshes_the_resource_ledger(monkeypatch):
    monkeypatch.setenv("ORYX_RESOURCE_LEDGER", "1")
    calls = []
    monkeypatch.setattr(tledger.ledger, "refresh", lambda: calls.append(1) or {})
    ctx = tweb.ServingContext(None, None, None)
    tlayer._metrics(ctx, tweb.Request("GET", "/metrics", {}, {}, {}))
    assert calls == [1]
    monkeypatch.setenv("ORYX_RESOURCE_LEDGER", "0")
    tlayer._metrics(ctx, tweb.Request("GET", "/metrics", {}, {}, {}))
    assert calls == [1]


@pytest.mark.parametrize("front", ["stdlib", "native"])
def test_a_serving_layer_negotiates_behind_either_front(front):
    if front == "native" and get_library() is None:
        pytest.skip("g++ unavailable")
    loc = f"inproc://metrics-{front}"
    layer = tlayer.ServingLayer(tconfig.get_default().with_overlay(f"""
        oryx {{
          input-topic.broker = "{loc}"
          update-topic.broker = "{loc}"
          serving {{
            api.port = 0
            native.enabled = {"true" if front == "native" else "false"}
            model-manager-class = "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"
            application-resources = "oryx_tpu_torch.app.als.endpoints"
          }}
        }}"""))
    layer.start()
    try:
        assert (layer._native_front is not None) == (front == "native")
        base = f"http://127.0.0.1:{layer.port}/metrics"
        for url, headers, want in (
            (base, {}, "application/json"),
            (base + "?format=prometheus", {}, tmetrics.PROMETHEUS_CONTENT_TYPE),
            (base, {"Accept": "text/plain;version=0.0.4"}, tmetrics.PROMETHEUS_CONTENT_TYPE),
            (base + "?format=json", {"Accept": "text/plain"}, "application/json"),
        ):
            req = urllib.request.Request(url, headers=headers)
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.status == 200
                assert resp.headers["Content-Type"] == want
                body = resp.read().decode()
            if want == "application/json":
                assert any(k.startswith("kernels.") for k in json.loads(body))
            else:
                assert "# TYPE serving_requests_GET counter" in body
    finally:
        layer.close()
