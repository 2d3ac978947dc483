"""The HTML consoles on the port against the JAX package's, on the CPU:
each app's page (ALS, k-means, RDF) at ``/`` and ``/index.html`` equal
byte for byte, headers included, and the console module's own cases
(tests/serving/test_console.py) on the port."""

import urllib.error
import urllib.request

import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.serving import console as jconsole
from oryx_tpu.serving.layer import ServingLayer as JaxServingLayer
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.serving import console as tconsole
from oryx_tpu_torch.serving.layer import ServingLayer

PACKAGES = {
    "jax": (jconfig, JaxServingLayer, "oryx_tpu"),
    "torch": (tconfig, ServingLayer, "oryx_tpu_torch"),
}
APPS = {
    "als": ("app.als.serving_model:ALSServingModelManager", "app.als", "Oryx ALS serving console"),
    "kmeans": ("app.kmeans.serving:KMeansServingModelManager", "app.kmeans.serving",
               "Oryx k-means serving console"),
    "rdf": ("app.rdf.serving:RDFServingModelManager", "app.rdf.serving",
            "Oryx random decision forest serving console"),
}

SCHEMAS = {  # the RDF app needs a target, the k-means one refuses it
    "kmeans": 'num-features = 2, numeric-features = ["0", "1"]',
    "rdf": 'num-features = 3, numeric-features = ["0", "1"], target-feature = "2"',
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


def fetch(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def console_pages(pkg, app):
    config, layer_cls, name = PACKAGES[pkg]
    manager, resources, _ = APPS[app]
    layer = layer_cls(config.get_default().with_overlay(f"""
        oryx {{
          input-topic.broker = "inproc://console-{pkg}-{app}"
          update-topic.broker = "inproc://console-{pkg}-{app}"
          input-schema {{ {SCHEMAS.get(app, SCHEMAS["kmeans"])} }}
          serving {{
            api.port = 0
            model-manager-class = "{name}.{manager}"
            application-resources = "{name}.{resources}"
          }}
        }}"""))
    layer.start()
    try:
        out = {}
        for path in ("/", "/index.html"):
            status, body, headers = fetch(f"http://127.0.0.1:{layer.port}{path}")
            out[path] = (status, body, headers["Content-Type"], headers["X-Frame-Options"],
                         headers["Cache-Control"])
        return out
    finally:
        layer.close()


@pytest.mark.parametrize("app", sorted(APPS))
def test_console_page_is_the_jax_packages(app):
    got = console_pages("torch", app)
    assert got == console_pages("jax", app)
    status, body, ctype, frame, cache = got["/"]
    assert (status, ctype, frame, cache) == (200, "text/html", "SAMEORIGIN", "public")
    assert body.startswith(b"<!doctype html>")
    assert f"<h1>{APPS[app][2]}</h1>".encode() in body
    assert got["/index.html"] == got["/"]


FORMS = [
    ("Recommend", "GET", "/recommend/{userID}", ("howMany",), False, ""),
    ("Ingest", "POST", "/ingest", (), True, "user,item lines"),
    ("Sim", "GET", "/similarity/{itemIDs:+}", (), False, ""),
    ("x<y>", "GET", "/p", (), False, ""),
]


@pytest.mark.parametrize("title", ["Test console", "a<b>"])
def test_render_console_matches_jax(title):
    pages = [
        mod.render_console(title, [mod.ConsoleForm(*f) for f in FORMS])
        for mod in (tconsole, jconsole)
    ]
    assert pages[0] == pages[1]
    html = pages[0]
    assert 'name="userID"' in html and 'name="howMany"' in html and 'name="itemIDs"' in html
    assert "/similarity/{itemIDs:+}" in html and "<textarea" in html
    assert "x&lt;y&gt;" in html


def test_console_response_headers():
    resp = tconsole.console_response("<html></html>")
    assert (resp.status, resp.content_type) == (200, "text/html")
    assert resp.headers == {"X-Frame-Options": "SAMEORIGIN", "Cache-Control": "public"}
