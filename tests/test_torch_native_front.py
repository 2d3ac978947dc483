"""The port's native HTTP front (``oryx_tpu_torch/native/httpfront.cpp``
and ``serving/native_front.py``) against its stdlib front, and against
the JAX package's native front, on the CPU.

A client must not be able to tell which front served it: two port
layers on one bus, one per front, holding the same k-means model, answer
the same request bytes with the same response bytes, less the Date
header (and /healthz's staleness seconds, which each layer reads off its
own clock). The cases are ``tests/serving/test_native_front.py``'s, on
the port's k-means app in place of the example app: routes, gzip, the
shed and stale rungs, seeded fuzz with dropped connections, the native
parser's hardening (oversized head and body, bad wire, slowloris,
pipelining, keep-alive concurrency, a mid-request disconnect), and the
declines. The tenant cases run two k-means tenants behind each front: the
path, header and default-tenant forms alike on both, a tenant's own shed
rung answered natively from the pushed tenant table with its per-tenant
counters drained, and the decline above the table's 64 tenants. The fleet
cases wait for the fleet harness. One case holds the
port's layer to the JAX package's, each behind its native front, on the
same request sequence. The rest cover what the layer wires around the
front: the default config's admission ladder and native front, each one
switchable, the generation tracker, drain, and the in-flight count.
"""

from __future__ import annotations

import json
import re
import socket
import threading
import time

import numpy as np
import pytest

from oryx_tpu_torch import native
from oryx_tpu_torch import bus as tbus
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app import pmml as tapp_pmml
from oryx_tpu_torch.app.kmeans.common import ClusterInfo, clusters_to_pmml
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.common import pmml as tpmml
from oryx_tpu_torch.registry import tracking
from oryx_tpu_torch.serving import native_front
from oryx_tpu_torch.serving.layer import ServingLayer

_HAVE_NATIVE = native.get_library() is not None
needs_native = pytest.mark.skipif(not _HAVE_NATIVE, reason="g++ unavailable")

_DATE_RE = re.compile(rb"^Date: [^\r\n]+\r$", re.M)
_STALENESS_RE = re.compile(rb'"staleness_seconds": [0-9.eE+-]+')
_CLEN_RE = re.compile(rb"^Content-Length: \d+\r$", re.M)
GENERATION = "1700000000000"


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


def make_config(broker, **overrides):
    extra = "\n".join(f"{k} = {v}" for k, v in overrides.items())
    return tconfig.get_default().with_overlay(
        f"""
        oryx {{
          input-topic.broker = "{broker}"
          update-topic.broker = "{broker}"
          input-schema {{ num-features = 2, numeric-features = ["0", "1"] }}
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.kmeans.serving:KMeansServingModelManager"
            application-resources = "oryx_tpu_torch.app.kmeans.serving"
            {extra}
          }}
        }}
        """
    )


def kmeans_model(generation: str | None = GENERATION, clusters: int = 2) -> str:
    """A k-means PMML with ``clusters`` centers on the diagonal, 5 apart."""
    schema = InputSchema(make_config("inproc://unused"))
    root = clusters_to_pmml(
        [ClusterInfo(i, np.array([5.0 * i, 5.0 * i]), 10 + i) for i in range(clusters)], schema
    )
    if generation is not None:
        tapp_pmml.add_extension(root, "generation", generation)
    return tpmml.to_string(root)


def publish_model(broker, text: str | None = None) -> None:
    with broker.producer("OryxUpdate") as p:
        p.send("MODEL", text or kmeans_model())


def raw(port, data: bytes, timeout=5.0) -> bytes:
    """One connection: send request bytes, read to EOF."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(data)
        chunks = []
        while True:
            try:
                b = s.recv(65536)
            except (TimeoutError, socket.timeout):
                break
            if not b:
                break
            chunks.append(b)
    return b"".join(chunks)


def request_bytes(method, path, headers=None, body=None) -> bytes:
    h = {"Host": "127.0.0.1", "Connection": "close"}
    if body is not None:
        h["Content-Length"] = str(len(body))
    if headers:
        h.update(headers)
    head = f"{method} {path} HTTP/1.1\r\n" + "".join(f"{k}: {v}\r\n" for k, v in h.items())
    return head.encode("latin-1") + b"\r\n" + (body or b"")


def fetch(port, method="GET", path="/", headers=None, body=None) -> bytes:
    return raw(port, request_bytes(method, path, headers=headers, body=body))


def mask(resp: bytes) -> bytes:
    resp = _DATE_RE.sub(b"Date: <masked>\r", resp)
    if b'"staleness_seconds"' in resp:
        resp = _STALENESS_RE.sub(b'"staleness_seconds": 0', resp)
        resp = _CLEN_RE.sub(b"Content-Length: <masked>\r", resp)
    return resp


def wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def is_200(port, path="/ready") -> bool:
    return fetch(port, path=path).startswith(b"HTTP/1.1 200")


class Pair:
    """Two identically configured port layers on one bus, one per front."""

    def __init__(self, broker_loc, **overrides):
        self.broker = tbus.get_broker(broker_loc)
        self.native = ServingLayer(
            make_config(broker_loc, **{"native.enabled": '"true"'}, **overrides)
        )
        self.python = ServingLayer(
            make_config(broker_loc, **{"native.enabled": '"false"'}, **overrides)
        )
        self.native.start()
        self.python.start()
        assert self.native._native_front is not None, "native front must start"
        assert self.python._native_front is None

    def close(self):
        self.native.close()
        self.python.close()

    def layers(self):
        return (self.native, self.python)

    def tick(self):
        """Force a native control tick so pushed state is current."""
        self.native._native_front.push_control()

    def loaded(self):
        for layer in self.layers():
            assert wait_for(lambda l=layer: is_200(l.port)), "model not applied"
        self.tick()

    def assert_parity(self, method, path, headers=None, body=None, label=""):
        a = mask(fetch(self.native.port, method, path, headers, body))
        b = mask(fetch(self.python.port, method, path, headers, body))
        assert a == b, (
            f"byte divergence on {method} {path} {label}\nnative: {a!r}\npython: {b!r}"
        )
        return a


@pytest.fixture()
def pair(request):
    name = re.sub(r"[^a-z0-9]+", "-", request.node.name.lower())[:48]
    p = Pair(f"inproc://tnf-{name}")
    try:
        yield p
    finally:
        p.close()


def _pin_stage(layer, stage: int) -> None:
    """Freeze one layer's admission ladder at ``stage``."""
    adm = layer.admission
    assert adm is not None
    adm.evaluate = lambda *a, **k: adm._stage  # the instance attribute shadows the method
    adm._stage = stage


def _assign_lines(n: int) -> bytes:
    return b"\n".join(b"%d,%d" % (i % 7, (i * 3) % 11) for i in range(n))


# -- byte parity: routes, methods, errors -----------------------------------------


@needs_native
def test_parity_basic_routes(pair):
    pair.tick()
    for path in ("/ready", "/healthz", "/readyz", "/assign/1,1"):
        pair.assert_parity("GET", path, label="(pre-model)")
    publish_model(pair.broker)
    pair.loaded()
    for path in ("/", "/ready", "/healthz", "/readyz", "/assign/1,1", "/assign/4.5,4",
                 "/distanceToNearest/1,2"):
        pair.assert_parity("GET", path)
    pair.assert_parity("GET", "/assign/1,1?x=1&y=2")
    pair.assert_parity("GET", "/assign/1,1?x=%20a&x=b")
    pair.assert_parity("GET", "/nope")
    pair.assert_parity("GET", "/assign/not,a,point")
    pair.assert_parity("DELETE", "/assign/1,1")
    pair.assert_parity("GET", "/../etc/passwd")
    pair.assert_parity("POST", "/add", body=b"1,2\n3,4\n")
    pair.assert_parity("POST", "/assign", body=b"0,0\n5,5\n")
    head = pair.assert_parity("HEAD", "/assign/1,1")
    assert head.endswith(b"\r\n\r\n")
    pair.assert_parity("GET", "/assign/1,1", headers={"Accept": "text/csv"})
    pair.assert_parity("POST", "/assign", headers={"Accept": "text/csv,application/json"},
                       body=b"0,0\n5,5\n")
    healthz = json.loads(mask(fetch(pair.native.port, path="/healthz")).split(b"\r\n\r\n", 1)[1])
    assert healthz["live_generation"] == GENERATION and healthz["shed_stage"] == "full"


@needs_native
def test_parity_gzip_large_body(pair):
    publish_model(pair.broker)
    pair.loaded()
    body = _assign_lines(400)
    resp = pair.assert_parity("POST", "/assign", headers={"Accept-Encoding": "gzip"}, body=body)
    assert b"Content-Encoding: gzip" in resp
    plain = pair.assert_parity("POST", "/assign", body=body)
    assert b"Content-Encoding" not in plain
    # a gzip request body decodes alike on both fronts
    import gzip

    pair.assert_parity("POST", "/assign", headers={"Content-Encoding": "gzip"},
                       body=gzip.compress(b"0,0\n5,5\n", mtime=0))


# -- byte parity: overload rungs --------------------------------------------------


@needs_native
def test_parity_shed_rung(pair):
    publish_model(pair.broker)
    pair.loaded()
    for layer in pair.layers():
        _pin_stage(layer, 3)
    pair.tick()
    before = metrics.registry.counter("serving.http.native-answered.shed").value
    shed = pair.assert_parity("GET", "/assign/1,1", label="(stage=shed)")
    assert shed.startswith(b"HTTP/1.1 429")
    assert b"Retry-After: 1\r\n" in shed and b"X-Oryx-Shed-Stage: shed" in shed
    post = pair.assert_parity("POST", "/add", body=b"1,1\n", label="(shed)")
    assert post.startswith(b"HTTP/1.1 429")
    ready = pair.assert_parity("GET", "/ready", label="(shed-exempt)")
    assert ready.startswith(b"HTTP/1.1 200")
    healthz = pair.assert_parity("GET", "/healthz", label="(shed-exempt)")
    assert b'"shed_stage": "shed"' in healthz and b'"status": "degraded"' in healthz
    pair.tick()
    assert metrics.registry.counter("serving.http.native-answered.shed").value > before


@needs_native
def test_parity_stale_rung(pair):
    publish_model(pair.broker)
    pair.loaded()
    for layer in pair.layers():
        assert layer.health.live_generation == GENERATION  # from the MODEL's extension
    primed = pair.assert_parity("GET", "/assign/1,1", label="(prime)")
    assert primed.startswith(b"HTTP/1.1 200") and b"X-Oryx-Shed-Stage" not in primed
    pair.tick()  # mirrors the cache entry into C++
    for layer in pair.layers():
        _pin_stage(layer, 2)
    pair.tick()
    before = metrics.registry.counter("serving.http.native-answered.stale").value
    stale = pair.assert_parity("GET", "/assign/1,1", label="(stage=stale)")
    assert stale.startswith(b"HTTP/1.1 200") and b"X-Oryx-Shed-Stage: stale" in stale
    pair.assert_parity("HEAD", "/assign/1,1", label="(stale HEAD)")
    # a miss falls through to a reduced-probe dispatch on both
    miss = pair.assert_parity("GET", "/assign/1,1?other=1", label="(stale miss)")
    assert b"X-Oryx-Shed-Stage: reduced-probe" in miss
    pair.tick()
    assert metrics.registry.counter("serving.http.native-answered.stale").value > before
    # a new champion empties both caches: full dispatch again
    for layer in pair.layers():
        layer.health.live_generation = "1800000000000"
    pair.tick()
    swapped = pair.assert_parity("GET", "/assign/1,1", label="(post-swap)")
    assert b"X-Oryx-Shed-Stage: reduced-probe" in swapped


@needs_native
def test_parity_reduced_probe_rung(pair):
    publish_model(pair.broker)
    pair.loaded()
    for layer in pair.layers():
        _pin_stage(layer, 1)
    pair.tick()
    resp = pair.assert_parity("GET", "/assign/4,4", label="(stage=reduced-probe)")
    assert b"X-Oryx-Shed-Stage: reduced-probe" in resp
    # the cache is fed at full only
    for layer in pair.layers():
        assert len(layer.admission.cache) == 0


# -- seeded fuzz with dropped connections -------------------------------------------


@needs_native
def test_parity_fuzz_with_connection_drops(pair):
    import random

    publish_model(pair.broker)
    pair.loaded()
    rng = random.Random(1234)
    paths = ["/", "/ready", "/assign/%d,%d", "/nope", "/assign/1,1?q=%d", "/add",
             "/distanceToNearest/%d,%d"]
    accepts = [None, "application/json", "text/csv", "*/*"]
    for i in range(40):
        path = rng.choice(paths)
        if path.count("%d") == 2:
            path = path % (rng.randrange(10), rng.randrange(10))
        elif "%d" in path:
            path = path % rng.randrange(100)
        method = "POST" if path == "/add" else rng.choice(["GET", "HEAD"])
        headers = {}
        a = rng.choice(accepts)
        if a:
            headers["Accept"] = a
        if rng.random() < 0.3:
            headers["X-Fuzz"] = f"v{i}"
        body = b"%d,%d\n" % (i, i) if method == "POST" else None
        pair.assert_parity(method, path, headers or None, body, label=f"#{i}")
        if rng.random() < 0.25:
            frag = f"GET /assign/1,1 HTTP/1.1\r\nHost: x\r\nX-Part: {i}".encode()
            for layer in pair.layers():
                s = socket.create_connection(("127.0.0.1", layer.port), 5)
                s.sendall(frag)
                s.close()


# -- hardening: the native parser's own attack surface -------------------------------


@needs_native
def test_native_rejects_oversized_header():
    p = Pair("inproc://tnf-hard-hdr", **{"native.max-header-bytes": "512"})
    try:
        resp = raw(p.native.port,
                   b"GET / HTTP/1.1\r\nHost: x\r\nX-Big: " + b"a" * 1024 + b"\r\n\r\n")
        assert resp.startswith(b"HTTP/1.1 431"), resp[:64]
    finally:
        p.close()


@needs_native
def test_native_rejects_oversized_body():
    p = Pair("inproc://tnf-hard-body", **{"native.max-body-bytes": "1024"})
    try:
        resp = fetch(p.native.port, "POST", "/add", body=b"z" * 4096)
        assert resp.startswith(b"HTTP/1.1 413"), resp[:64]
    finally:
        p.close()


@needs_native
@pytest.mark.parametrize("wire, status", [
    (b"BREW / HTTP/1.1\r\nHost: x\r\n\r\n", b"501"),
    (b"GET / HTTP/2.0\r\nHost: x\r\n\r\n", b"505"),
    (b"complete garbage\r\n\r\n", b"400"),
])
def test_native_rejects_bad_wire(pair, wire, status):
    resp = raw(pair.native.port, wire)
    assert resp.startswith(b"HTTP/1.1 " + status)
    # the documented divergence: answered in C++, the native Server token
    assert b"Server: oryx_tpu\r\n" in resp


@needs_native
def test_native_slowloris_reaped():
    p = Pair("inproc://tnf-slowloris", **{"native.idle-timeout-s": "0.5"})
    try:
        s = socket.create_connection(("127.0.0.1", p.native.port), 5)
        s.sendall(b"GET /ready HTTP/1.1\r\nHost: x\r\nX-Slow")  # never finishes
        s.settimeout(5.0)
        t0 = time.monotonic()
        got = s.recv(4096)
        assert time.monotonic() - t0 < 4.0
        if got:
            assert got.startswith(b"HTTP/1.1 408")
        s.close()
        assert fetch(p.native.port, path="/healthz").startswith(b"HTTP/1.1 ")
    finally:
        p.close()


@needs_native
def test_native_pipelined_burst_order(pair):
    publish_model(pair.broker)
    pair.loaded()
    points = [(0, 0), (5, 5), (1, 0), (4, 6), (0, 1)]
    reqs = b"".join(
        f"GET /assign/{x},{y} HTTP/1.1\r\nHost: x\r\n\r\n".encode() for x, y in points
    ) + b"GET /ready HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
    resp = raw(pair.native.port, reqs)
    assert re.findall(rb"HTTP/1\.1 (\d{3})", resp) == [b"200"] * 6
    # answers come back in request order: each body is its point's cluster
    bodies = re.findall(rb'\r\n\r\n"(\d)"', resp)
    assert bodies == [b"0", b"1", b"0", b"1", b"0"]


@needs_native
def test_native_keepalive_concurrent(pair):
    import http.client

    publish_model(pair.broker)
    pair.loaded()
    errors = []

    def hammer(n):
        conn = http.client.HTTPConnection("127.0.0.1", pair.native.port, timeout=10)
        try:
            for i in range(20):
                conn.request("GET", f"/assign/{n % 2 * 5},{n % 2 * 5 + i % 2}")
                r = conn.getresponse()
                body = r.read()
                if r.status != 200 or body != (b'"1"' if n % 2 else b'"0"'):
                    errors.append((n, i, r.status, body))
        except Exception as e:  # noqa: BLE001
            errors.append((n, "exc", repr(e)))
        finally:
            conn.close()

    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors[:5]


@needs_native
def test_native_mid_request_disconnect_is_isolated(pair):
    publish_model(pair.broker)
    pair.loaded()
    s = socket.create_connection(("127.0.0.1", pair.native.port), 5)
    s.sendall(b"GET /assign/1,1 HTTP/1.1\r\nHost: x\r\n\r\n")
    s.close()
    for _ in range(3):
        assert fetch(pair.native.port, path="/assign/1,1").startswith(b"HTTP/1.1 200")


# -- declines: the stdlib front serves identically -----------------------------------


def test_fallback_enabled_false_serves_identically():
    broker_loc = "inproc://tnf-fallback-off"
    layer = ServingLayer(make_config(broker_loc, **{"native.enabled": '"false"'}))
    layer.start()
    try:
        assert layer._native_front is None and layer._server is not None
        publish_model(tbus.get_broker(broker_loc))
        assert wait_for(lambda: is_200(layer.port))
        resp = fetch(layer.port, path="/assign/5,5")
        assert resp.startswith(b"HTTP/1.1 200")
        assert json.loads(resp.split(b"\r\n\r\n", 1)[1]) == "1"
    finally:
        layer.close()


def test_fallback_auto_without_toolchain(monkeypatch):
    monkeypatch.setattr(native, "get_library", lambda *a, **k: None)
    broker_loc = "inproc://tnf-fallback-auto"
    layer = ServingLayer(make_config(broker_loc))  # enabled = "auto"
    layer.start()
    try:
        assert layer._native_front is None
        publish_model(tbus.get_broker(broker_loc))
        assert wait_for(lambda: is_200(layer.port))
        assert fetch(layer.port, path="/assign/1,1").startswith(b"HTTP/1.1 200")
    finally:
        layer.close()


def test_forced_true_without_toolchain_falls_back(monkeypatch, caplog):
    monkeypatch.setattr(native, "get_library", lambda *a, **k: None)
    layer = ServingLayer(make_config("inproc://tnf-forced", **{"native.enabled": '"true"'}))
    with caplog.at_level("WARNING"):
        layer.start()
    try:
        assert layer._native_front is None
        assert any("falling back" in r.message for r in caplog.records)
    finally:
        layer.close()


def test_oryx_native_0_declines(monkeypatch):
    monkeypatch.setenv("ORYX_NATIVE", "0")
    assert native.get_library() is None
    layer = ServingLayer(make_config("inproc://tnf-env-off"))
    layer.start()
    try:
        assert layer._native_front is None and layer._server is not None
    finally:
        layer.close()


def test_bad_native_mode_raises():
    layer = ServingLayer(make_config("inproc://tnf-bad-mode", **{"native.enabled": '"maybe"'}))
    try:
        with pytest.raises(ValueError, match="auto/true/false"):
            layer.start()
    finally:
        layer.close()


def _front_outcome(pkg, tmp_path, settings, caplog):
    """Start ``pkg``'s layer with ``native.enabled = "true"`` and
    ``settings``: "ValueError: <message>", or which front serves and
    whether the decline was logged."""
    import importlib

    if pkg == "oryx_tpu":
        from oryx_tpu import native as pkg_native

        if pkg_native.get_library() is None:
            pytest.skip("the JAX package's native library did not build")
    pkg_config = importlib.import_module(f"{pkg}.common.config")
    pkg_layer = importlib.import_module(f"{pkg}.serving.layer")
    extra = "\n".join(f"{k} = {v}" for k, v in settings.items())
    cfg = pkg_config.get_default().with_overlay(f"""
        oryx {{
          input-topic.broker = "inproc://tnf-auth-{pkg}"
          update-topic.broker = "inproc://tnf-auth-{pkg}"
          input-schema {{ num-features = 2, numeric-features = ["0", "1"] }}
          serving {{
            api.port = 0
            api.secure-port = 0
            native.enabled = "true"
            model-manager-class = "{pkg}.app.kmeans.serving:KMeansServingModelManager"
            application-resources = "{pkg}.app.kmeans.serving"
            {extra}
          }}
        }}""")
    try:
        layer = pkg_layer.ServingLayer(cfg)
    except ValueError as e:
        return f"ValueError: {e}"
    caplog.clear()
    with caplog.at_level("WARNING"):
        layer.start()
    try:
        front = "native" if layer._native_front is not None else "stdlib"
        declined = any("TLS/auth is configured" in r.getMessage() for r in caplog.records)
        return front, declined
    finally:
        layer.close()


@needs_native
@pytest.mark.parametrize("key, value", [
    ("api.user-name", '"u"'), ("api.password", '"p"'), ("api.key-file", '"/k.pem"'),
    ("api.keystore-file", "cert"),
])
def test_tls_and_auth_decline_the_native_front(tmp_path, caplog, key, value):
    """The settings once refused now start as they do in the JAX package:
    Basic auth (over plain HTTP behind ``allow-insecure-auth``) and TLS
    make a forced native front decline, logged, and the stdlib front
    serve; a lone password names no user and keeps the native front; a
    key file without its keystore is a ValueError."""
    settings = {key: value}
    if key == "api.user-name":
        settings.update({"api.password": '"p"', "api.allow-insecure-auth": "true"})
    if key == "api.keystore-file":
        from test_torch_secure_api import self_signed_cert

        cert, pem_key = self_signed_cert(tmp_path)
        settings = {key: f'"{cert}"', "api.key-file": f'"{pem_key}"'}
    got = _front_outcome("oryx_tpu_torch", tmp_path, settings, caplog)
    assert got == _front_outcome("oryx_tpu", tmp_path, settings, caplog)
    want = {
        "api.user-name": ("stdlib", True),
        "api.password": ("native", False),
        "api.key-file": "ValueError: oryx.serving.api.keystore-file and key-file must be set "
                        "together",
        "api.keystore-file": ("stdlib", True),
    }[key]
    assert got == want


# -- tenants: the tenant table and its counters ------------------------------------

TENANTS = 'tenancy { enabled = true, default-tenant = %s, tenants { %s } }'
TWO_TENANTS = 'acme { app = "kmeans", weight = 2.0 }, bob { app = "kmeans", weight = 1.0 }'


def tenant_config(broker, tenants_block, default="acme", **overrides):
    return make_config(broker, **overrides).with_overlay(
        "oryx { %s }" % (TENANTS % (json.dumps(default), tenants_block))
    )


class TenantPair(Pair):
    """Pair's two fronts, each layer serving the tenants acme (2 centers,
    the default tenant) and bob (3 centers) from their own update topics."""

    def __init__(self, broker_loc, max_queue=None):
        self.broker = tbus.get_broker(broker_loc)
        extra = {} if max_queue is None else {"overload.max-queue": str(max_queue)}
        self.native, self.python = (
            ServingLayer(tenant_config(broker_loc, TWO_TENANTS,
                                       **{"native.enabled": mode}, **extra))
            for mode in ('"true"', '"false"')
        )
        self.native.start()
        self.python.start()
        assert self.native._native_front is not None, "native front must start"
        assert self.python._native_front is None
        for tid, clusters in (("acme", 2), ("bob", 3)):
            with self.broker.producer(f"OryxUpdate.{tid}") as p:
                p.send("MODEL", kmeans_model(clusters=clusters))


@pytest.fixture()
def tenant_pair(request):
    name = re.sub(r"[^a-z0-9]+", "-", request.node.name.lower())[:48]
    p = TenantPair(f"inproc://tnf-{name}", max_queue=64)
    try:
        p.loaded()
        yield p
    finally:
        p.close()


@needs_native
def test_parity_tenants(tenant_pair):
    """tests/serving/test_native_front.py::test_parity_tenants on the port:
    the path-scoped, header-scoped and default-tenant forms, an unknown
    tenant and a tenant's control path answer alike on both fronts."""
    pair = tenant_pair
    # at (9, 9) acme's nearest of its centers (0, 0), (5, 5) is 1, bob's
    # of (0, 0), (5, 5), (10, 10) is 2: each form reaches its own tenant
    r = pair.assert_parity("GET", "/t/acme/assign/9,9")
    assert r.startswith(b"HTTP/1.1 200") and r.endswith(b'"1"')
    r = pair.assert_parity("GET", "/assign/9,9", headers={"X-Oryx-Tenant": "bob"})
    assert r.endswith(b'"2"')
    r = pair.assert_parity("GET", "/t/bob/assign/9,9", headers={"X-Oryx-Tenant": "acme"})
    assert r.endswith(b'"2"')  # the prefix wins over the header
    r = pair.assert_parity("GET", "/assign/9,9")  # the default tenant, acme
    assert r.endswith(b'"1"')
    nope = pair.assert_parity("GET", "/t/nope/assign/1,1")
    assert nope.startswith(b"HTTP/1.1 404")
    pair.assert_parity("GET", "/t/acme/nope")
    ready = pair.assert_parity("GET", "/t/acme/ready")
    assert ready.startswith(b"HTTP/1.1 200")
    healthz = json.loads(mask(fetch(pair.native.port, path="/healthz")).split(b"\r\n\r\n", 1)[1])
    assert healthz["tenants"] == {"acme": GENERATION, "bob": GENERATION}
    pair.assert_parity("GET", "/healthz")


@needs_native
def test_native_front_sheds_one_tenant_from_its_table(tenant_pair):
    """A tenant's own ladder at shed reaches the C++ table on the next
    control tick: its requests are answered 429 natively (the same bytes
    as the stdlib front's), the other tenant's are served, and the drained
    stats slots count the tenant's requests and sheds on the layer's own
    registry."""
    pair = tenant_pair
    for layer in pair.layers():
        adm = layer.admission
        adm.evaluate = lambda *a, **k: adm._stage  # freeze the ladders
        adm._tenants["bob"].stage = 3
    pair.tick()
    im = pair.native.instance_metrics
    shed_before = im.counter("serving.overload.shed.shed.tenant.bob").value
    req_before = im.counter("serving.requests.tenant.bob").value
    native_before = metrics.registry.counter("serving.http.native-answered.shed").value
    shed = pair.assert_parity("GET", "/t/bob/assign/1,1", label="(bob at shed)")
    assert shed.startswith(b"HTTP/1.1 429") and b"X-Oryx-Shed-Stage: shed" in shed
    pair.assert_parity("GET", "/assign/1,1", headers={"X-Oryx-Tenant": "bob"})
    ok = pair.assert_parity("GET", "/t/acme/assign/1,1", label="(acme at full)")
    assert ok.startswith(b"HTTP/1.1 200")
    pair.tick()  # drains the stats
    assert metrics.registry.counter("serving.http.native-answered.shed").value >= native_before + 2
    assert im.counter("serving.overload.shed.shed.tenant.bob").value == shed_before + 2
    assert im.counter("serving.requests.tenant.bob").value == req_before + 2
    # the forwarded acme request counted through the layer's dispatch core
    assert im.counter("serving.requests.tenant.acme").value >= 1
    py = pair.python.instance_metrics
    assert py.counter("serving.overload.shed.shed.tenant.bob").value == 2


@needs_native
def test_native_front_declines_above_64_tenants():
    """The C++ tenant table holds 64 tenants: a layer with 65 declines the
    native front even when it is forced on, and the stdlib front serves
    every tenant."""
    block = ", ".join(f't{i} {{ app = "kmeans" }}' for i in range(65))
    layer = ServingLayer(tenant_config("inproc://tnf-65", block, "t0", **{"native.enabled": '"true"'}))
    layer.start()
    try:
        assert layer._native_front is None
        assert len(layer.tenants.ids()) == 65
        with tbus.get_broker("inproc://tnf-65").producer("OryxUpdate.t64") as p:
            p.send("MODEL", kmeans_model(clusters=3))
        assert wait_for(lambda: fetch(layer.port, path="/t/t64/assign/11,11").endswith(b'"2"'))
        assert fetch(layer.port, path="/t/t3/assign/1,1").startswith(b"HTTP/1.1 503")
    finally:
        layer.close()
    # 64 fit: the native front starts
    block = ", ".join(f't{i} {{ app = "kmeans" }}' for i in range(64))
    layer = ServingLayer(tenant_config("inproc://tnf-64", block, "t0", **{"native.enabled": '"true"'}))
    layer.start()
    try:
        assert layer._native_front is not None
    finally:
        layer.close()


# -- the default request path ----------------------------------------------------


@needs_native
@pytest.mark.parametrize("overrides, admission, front", [
    ({}, True, True),
    ({"overload.enabled": "false"}, False, True),
    ({"native.enabled": '"false"'}, True, False),
    ({"overload.enabled": "false", "native.enabled": '"false"'}, False, False),
])
def test_default_config_runs_the_ladder_and_the_native_front(overrides, admission, front):
    layer = ServingLayer(make_config("inproc://tnf-defaults", **overrides))
    layer.start()
    try:
        assert (layer.admission is not None) == admission
        assert (layer._native_front is not None) == front
        assert layer.overload_config.enabled == admission
        if front:
            assert layer._native_front._flags() == (7 if admission else 1)
        publish_model(tbus.get_broker("inproc://tnf-defaults"))
        assert wait_for(lambda: is_200(layer.port))
        body = fetch(layer.port, path="/healthz").split(b"\r\n\r\n", 1)[1]
        assert json.loads(body)["shed_stage"] == "full"
    finally:
        layer.close()


@needs_native
def test_tracker_suppresses_a_duplicate_model(pair):
    dup = metrics.registry.counter(tracking.DUPLICATES_COUNTER)
    before = dup.value
    text = kmeans_model()
    publish_model(pair.broker, text)
    pair.loaded()
    loaded = [layer.model_manager.get_model() for layer in pair.layers()]
    publish_model(pair.broker, text)  # the same generation again
    assert wait_for(lambda: dup.value >= before + 2)  # once per layer
    # the manager never saw it: the model object is the one loaded first
    assert [layer.model_manager.get_model() for layer in pair.layers()] == loaded
    publish_model(pair.broker, kmeans_model("1800000000000", clusters=3))
    for layer in pair.layers():
        assert wait_for(lambda l=layer: l.health.live_generation == "1800000000000")
        assert wait_for(lambda l=layer: len(l.model_manager.get_model().clusters()) == 3)
    pair.tick()
    pair.assert_parity("GET", "/healthz")


@needs_native
def test_begin_drain_flips_readiness_on_both_fronts(pair):
    publish_model(pair.broker)
    pair.loaded()
    for layer in pair.layers():
        layer.begin_drain()
    # the native snapshots were pushed by begin_drain, not by a tick
    for path in ("/ready", "/readyz"):
        resp = pair.assert_parity("GET", path, label="(draining)")
        assert resp.startswith(b"HTTP/1.1 503")
    healthz = pair.assert_parity("GET", "/healthz", label="(draining)")
    assert b'"status": "draining"' in healthz
    for layer in pair.layers():
        assert layer.drain(timeout=5)


@needs_native
@pytest.mark.parametrize("pkg", ["oryx_tpu", "oryx_tpu_torch"])
def test_forwarded_requests_count_in_flight_once_a_worker_takes_them(pkg):
    """With two dispatch workers, six held requests read two in flight in
    either package: the native front's backlog beyond its pool is not the
    admission ladder's in-flight signal."""
    import importlib

    if pkg == "oryx_tpu":
        from oryx_tpu import native as pkg_native

        if pkg_native.get_library() is None:
            pytest.skip("the JAX package's native library did not build")
    pkg_bus = importlib.import_module(f"{pkg}.bus")
    pkg_config = importlib.import_module(f"{pkg}.common.config")
    pkg_layer = importlib.import_module(f"{pkg}.serving.layer")
    broker_loc = f"inproc://tnf-inflight-{pkg}"
    layer = pkg_layer.ServingLayer(pkg_config.get_default().with_overlay(f"""
        oryx {{
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          input-schema {{ num-features = 2, numeric-features = ["0", "1"] }}
          serving {{
            api.port = 0
            native.enabled = "true"
            native.dispatch-threads = 2
            model-manager-class = "{pkg}.app.kmeans.serving:KMeansServingModelManager"
            application-resources = "{pkg}.app.kmeans.serving"
          }}
        }}"""))
    layer.start()
    gate, started = threading.Event(), []
    dispatch = layer.router.dispatch

    def held(ctx, req):
        if req.path.startswith("/distanceToNearest"):
            started.append(req.path)
            gate.wait(10)
        return dispatch(ctx, req)

    layer.router.dispatch = held
    threads = []
    try:
        assert layer._native_front is not None
        with pkg_bus.get_broker(broker_loc).producer("OryxUpdate") as p:
            p.send("MODEL", kmeans_model())
        assert wait_for(lambda: is_200(layer.port))
        threads = [
            threading.Thread(target=fetch, args=(layer.port, "GET", f"/distanceToNearest/{i},0"))
            for i in range(6)
        ]
        for t in threads:
            t.start()
        # the other four were forwarded and wait in the dispatch pool's queue
        pool = layer._native_front._pool
        assert wait_for(lambda: len(started) == 2 and pool._work_queue.qsize() == 4)
        assert layer.inflight_requests == 2
        assert len(started) == 2  # only two workers dispatch
        gate.set()
        for t in threads:
            t.join(10)
        assert wait_for(lambda: layer.inflight_requests == 0)
        assert len(started) == 6
    finally:
        gate.set()
        layer.close()


def test_gzip_compress_is_deterministic():
    from oryx_tpu_torch.serving.layer import gzip_compress

    body = b"x" * 5000
    assert gzip_compress(body) == gzip_compress(body)
    import gzip

    assert gzip.decompress(gzip_compress(body)) == body


def test_server_token_is_the_jax_packages():
    import sys

    assert native_front._SERVER == f"oryx_tpu Python/{sys.version.split()[0]}"


# -- across packages ----------------------------------------------------------------


@needs_native
def test_port_and_jax_package_native_fronts_answer_alike():
    """The JAX layer and the port's, each behind its native front, each
    holding the same k-means model: the same request sequence gives the
    same bytes, less Date (and /healthz's staleness seconds)."""
    from oryx_tpu import bus as jbus
    from oryx_tpu import native as jnative
    from oryx_tpu.common import config as jconfig
    from oryx_tpu.serving.layer import ServingLayer as JServingLayer

    if jnative.get_library() is None:
        pytest.skip("the JAX package's native library did not build")
    overlay = """
        oryx {{
          input-topic.broker = "{loc}"
          update-topic.broker = "{loc}"
          input-schema {{ num-features = 2, numeric-features = ["0", "1"] }}
          serving {{
            api.port = 0
            native.enabled = "true"
            model-manager-class = "{pkg}.app.kmeans.serving:KMeansServingModelManager"
            application-resources = "{pkg}.app.kmeans.serving"
          }}
        }}"""
    text = kmeans_model(clusters=3)
    jlayer = JServingLayer(jconfig.get_default().with_overlay(
        overlay.format(loc="inproc://tnf-cross-jax", pkg="oryx_tpu")))
    tlayer = ServingLayer(tconfig.get_default().with_overlay(
        overlay.format(loc="inproc://tnf-cross-torch", pkg="oryx_tpu_torch")))
    jlayer.start()
    tlayer.start()
    try:
        assert jlayer._native_front is not None and tlayer._native_front is not None
        for front in (jlayer._native_front, tlayer._native_front):
            front.push_control()
        seq = [("GET", "/ready", None), ("GET", "/healthz", None), ("GET", "/readyz", None)]
        pre = [(m, p, b, mask(fetch(layer.port, m, p, body=b)))
               for layer in (jlayer, tlayer) for m, p, b in seq]
        assert [r[3] for r in pre[:3]] == [r[3] for r in pre[3:]]
        with jbus.get_broker("inproc://tnf-cross-jax").producer("OryxUpdate") as p:
            p.send("MODEL", text)
        publish_model(tbus.get_broker("inproc://tnf-cross-torch"), text)
        for layer in (jlayer, tlayer):
            assert wait_for(lambda l=layer: is_200(l.port))
        for front in (jlayer._native_front, tlayer._native_front):
            front.push_control()
        seq += [
            ("GET", "/assign/1,1", None), ("GET", "/assign/9,11", None),
            ("GET", "/distanceToNearest/1,2", None), ("GET", "/distanceToNearest/5,5", None),
            ("HEAD", "/assign/4,4", None), ("GET", "/assign/x,y", None), ("GET", "/nope", None),
            ("DELETE", "/assign/1,1", None), ("POST", "/assign", b"0,0\n5,5\n10,10\n"),
            ("POST", "/assign", _assign_lines(400)), ("GET", "/assign/1,1?q=1", None),
            ("GET", "/ready", None), ("GET", "/healthz", None),
        ]
        for method, path, body in seq:
            headers = {"Accept-Encoding": "gzip"} if body and len(body) > 100 else None
            a = mask(fetch(jlayer.port, method, path, headers, body))
            b = mask(fetch(tlayer.port, method, path, headers, body))
            assert a == b, f"{method} {path}\njax:   {a!r}\ntorch: {b!r}"
        assert jlayer.health.live_generation == tlayer.health.live_generation == GENERATION
    finally:
        jlayer.close()
        tlayer.close()
