"""TLS and HTTP Basic auth on the port's ServingLayer against the JAX
package's, on the CPU: the four cases of tests/serving/test_secure_api.py
(TLS round trip, TLS with Basic auth, credentials over plaintext refused,
a keystore without its key refused) run on both packages with the same
outcome, plus the 401's ``WWW-Authenticate`` challenge and a wrong
password."""

import base64
import datetime
import ssl
import urllib.error
import urllib.request

import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.serving.layer import ServingLayer as JaxServingLayer
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.serving.layer import ServingLayer

PACKAGES = {
    "jax": (jconfig, JaxServingLayer, "oryx_tpu"),
    "torch": (tconfig, ServingLayer, "oryx_tpu_torch"),
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()


def self_signed_cert(directory):
    """A throwaway self-signed ``localhost`` cert/key PEM pair, made with
    the cryptography package as the JAX package's test makes its own."""
    pytest.importorskip("cryptography")
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(x509.SubjectAlternativeName([x509.DNSName("localhost")]), critical=False)
        .sign(key, hashes.SHA256())
    )
    cert_path, key_path = directory / "server.pem", directory / "server.key"
    cert_path.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    key_path.write_bytes(
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        )
    )
    return str(cert_path), str(key_path)


def make_config(pkg, broker, **overrides):
    config, _, name = PACKAGES[pkg]
    extra = "\n".join(f"{k} = {v}" for k, v in overrides.items())
    return config.get_default().with_overlay(
        f"""
        oryx {{
          input-topic.broker = "{broker}"
          update-topic.broker = "{broker}"
          serving {{
            api.port = 0
            model-manager-class = "{name}.example.serving:ExampleServingModelManager"
            application-resources = "{name}.example.serving"
            {extra}
          }}
        }}
        """
    )


def https(url, cert_path, headers=None):
    ctx = ssl.create_default_context(cafile=cert_path)
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=5, context=ctx) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def basic(user, password):
    return {"Authorization": "Basic " + base64.b64encode(f"{user}:{password}".encode()).decode()}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_tls_serving_round_trip(tmp_path, pkg):
    cert, key = self_signed_cert(tmp_path)
    layer = PACKAGES[pkg][1](make_config(pkg, f"inproc://secure1-{pkg}", **{
        "api.secure-port": 0, "api.keystore-file": f'"{cert}"', "api.key-file": f'"{key}"',
    }))
    assert layer.use_tls
    layer.start()
    try:
        assert layer._native_front is None  # the native front declines TLS
        status, _, _ = https(f"https://localhost:{layer.port}/ready", cert)
        assert status in (200, 503)
        # a plaintext client against the TLS port fails the handshake
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://localhost:{layer.port}/ready", timeout=3)
    finally:
        layer.close()


def run_auth_case(tmp_path, pkg):
    cert, key = self_signed_cert(tmp_path)
    layer = PACKAGES[pkg][1](make_config(pkg, f"inproc://secure2-{pkg}", **{
        "api.secure-port": 0, "api.keystore-file": f'"{cert}"', "api.key-file": f'"{key}"',
        "api.user-name": '"oryx"', "api.password": '"secret"',
    }))
    layer.start()
    url = f"https://localhost:{layer.port}/ready"
    try:
        assert layer._native_front is None  # nor Basic auth
        out = {
            "none": https(url, cert),
            "wrong": https(url, cert, basic("oryx", "nope")),
            "garbled": https(url, cert, {"Authorization": "Basic !!!"}),
            "right": https(url, cert, basic("oryx", "secret")),
        }
    finally:
        layer.close()
    return {k: (status, body, headers.get("WWW-Authenticate"))
            for k, (status, body, headers) in out.items()}


def test_tls_with_basic_auth(tmp_path):
    for pkg in PACKAGES:
        (tmp_path / pkg).mkdir()
    got = run_auth_case(tmp_path / "torch", "torch")
    assert got == run_auth_case(tmp_path / "jax", "jax")
    for case in ("none", "wrong", "garbled"):
        assert got[case] == (401, b"401 unauthorized\n", 'Basic realm="Oryx"')
    assert got["right"][0] in (200, 503) and got["right"][2] is None


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_credentials_over_plaintext_refused(pkg):
    with pytest.raises(ValueError, match="TLS is not configured"):
        PACKAGES[pkg][1](make_config(pkg, "inproc://secure3",
                                     **{"api.user-name": '"u"', "api.password": '"p"'}))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_keystore_without_key_refused(pkg):
    with pytest.raises(ValueError, match="set together"):
        PACKAGES[pkg][1](make_config(pkg, "inproc://secure4",
                                     **{"api.keystore-file": '"/tmp/x.pem"'}))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_insecure_auth_behind_a_terminator(pkg):
    """``allow-insecure-auth`` lets Basic auth run over plain HTTP (a TLS
    terminator in front): the gate answers 401 without credentials."""
    layer = PACKAGES[pkg][1](make_config(pkg, f"inproc://secure5-{pkg}", **{
        "api.user-name": '"u"', "api.password": '"p"', "api.allow-insecure-auth": "true",
    }))
    layer.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{layer.port}/ready")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 401
        req = urllib.request.Request(f"http://127.0.0.1:{layer.port}/ready", headers=basic("u", "p"))
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                status = resp.status
        except urllib.error.HTTPError as err:
            status = err.code
        assert status in (200, 503)
    finally:
        layer.close()
