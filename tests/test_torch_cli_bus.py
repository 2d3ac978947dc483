"""The port's bus commands (``python -m oryx_tpu_torch bus-setup | bus-input
| bus-tail | bus-serve``) against the JAX package's, each run in a
subprocess over a temporary directory: the same output lines, and the
same topics and records on the bus they write."""

import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from oryx_tpu_torch import bus, cli
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.bus import faultbus
from oryx_tpu_torch.bus.inproc import InProcessBroker

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"port": "oryx_tpu_torch", "jax": "oryx_tpu"}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    faultbus.reset()
    yield
    port_device.set_device(None)
    InProcessBroker.reset_all()
    faultbus.reset()


def _env():
    env = dict(os.environ)
    env.pop("ORYX_CONF", None)
    env["PYTHONPATH"] = str(ROOT)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _conf(d: Path, locator: str | None = None) -> str:
    d.mkdir(parents=True, exist_ok=True)
    loc = locator or f"file:{d}/bus"
    conf = d / "oryx.conf"
    conf.write_text(f'oryx {{\n  id = "CLIBus"\n  input-topic.broker = "{loc}"\n'
                    f'  update-topic.broker = "{loc}"\n}}\n')
    return str(conf)


def _run(pkg: str, *args: str, cwd: Path, stdin: str | None = None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", PACKAGES[pkg], *args], cwd=cwd, env=_env(),
                          input=stdin, capture_output=True, text=True, timeout=120)


def _both(tmp_path, *args, stdin=None, prepare=None):
    """Run one command in each package over its own directory: {pkg:
    (result, its directory)}."""
    out = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        conf = _conf(d)
        if prepare is not None:
            prepare(d)
        out[pkg] = (_run(pkg, *[a.replace("{conf}", conf).replace("{dir}", str(d)) for a in args],
                         cwd=d, stdin=stdin), d)
    return out


def _lines(result, d: Path) -> list[str]:
    assert result.returncode == 0, result.stderr
    return [line.replace(str(d), "<dir>") for line in result.stdout.splitlines()]


def _records(loc: str, topic: str) -> list[tuple]:
    c = bus.get_broker(loc).consumer(topic, from_beginning=True)
    got = []
    while True:
        batch = c.poll(1000, 0.2)
        if not batch:
            break
        got.extend((km.key, km.message) for km in batch)
    c.close()
    return got


def test_the_bus_commands_are_the_jax_packages():
    assert {"bus-setup", "bus-serve", "bus-tail", "bus-input"} <= set(cli.COMMANDS)
    args = cli._build_parser().parse_args(
        ["bus-serve", "--bind", "127.0.0.1:1", "--data-dir", "d", "--from-beginning",
         "--input-file", "f"])
    assert (args.bind, args.data_dir, args.from_beginning, args.input_file) == (
        "127.0.0.1:1", "d", True, "f")


def test_bus_setup_matches_the_jax_package(tmp_path):
    runs = _both(tmp_path, "bus-setup", "--conf", "{conf}")
    lines = {pkg: _lines(*runs[pkg]) for pkg in runs}
    assert lines["port"] == lines["jax"]
    assert lines["port"] == [
        "created (or found) input topic OryxInput (4 partitions) on file:<dir>/bus",
        "created (or found) update topic OryxUpdate (1 partitions) on file:<dir>/bus",
    ]
    for pkg, (_, d) in runs.items():
        broker = bus.get_broker(f"file:{d}/bus")
        assert broker.topic_exists("OryxInput") and broker.topic_exists("OryxUpdate")
        assert set(broker.latest_offsets("OryxInput")) == {0, 1, 2, 3}


@pytest.mark.parametrize("source", ["file", "stdin"])
def test_bus_input_matches_the_jax_package(tmp_path, source):
    data = "u1,i1,1\nu2,i2,2\n\nu3,i3,3\nu1,i3,5\n"

    def prepare(d):
        (d / "in.csv").write_text(data)

    args = ("bus-input", "--conf", "{conf}") + (
        ("--input-file", "{dir}/in.csv") if source == "file" else ())
    runs = _both(tmp_path, *args, stdin=data if source == "stdin" else None, prepare=prepare)
    assert _lines(*runs["port"]) == _lines(*runs["jax"]) == ["sent 4 messages to OryxInput"]
    # keyed by the line's md5, so each line lands in the same partition
    got = {pkg: sorted(_records(f"file:{d}/bus", "OryxInput")) for pkg, (_, d) in runs.items()}
    assert got["port"] == got["jax"]
    assert sorted(m for _, m in got["port"]) == ["u1,i1,1", "u1,i3,5", "u2,i2,2", "u3,i3,3"]


def test_bus_input_of_a_missing_file_fails_alike(tmp_path):
    runs = _both(tmp_path, "bus-input", "--conf", "{conf}", "--input-file", "{dir}/none.csv")
    for pkg, (result, d) in runs.items():
        assert result.returncode == 1
        assert result.stderr.strip().splitlines()[-1].replace(str(d), "<dir>") == (
            "Input file <dir>/none.csv does not exist")


def _tail(pkg: str, conf: str, d: Path, want: int) -> list[str]:
    """bus-tail --from-beginning until it printed ``want`` lines, then
    interrupted."""
    proc = subprocess.Popen([sys.executable, "-m", PACKAGES[pkg], "bus-tail", "--conf", conf,
                             "--from-beginning"], cwd=d, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    lines = []
    try:
        while len(lines) < want:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.rstrip("\n"))
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)
    return lines


def test_bus_tail_matches_the_jax_package(tmp_path):
    got = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        conf = _conf(d)
        broker = bus.get_broker(f"file:{d}/bus")
        broker.create_topic("OryxInput", 2)
        broker.create_topic("OryxUpdate", 1)
        with broker.producer("OryxInput") as p:
            p.send_many([(f"k{j}", f"u{j},i{j},1") for j in range(6)])
        with broker.producer("OryxUpdate") as p:
            p.send_many([("MODEL", "m"), ("UP", '["X","u1",[1.0]]')])
        got[pkg] = sorted(_tail(pkg, conf, d, 8))
    assert got["port"] == got["jax"]
    assert "OryxUpdate\tUP\t[\"X\",\"u1\",[1.0]]" in got["port"]
    assert sum(line.startswith("OryxInput\t") for line in got["port"]) == 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("client", ["port", "jax"])
def test_bus_serve_serves_the_config_file_bus(tmp_path, client):
    """``bus-serve`` with no --data-dir serves the config's file: bus
    directory (file:/// form), run from another directory; the client of
    either package reads what was written through the file path, and
    writes what the file bus reads."""
    from oryx_tpu import bus as jax_bus

    bus_dir = tmp_path / "busdata"
    conf = _conf(tmp_path / "conf", f"file://{bus_dir}")
    fb = bus.get_broker(f"file://{bus_dir}")
    fb.create_topic("T", 1)
    with fb.producer("T") as p:
        p.send("k", "through-the-file-path")
    port = _free_port()
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    proc = subprocess.Popen([sys.executable, "-m", "oryx_tpu_torch", "bus-serve", "--conf", conf,
                             "--bind", f"127.0.0.1:{port}"], cwd=elsewhere, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        get_broker = (bus if client == "port" else jax_bus).get_broker
        net = None
        deadline = time.time() + 60
        while net is None and time.time() < deadline:
            try:
                net = get_broker(f"tcp://127.0.0.1:{port}")
            except OSError:
                time.sleep(0.2)
        assert net is not None, "bus server never came up"
        assert net.topic_exists("T")
        c = net.consumer("T", from_beginning=True)
        got = []
        deadline = time.time() + 10
        while not got and time.time() < deadline:
            got.extend(c.poll(timeout=0.5))
        c.close()
        assert [(km.key, km.message) for km in got] == [("k", "through-the-file-path")]
        with net.producer("T") as p:
            p.send("k2", "through-the-wire")
        assert ("k2", "through-the-wire") in _records(f"file:{bus_dir}", "T")
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out
    assert f"bus-serve: tcp://127.0.0.1:{port} over {bus_dir}" in out


def test_bus_serve_needs_a_data_dir_off_a_file_bus(tmp_path):
    runs = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        conf = _conf(d, "inproc://nowhere")
        runs[pkg] = _run(pkg, "bus-serve", "--conf", conf, "--bind", "127.0.0.1:0", cwd=d)
    for result in runs.values():
        assert result.returncode == 1
    assert runs["port"].stderr.strip().splitlines()[-1] == runs["jax"].stderr.strip().splitlines()[-1] == (
        "--data-dir required (input-topic broker is not a file: path)")
