"""Command-line launcher (counterpart of ``oryx_tpu/cli.py``):

    python -m oryx_tpu_torch batch --conf oryx.conf
    python -m oryx_tpu_torch speed --conf oryx.conf
    python -m oryx_tpu_torch serving --conf oryx.conf
    python -m oryx_tpu_torch bus-setup --conf oryx.conf
    python -m oryx_tpu_torch bus-serve --conf oryx.conf [--bind HOST:PORT] [--data-dir DIR]
    python -m oryx_tpu_torch bus-tail  --conf oryx.conf [--from-beginning]
    python -m oryx_tpu_torch bus-input --conf oryx.conf --input-file data.csv

The three layers are ported; each runs as its own process, and they meet
on the bus the config names (the packaged default is the file bus
``file:/tmp/OryxTPU/bus``). The bus commands are the JAX package's:
``bus-setup`` creates the input and update topics, ``bus-serve`` serves a
bus directory over TCP (``tcp://host:port`` locators), ``bus-tail``
follows both topics and ``bus-input`` sends a file's lines to the input
topic. The other operator commands (``repair``, ``models`` and the rest)
are not ported.
Config layers as in the JAX package: packaged defaults <- ``--conf``
file <- ``--set`` overrides. The config must name the port's classes,
e.g. ``model-manager-class =
"oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"``,
``application-resources = "oryx_tpu_torch.app.als"``, ``update-class =
"oryx_tpu_torch.app.kmeans.update:KMeansUpdate"`` (or
``"oryx_tpu_torch.app.rdf.update:RDFUpdate"``) or, for the speed layer,
``model-manager-class =
"oryx_tpu_torch.app.kmeans.speed:KMeansSpeedModelManager"``; a name under
``oryx_tpu`` is refused.
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import os
import signal
import sys

from oryx_tpu_torch.common import config as config_utils
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.lang import close_at_shutdown

log = logging.getLogger(__name__)

COMMANDS = ("batch", "speed", "serving", "bus-setup", "bus-serve", "bus-tail", "bus-input")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oryx_tpu_torch",
        description="PyTorch/CUDA lambda-architecture ML framework launcher",
    )
    p.add_argument("command", choices=COMMANDS, help="which layer or bus command to run")
    p.add_argument(
        "--conf",
        default=None,
        help="configuration file (HOCON); defaults to ./oryx.conf when present",
    )
    p.add_argument(
        "--app-dir",
        action="append",
        default=[],
        help="directory added to sys.path so config-named app classes import; repeatable",
    )
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="config override, e.g. --set oryx.serving.api.port=9090; repeatable",
    )
    p.add_argument("--input-file", default=None, help="bus-input: file to send line-by-line")
    p.add_argument(
        "--bind", default="0.0.0.0:6378",
        help="bus-serve: host:port to listen on (default 0.0.0.0:6378)",
    )
    p.add_argument(
        "--data-dir", default=None,
        help="bus-serve: directory for the served topic logs "
        "(default: the path of the config's file: input-topic broker)",
    )
    p.add_argument(
        "--from-beginning",
        action="store_true",
        help="bus-tail: start from offset 0 instead of latest",
    )
    p.add_argument("--log-level", default="INFO", help="python logging level")
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the layer computes: the card (default), or the CPU for tests and rehearsals",
    )
    return p


def load_config(conf: str | None, overrides: list[str]) -> Config:
    """Layered config: packaged defaults <- --conf file <- --set overrides."""
    if conf is None and os.path.exists("oryx.conf"):
        conf = "oryx.conf"
    if conf is not None:
        if not os.path.exists(conf):
            raise SystemExit(f"Config file {conf} does not exist")
        os.environ["ORYX_CONF"] = conf
    cfg = config_utils.get_default()
    if overrides:
        lines = []
        for kv in overrides:
            if "=" not in kv:
                raise SystemExit(f"bad --set {kv!r}: expected KEY=VALUE")
            key, _, value = kv.partition("=")
            lines.append(f"{key} = {value}")
        cfg = cfg.with_overlay("\n".join(lines))
    return cfg


def _install_signal_handlers(layer) -> None:
    def handler(signum, frame):  # noqa: ARG001
        log.info("signal %s: shutting down", signum)
        layer.close()

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, handler)
        except ValueError:  # pragma: no cover - non-main thread
            pass


def run_batch(cfg: Config) -> None:
    """deploy/oryx-batch Main.java:31-37 analogue."""
    from oryx_tpu_torch.lambda_.batch import BatchLayer

    layer = BatchLayer(cfg)
    close_at_shutdown(layer)
    _install_signal_handlers(layer)
    layer.start()
    layer.await_termination()


def run_speed(cfg: Config) -> None:
    from oryx_tpu_torch.lambda_.speed import SpeedLayer

    layer = SpeedLayer(cfg)
    close_at_shutdown(layer)
    _install_signal_handlers(layer)
    layer.start()
    layer.await_termination()


def run_serving(cfg: Config) -> None:
    from oryx_tpu_torch.serving.layer import ServingLayer

    layer = ServingLayer(cfg)
    close_at_shutdown(layer)
    _install_signal_handlers(layer)
    layer.start()
    layer.await_termination()


def run_bus_setup(cfg: Config) -> None:
    """Create the input topic with its partitions and the update topic,
    then report each."""
    from oryx_tpu_torch.bus import core as bus

    input_broker = cfg.get_string("oryx.input-topic.broker")
    input_topic = cfg.get_string("oryx.input-topic.message.topic")
    input_parts = cfg.get_optional_int("oryx.input-topic.message.partitions") or 1
    bus.maybe_create_topic(input_broker, input_topic, input_parts)
    print(f"created (or found) input topic {input_topic} "
          f"({input_parts} partitions) on {input_broker}")

    update_broker = cfg.get_optional_string("oryx.update-topic.broker")
    update_topic = cfg.get_optional_string("oryx.update-topic.message.topic")
    if update_broker and update_topic:
        update_parts = cfg.get_optional_int("oryx.update-topic.message.partitions") or 1
        max_size = cfg.get_optional_int("oryx.update-topic.message.max-size")
        bus.maybe_create_topic(
            update_broker, update_topic, update_parts,
            {"max-size": max_size} if max_size else None,
        )
        print(f"created (or found) update topic {update_topic} "
              f"({update_parts} partitions) on {update_broker}")


def run_bus_tail(cfg: Config, from_beginning: bool = False, out=None,
                 stop_after: int | None = None) -> None:
    """Follow the input and update topics, one line per message as
    '<topic>\t<key>\t<message>'."""
    from oryx_tpu_torch.bus.core import get_broker

    out = out or sys.stdout
    pairs = [(cfg.get_string("oryx.input-topic.broker"),
              cfg.get_string("oryx.input-topic.message.topic"))]
    ub = cfg.get_optional_string("oryx.update-topic.broker")
    ut = cfg.get_optional_string("oryx.update-topic.message.topic")
    if ub and ut:
        pairs.append((ub, ut))
    consumers = [
        (topic, get_broker(loc).consumer(topic, from_beginning=from_beginning))
        for loc, topic in pairs
    ]
    printed = 0
    try:
        while True:
            idle = True
            for topic, consumer in consumers:
                for rec in consumer.poll(timeout=0.2):
                    print(f"{topic}\t{rec.key}\t{rec.message}", file=out)
                    idle = False
                    printed += 1
                    if stop_after is not None and printed >= stop_after:
                        return
            if idle:
                out.flush()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        for _, consumer in consumers:
            consumer.close()


def run_bus_input(cfg: Config, input_file: str | None) -> int:
    """Send lines (of input_file, else standard input) to the input topic,
    keyed by a hex hash of the line so they spread over partitions."""
    from oryx_tpu_torch.bus.core import get_broker

    broker = get_broker(cfg.get_string("oryx.input-topic.broker"))
    topic = cfg.get_string("oryx.input-topic.message.topic")
    parts = cfg.get_optional_int("oryx.input-topic.message.partitions") or 1
    broker.create_topic(topic, parts)

    if input_file:
        if not os.path.exists(input_file):
            raise SystemExit(f"Input file {input_file} does not exist")
        f = open(input_file, "r", encoding="utf-8")
    else:
        f = sys.stdin
    sent = 0
    try:
        with broker.producer(topic) as producer:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                key = hashlib.md5(line.encode("utf-8")).hexdigest()
                producer.send(key, line)
                sent += 1
    finally:
        if f is not sys.stdin:
            f.close()
    print(f"sent {sent} messages to {topic}")
    return sent


def run_bus_serve(cfg: Config, bind: str, data_dir: str | None) -> None:
    """Serve a bus over TCP (oryx_tpu_torch.bus.netbus): the topic logs
    live in data_dir on this host, and every layer on any host reaches
    them through a tcp://host:port locator."""
    host, _, port = bind.partition(":")
    if data_dir is None:
        loc = cfg.get_string("oryx.input-topic.broker")
        if not loc.startswith("file:"):
            raise SystemExit(
                "--data-dir required (input-topic broker is not a file: path)"
            )
        # the path get_broker opens: leading '//' pairs stripped, so
        # file:///var/x serves the same /var/x a co-located layer opens
        data_dir = loc[len("file:"):]
        while data_dir.startswith("//"):
            data_dir = data_dir[1:]
    from oryx_tpu_torch.bus.netbus import BusServer

    server = BusServer((host or "0.0.0.0", int(port or 6378)), data_dir)
    log.info("bus-serve: tcp://%s:%s over %s", host, server.server_address[1], data_dir)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)-5s %(name)s: %(message)s",
    )
    for d in args.app_dir:
        sys.path.insert(0, os.path.abspath(d))
    if args.device == "cpu":
        from oryx_tpu_torch.device import set_device

        set_device("cpu")
    cfg = load_config(args.conf, args.set)
    if args.command == "batch":
        run_batch(cfg)
    elif args.command == "speed":
        run_speed(cfg)
    elif args.command == "serving":
        run_serving(cfg)
    elif args.command == "bus-setup":
        run_bus_setup(cfg)
    elif args.command == "bus-serve":
        run_bus_serve(cfg, args.bind, args.data_dir)
    elif args.command == "bus-tail":
        run_bus_tail(cfg, from_beginning=args.from_beginning)
    elif args.command == "bus-input":
        run_bus_input(cfg, args.input_file)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
