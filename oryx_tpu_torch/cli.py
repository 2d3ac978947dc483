"""Command-line launcher (counterpart of ``oryx_tpu/cli.py``):

    python -m oryx_tpu_torch batch --conf oryx.conf
    python -m oryx_tpu_torch speed --conf oryx.conf
    python -m oryx_tpu_torch serving --conf oryx.conf

The three layers are ported; each runs as its own process, and they meet
on the bus the config names (the packaged default is the file bus
``file:/tmp/OryxTPU/bus``). The operator commands of the JAX package
(``bus-setup``, ``bus-tail``, ``repair`` and the others) are not.
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
import logging
import os
import signal
import sys

from oryx_tpu_torch.common import config as config_utils
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.lang import close_at_shutdown

log = logging.getLogger(__name__)

COMMANDS = ("batch", "speed", "serving")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oryx_tpu_torch",
        description="PyTorch/CUDA lambda-architecture ML framework launcher",
    )
    p.add_argument("command", choices=COMMANDS, help="which layer to run")
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
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
