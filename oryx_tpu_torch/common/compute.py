"""Compute settings that every layer reads.

The JAX package applies ``oryx.compute.compile-cache-dir`` in
``parallel/distributed.py`` (``maybe_enable_compile_cache``), and each of
its layers calls it from there. The port has no compilation cache yet, so
each of its layers (batch, speed and serving) refuses the key here."""

from __future__ import annotations

from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch.common.config import Config


def refuse_compile_cache(config: Config) -> None:
    """Raise rather than run silently without the cache a config asks for."""
    if config.get("oryx.compute.compile-cache-dir", None):
        raise NotYetPortedError(
            "oryx.compute.compile-cache-dir is set, but the port has no compilation cache"
        )
