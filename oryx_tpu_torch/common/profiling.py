"""Profiling hooks (counterpart of ``oryx_tpu/common/profiling.py``).

The JAX package writes a profiler trace of each traced span under the
configured profile directory (``oryx.batch.compute.profile-dir`` /
``oryx.speed.compute.profile-dir``). The port's ``torch.profiler`` form
is not written yet: without a profile directory ``maybe_trace`` is a
no-op, and with one it raises NotYetPortedError rather than drop the
setting.
"""

from __future__ import annotations

import contextlib

from oryx_tpu_torch import NotYetPortedError


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None, name: str):
    """A no-op without a profile directory; tracing is not ported."""
    if profile_dir:
        raise NotYetPortedError(
            f"profiling {name!r} to {profile_dir!r} is not yet ported to oryx_tpu_torch"
        )
    yield


def profile_dir_from_config(config, layer: str) -> str | None:
    """Configured trace directory for a layer, or None (off)."""
    return config.get(f"oryx.{layer}.compute.profile-dir", None)
