"""Profiling hooks: ``torch.profiler`` traces on demand (counterpart of
``oryx_tpu/common/profiling.py``).

When a profile directory is configured (``oryx.batch.compute.profile-dir``
/ ``oryx.speed.compute.profile-dir``) each traced span writes a Chrome
trace (``torch.profiler``'s ``export_chrome_trace``) to
``<dir>/<name>-<timestamp>/trace.json``, viewable in chrome://tracing or
ui.perfetto.dev; without one the context manager is a no-op. The JAX
package writes an xprof trace there instead. A trace records the
process's CPU activity, plus the card's kernels and copies when the
port's device is ``cuda``. The serving layer's ``POST /debug/profile``
takes a wall-clock capture the same way (``capture``).

One ``torch.profiler`` session at a time per process: a second one
while a trace runs is not safe, so ``maybe_trace`` skips tracing then
(logged) and ``capture`` raises.

Step-time breakdowns are separate: layers wrap their phases in
``metrics.timed`` histograms, exported at /metrics.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

TRACE_FILE = "trace.json"

# held for the life of a trace: torch.profiler runs one session per process
_session_lock = threading.Lock()


def _target(profile_dir: str, name: str) -> str:
    return f"{profile_dir.rstrip('/')}/{name}-{int(time.time() * 1000)}"


def _activities():
    import torch

    from oryx_tpu_torch.device import default_device

    acts = [torch.profiler.ProfilerActivity.CPU]
    if default_device().type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start(target: str, name: str):
    """A started profiler session whose window is the ``name`` span, or
    RuntimeError when another session runs or the profiler cannot
    start. The caller owns ``_session_lock`` on success."""
    import torch

    if not _session_lock.acquire(blocking=False):
        raise RuntimeError("a profiler trace is already running in this process")
    try:
        prof = torch.profiler.profile(activities=_activities())
        prof.__enter__()
    except Exception as e:
        _session_lock.release()
        raise RuntimeError(f"could not start profiler trace: {e}") from e
    window = torch.profiler.record_function(name)
    window.__enter__()
    return prof, window


def _stop(prof, window, target: str) -> None:
    """Stop the session, write its Chrome trace under ``target`` and
    release the session lock; failures are logged, not raised."""
    try:
        window.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        os.makedirs(target, exist_ok=True)
        prof.export_chrome_trace(os.path.join(target, TRACE_FILE))
    except Exception:
        log.exception("could not stop profiler trace %s", target)
    finally:
        _session_lock.release()


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None, name: str):
    """torch.profiler trace of the enclosed block when profile_dir is set."""
    if not profile_dir:
        yield
        return
    target = _target(profile_dir, name)
    log.info("profiling %s -> %s", name, target)
    # tracing must never take down a layer: profiler start/stop failures
    # are logged and swallowed; the body's own exceptions propagate
    session = None
    try:
        session = _start(target, name)
    except RuntimeError:
        log.exception("could not start profiler trace %s", target)
    try:
        yield
    finally:
        if session is not None:
            _stop(*session, target)


def profile_dir_from_config(config, layer: str) -> str | None:
    """Configured trace directory for a layer, or None (off)."""
    return config.get(f"oryx.{layer}.compute.profile-dir", None)


def capture(profile_dir: str, name: str, seconds: float) -> str:
    """On-demand wall-clock profiler capture (the serving layer's
    ``POST /debug/profile``): trace whatever the process and the card do
    for ``seconds``, write under ``profile_dir``, return the trace's
    directory. Raises RuntimeError when the profiler cannot start, a
    capture already running included (the caller maps it to an HTTP
    error)."""
    target = _target(profile_dir, name)
    session = _start(target, name)
    try:
        time.sleep(max(0.0, seconds))
    finally:
        _stop(*session, target)
    return target
