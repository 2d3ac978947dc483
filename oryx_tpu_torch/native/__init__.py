"""Native (C++) components, built on demand by ``g++`` and bound with
ctypes (counterpart of ``oryx_tpu/native/__init__.py``).

Only the epoll HTTP/1.1 front (``httpfront.cpp``, a copy of the JAX
package's) is ported so far; ``serving/native_front.py`` owns its
handle. The shared library is compiled once into
``oryx_tpu_torch/_build/``, named by a hash of the source, the flags
and the host's CPU (it is built for that CPU), and reused;
a lock file there serialises builds across processes. Set
``ORYX_NATIVE=0`` to decline it (the serving layer then keeps its stdlib
front). The C++ feature store and parser, their ASan build and
``store.py``'s native paths are not ported: ``store.py`` holds only the
pure-Python formatters.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import platform
import subprocess
import threading

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SOURCES = ["httpfront.cpp"]
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False


def native_enabled() -> bool:
    return os.environ.get("ORYX_NATIVE", "1") != "0"


def source_paths() -> list[str]:
    """The C++ sources the library is built from, all in this package."""
    return [os.path.join(_HERE, s) for s in _SOURCES]


def host_cpu() -> bytes:
    """The build host's CPU model and feature flags: ``-march=native``
    code runs only on a CPU that has them, so a ``_build/`` copied to
    another host builds afresh there instead of loading a library that
    may hold illegal instructions."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        lines = []
    keys = (b"model name", b"flags", b"Features", b"CPU part")
    first = {}
    for line in lines:
        key = line.split(b":", 1)[0].strip()
        if key in keys:
            first.setdefault(key, line)
    return b"\n".join(first[k] for k in keys if k in first) or platform.processor().encode()


def library_path() -> str:
    h = hashlib.sha256()
    for path in source_paths():
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(host_cpu())
    return os.path.join(BUILD_DIR, f"liboryx_native_{h.hexdigest()[:16]}.so")


def _build_library() -> str | None:
    """Compile the sources to one .so unless it is built already; None
    (logged) when the toolchain fails."""
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(so_path):  # another process built it meanwhile
                return so_path
            tmp = f"{so_path}.tmp{os.getpid()}"
            cmd = ["g++", *_FLAGS, "-o", tmp, *source_paths(), "-lpthread"]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                    FileNotFoundError) as e:
                err = getattr(e, "stderr", b"")
                log.warning(
                    "native build failed (%s): %s",
                    e, (err or b"").decode("utf-8", "replace")[:500],
                )
                return None
            os.replace(tmp, so_path)
            return so_path
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def get_library() -> ctypes.CDLL | None:
    """The loaded native library, or None (disabled or build failure:
    callers keep their Python paths)."""
    global _lib, _lib_failed
    if not native_enabled():
        return None
    with _LOCK:
        if _lib is not None or _lib_failed:
            return _lib
        so_path = _build_library()
        if so_path is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(so_path)
        _declare(lib)
        _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    # httpfront.cpp: epoll HTTP/1.1 front (serving/native_front.py owns
    # the handle; ctypes releases the GIL for the blocking hf_poll)
    u8p = c.POINTER(c.c_uint8)
    lib.hf_create.restype = c.c_void_p
    lib.hf_create.argtypes = [
        c.c_int, c.c_int, c.c_int64, c.c_int64, c.c_double, c.c_int64,
    ]
    lib.hf_port.restype = c.c_int
    lib.hf_port.argtypes = [c.c_void_p]
    lib.hf_shutdown.argtypes = [c.c_void_p]
    lib.hf_close.argtypes = [c.c_void_p]
    lib.hf_poll.restype = c.c_int64
    lib.hf_poll.argtypes = [c.c_void_p, u8p, c.c_int64, c.c_int]
    lib.hf_respond.restype = c.c_int
    lib.hf_respond.argtypes = [
        c.c_void_p, c.c_uint32, c.c_uint32, u8p, c.c_int64, c.c_int,
    ]
    lib.hf_set_ladder.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_uint32]
    lib.hf_set_tenants.argtypes = [c.c_void_p, u8p, c.c_int64]
    lib.hf_set_exempt.argtypes = [c.c_void_p, u8p, c.c_int64]
    lib.hf_set_context.argtypes = [c.c_void_p, u8p, c.c_int64]
    lib.hf_set_shed_template.argtypes = [
        c.c_void_p, u8p, c.c_int64, u8p, c.c_int64, c.c_int64,
    ]
    lib.hf_set_snapshot.argtypes = [
        c.c_void_p, u8p, c.c_int64, u8p, c.c_int64, u8p, c.c_int64,
        c.c_int64, c.c_int,
    ]
    lib.hf_cache_cap.argtypes = [c.c_void_p, c.c_int64]
    lib.hf_cache_put.argtypes = [
        c.c_void_p, u8p, c.c_int64, u8p, c.c_int64, u8p, c.c_int64,
        c.c_int64,
    ]
    lib.hf_cache_clear.argtypes = [c.c_void_p]
    lib.hf_cache_size.restype = c.c_int64
    lib.hf_cache_size.argtypes = [c.c_void_p]
    lib.hf_stats.restype = c.c_int64
    lib.hf_stats.argtypes = [c.c_void_p, c.POINTER(c.c_uint64), c.c_int64, c.c_int]
    lib.hf_drain_trace.restype = c.c_int64
    lib.hf_drain_trace.argtypes = [c.c_void_p, u8p, c.c_int64]
