"""Native (C++) components, built on demand by ``g++`` and bound with
ctypes (counterpart of ``oryx_tpu/native/__init__.py``).

Three sources, copies of the JAX package's byte for byte, make one
shared library: the concurrent feature-vector store, its update-message
formatters and the tiered cell store (``feature_store.cpp``, bound by
``store.py``), the speed layer's columnar interaction parser
(``parse.cpp``, bound by ``parse.py``) and the epoll HTTP/1.1 front
(``httpfront.cpp``, owned by ``serving/native_front.py``). Every call
releases the GIL. The library is compiled once into
``oryx_tpu_torch/_build/``, named by a hash of the sources, the flags
and the host's CPU (it is built for that CPU), and reused; a lock file
there serialises builds across processes.

When ``g++`` fails, or ``ORYX_NATIVE=0`` is set, ``get_library`` returns
None and every caller keeps its pure-Python path: the Python
``FeatureVectors`` store, ``json.dumps`` vectors, the numpy parsers and
the stdlib HTTP front. ``ORYX_NATIVE_SANITIZE=1`` loads an ASan+UBSan
build instead (``build_sanitized_library``; the process must preload
the runtime that ``find_asan_runtime`` names).
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
_SOURCES = ["feature_store.cpp", "parse.cpp", "httpfront.cpp"]
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


def _hashed_path(prefix: str, flags: list[str], host: bytes) -> str:
    """``_build/<prefix>_<hash>.so``, the hash over the sources, the flags
    and ``host``: an edit or another flag set builds afresh."""
    h = hashlib.sha256()
    for path in source_paths():
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(host)
    return os.path.join(BUILD_DIR, f"{prefix}_{h.hexdigest()[:16]}.so")


def library_path() -> str:
    return _hashed_path("liboryx_native", _FLAGS, host_cpu())


def _compile(so_path: str, flags: list[str], timeout: float, what: str) -> str | None:
    """Compile the sources to ``so_path`` unless it is built already, under
    the build lock, through a temp file; None (logged) when the toolchain
    fails."""
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(so_path):  # another process built it meanwhile
                return so_path
            tmp = f"{so_path}.tmp{os.getpid()}"
            cmd = ["g++", *flags, "-o", tmp, *source_paths(), "-lpthread"]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=timeout)
            except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                    FileNotFoundError) as e:
                err = getattr(e, "stderr", b"")
                log.warning(
                    "%s failed (%s): %s",
                    what, e, (err or b"").decode("utf-8", "replace")[:500],
                )
                return None
            os.replace(tmp, so_path)
            return so_path
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_library() -> str | None:
    """The production library's path, compiled first if needed; None
    when the toolchain fails (callers keep their Python paths)."""
    return _compile(library_path(), _FLAGS, 120, "native build")


_SANITIZE_FLAGS = [
    # -O1 keeps stack traces honest; frame pointers make ASan reports
    # readable. detect_leaks is left to the harness (CPython itself is
    # not leak-clean, so LSan would drown real reports in interpreter
    # noise).
    "-fsanitize=address,undefined",
    "-fno-sanitize-recover=undefined",
    "-fno-omit-frame-pointer",
    "-g",
    "-O1",
    "-std=c++17",
    "-shared",
    "-fPIC",
]


def build_sanitized_library() -> str | None:
    """Compile an ASan+UBSan instrumented variant of the native sources.

    A separate artifact in ``_build/`` (``liboryx_native_san_*``), so the
    production .so never depends on the sanitizer runtime. Loading it into
    CPython needs the ASan runtime preloaded (``find_asan_runtime``); the
    test harness runs the parity suites in a subprocess with LD_PRELOAD
    set. None when the toolchain is unavailable: callers skip, they do
    not fail."""
    # no -march=native: the instrumented build runs on any host
    return _compile(_hashed_path("liboryx_native_san", _SANITIZE_FLAGS, b""), _SANITIZE_FLAGS,
                    240, "sanitized native build")


def find_asan_runtime() -> str | None:
    """Absolute path to libasan.so for LD_PRELOAD, or None: a sanitized
    .so dlopen()ed into an uninstrumented CPython needs the ASan runtime
    loaded first, and g++ knows where its copy lives."""
    try:
        out = subprocess.run(
            ["g++", "-print-file-name=libasan.so"],
            check=True, capture_output=True, timeout=30,
        ).stdout.decode().strip()
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, FileNotFoundError):
        return None
    # when the runtime is missing g++ echoes the bare name back
    if out and os.path.isabs(out) and os.path.exists(out):
        return os.path.realpath(out)
    return None


def get_library() -> ctypes.CDLL | None:
    """The loaded native library, or None (disabled or build failure:
    callers keep their Python paths). With ORYX_NATIVE_SANITIZE=1 the
    ASan/UBSan build is loaded instead (the harness sets this in a
    subprocess whose LD_PRELOAD carries the ASan runtime)."""
    global _lib, _lib_failed
    if not native_enabled():
        return None
    with _LOCK:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("ORYX_NATIVE_SANITIZE") == "1":
            so_path = build_sanitized_library()
        else:
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
    # feature_store.cpp: the sharded vector store (fs_*) and the
    # update-message formatters; parse.cpp: the columnar text parser
    lib.fs_create.restype = c.c_void_p
    lib.fs_create.argtypes = [c.c_int64, c.c_int64]
    lib.fs_destroy.argtypes = [c.c_void_p]
    lib.fs_dim.restype = c.c_int64
    lib.fs_dim.argtypes = [c.c_void_p]
    lib.fs_set.argtypes = [c.c_void_p, c.c_char_p, c.c_int64, c.POINTER(c.c_float)]
    lib.fs_get.restype = c.c_int
    lib.fs_get.argtypes = [c.c_void_p, c.c_char_p, c.c_int64, c.POINTER(c.c_float)]
    lib.fs_remove.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.fs_size.restype = c.c_int64
    lib.fs_size.argtypes = [c.c_void_p]
    lib.fs_recent_count.restype = c.c_int64
    lib.fs_recent_count.argtypes = [c.c_void_p]
    lib.fs_pack.restype = c.c_int64
    lib.fs_pack.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.c_int64, c.c_char_p, c.c_int64,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int,
    ]
    lib.fs_ids.restype = c.c_int64
    lib.fs_ids.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64, c.POINTER(c.c_int64), c.c_int,
    ]
    lib.fs_vtv.argtypes = [c.c_void_p, c.POINTER(c.c_double)]
    lib.fs_retain.argtypes = [c.c_void_p, c.POINTER(c.c_int64), c.c_char_p, c.c_int64]
    lib.fs_get_batch.restype = c.c_int64
    lib.fs_get_batch.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.c_char_p, c.c_int64,
        c.POINTER(c.c_float), c.POINTER(c.c_uint8),
    ]
    lib.fs_set_batch.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.c_char_p, c.c_int64,
        c.POINTER(c.c_float),
    ]
    lib.parse_float_csv.restype = c.c_int64
    lib.parse_float_csv.argtypes = [
        c.c_char_p, c.c_int64, c.POINTER(c.c_float), c.c_int64,
    ]
    lib.json_format_vectors.restype = c.c_int64
    lib.json_format_vectors.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_int64,
        c.POINTER(c.c_char), c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
    ]
    lib.als_update_row_cap.restype = c.c_int64
    lib.als_update_row_cap.argtypes = [c.c_int64, c.c_int64]
    lib.als_format_updates.restype = c.c_int64
    lib.als_format_updates.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_int64,
        c.POINTER(c.c_int64), c.c_char_p, c.POINTER(c.c_int64), c.c_char_p,
        c.c_char, c.c_int, c.c_int64, c.POINTER(c.c_char),
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int64,
    ]
    lib.als_parse_text_block.restype = c.c_int64
    lib.als_parse_text_block.argtypes = [
        c.c_char_p, c.c_int64, c.c_int64,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_float),
        c.POINTER(c.c_int64), c.POINTER(c.c_uint8), c.POINTER(c.c_int32),
        c.c_int64,
    ]
    lib.als_format_updates_multi.restype = c.c_int64
    lib.als_format_updates_multi.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_int64,
        c.POINTER(c.c_int64), c.c_char_p,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_char_p,
        c.c_char, c.c_int64, c.POINTER(c.c_char),
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int64,
    ]
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
    # tiered cell store (ts_*): RAM->disk item-plane tiers + async
    # prefetch (native/store.py TieredHostPlane owns the handle)
    i64p = c.POINTER(c.c_int64)
    lib.ts_create.restype = c.c_void_p
    lib.ts_create.argtypes = [c.c_char_p, c.c_int64, c.c_int64, c.c_int64]
    lib.ts_destroy.argtypes = [c.c_void_p]
    lib.ts_put_cell.restype = c.c_int64
    lib.ts_put_cell.argtypes = [c.c_void_p, c.c_int64, u8p, c.c_int64]
    lib.ts_cell_bytes.restype = c.c_int64
    lib.ts_cell_bytes.argtypes = [c.c_void_p, c.c_int64]
    lib.ts_read_cell.restype = c.c_int64
    lib.ts_read_cell.argtypes = [c.c_void_p, c.c_int64, u8p, c.c_int64]
    lib.ts_prefetch.restype = c.c_int64
    lib.ts_prefetch.argtypes = [c.c_void_p, i64p, c.c_int64]
    lib.ts_residency.restype = c.c_int64
    lib.ts_residency.argtypes = [c.c_void_p, i64p, c.c_int64]
    lib.ts_stats.argtypes = [c.c_void_p, i64p]
    lib.ts_drop_ram.argtypes = [c.c_void_p, c.c_int64]
