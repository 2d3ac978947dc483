"""Builds the port's CUDA kernels at first use and loads them with ctypes
(no counterpart in ``oryx_tpu``: Pallas kernels compile inside jit).

Each source under ``oryx_tpu_torch/csrc`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface,
``oryx_tpu_torch/_build/lib<name>-<hash>.so``, or in the directory
``oryx.compute.compile-cache-dir`` names (``set_build_dir``, from
``parallel/distributed.maybe_enable_compile_cache``). The hash covers the
source and the flags, so an edited source rebuilds and an unchanged one
loads the library already built, in this process or a later one. A lock
file in the build directory serialises builds across processes;
``build()`` starts one ``nvcc`` per source, all at once. ``EVENTS`` records
which libraries this process built, found built, and loaded.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# name -> source file under csrc/
SOURCES = {"topn": "topn.cu", "kmeans": "kmeans.cu"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the build log
]

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
# (name, "built" | "found" | "loaded", library path): what this process's
# build() compiled or found already built, and what load() opened
EVENTS: list[tuple[str, str, str]] = []


def set_build_dir(path) -> None:
    """Build and load kernels in ``path`` from now on; libraries already
    loaded stay loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source not yet built, all ``nvcc`` processes
    running at once; returns name -> library path. Raises with the
    compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = {}
            for n in names:
                if out[n].exists():
                    EVENTS.append((n, "found", str(out[n])))
                    continue
                tmp = out[n].with_suffix(f".tmp{os.getpid()}.so")
                log = open(log_path(n), "w")
                procs[n] = (
                    subprocess.Popen(
                        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])],
                        stdout=log,
                        stderr=subprocess.STDOUT,
                    ),
                    tmp,
                    log,
                )
            failed = []
            for n, (proc, tmp, log) in procs.items():
                rc = proc.wait()
                log.close()
                if rc == 0:
                    os.replace(tmp, out[n])
                    EVENTS.append((n, "built", str(out[n])))
                else:
                    failed.append(f"{n} (nvcc exit {rc}):\n{log_path(n).read_text()}")
            if failed:
                raise RuntimeError("kernel build failed: " + "\n".join(failed))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first when needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
            EVENTS.append((name, "loaded", str(path)))
        return lib
