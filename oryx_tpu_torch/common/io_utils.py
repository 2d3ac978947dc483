"""Filesystem and network helpers.

Rebuild of the reference's IOUtils (framework/oryx-common/src/main/java/com/
cloudera/oryx/common/io/IOUtils.java): free-port selection, recursive
delete, glob listing — mostly test and layer-runtime scaffolding.

Port note: a copy of ``oryx_tpu/common/io_utils.py`` (JAX-free).
"""

from __future__ import annotations

import contextlib
import fnmatch
import os
import shutil
import socket
from pathlib import Path

__all__ = ["choose_free_port", "delete_recursively", "list_files", "mkdirs"]


def choose_free_port() -> int:
    with contextlib.closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def delete_recursively(path: str | Path) -> None:
    p = Path(path)
    if p.is_dir():
        shutil.rmtree(p, ignore_errors=True)
    elif p.exists():
        p.unlink(missing_ok=True)


def list_files(dir_path: str | Path, glob: str = "*") -> list[Path]:
    """Sorted non-recursive glob listing (IOUtils.listFiles analogue)."""
    d = Path(dir_path)
    if not d.is_dir():
        return []
    return sorted(p for p in d.iterdir() if fnmatch.fnmatch(p.name, glob))


def mkdirs(path: str | Path) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p
