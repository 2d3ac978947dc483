"""Pluggable storage: local filesystem or object store behind one URI API.

The reference persists historical data and models to HDFS and resolves
MODEL-REF messages from it (BatchUpdateFunction.java:103-130,
AppPMMLUtils.java:256); a multi-host TPU deployment needs the same —
a shared store all layers can reach. Paths without a scheme (or with
``file://``) use the local filesystem directly (fast path, atomic
temp+rename writes); any other scheme (``gs://``, ``s3://``,
``memory://`` for tests) routes through fsspec, whose per-blob writes
are atomic on object stores.

All functions take URI strings. Directory semantics are emulated on
object stores the usual way (prefixes); ``mkdirs`` is a no-op there.

Port note: a copy of ``oryx_tpu/common/storage.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import contextlib
import gzip
import os
import shutil
import threading
from pathlib import Path
from typing import IO, Iterator

from oryx_tpu_torch.common.crashpoints import crashpoint

__all__ = [
    "is_remote", "local_path", "open_read", "open_write", "open_gzip_read",
    "open_gzip_write", "exists", "list_names", "delete",
    "mkdirs", "size", "read_text", "write_text", "join",
    "upload_dir", "commit_bytes", "commit_text", "fsync_dir", "sweep_tmp",
]


def is_remote(uri: str | os.PathLike) -> bool:
    s = str(uri)
    return "://" in s and not s.startswith("file://")


def _local(uri: str | os.PathLike) -> Path:
    s = str(uri)
    return Path(s[len("file://"):] if s.startswith("file://") else s)


def local_path(uri: str | os.PathLike) -> Path:
    """Local filesystem Path for a non-remote URI (strips any file://
    scheme). Callers doing direct Path work (rename-based promotion)
    must use this instead of Path(uri), or a file:// prefix turns into
    a literal relative directory."""
    if is_remote(str(uri)):
        raise ValueError(f"not a local URI: {uri}")
    return _local(uri)


def _fs(uri: str):
    import fsspec

    fs, path = fsspec.core.url_to_fs(uri)
    return fs, path


def join(uri: str | os.PathLike, *parts: str) -> str:
    s = str(uri).rstrip("/")
    return "/".join([s, *[p.strip("/") for p in parts]])


@contextlib.contextmanager
def open_read(uri: str | os.PathLike, mode: str = "rb") -> Iterator[IO]:
    if is_remote(str(uri)):
        fs, path = _fs(str(uri))
        with fs.open(path, mode) as f:
            yield f
    else:
        with open(_local(uri), mode, encoding="utf-8" if "b" not in mode else None) as f:
            yield f


TMP_MARKER = ".tmp-"


def _tmp_sibling(p: Path) -> Path:
    # tmp name must be unique PER WRITER: concurrent writers of the
    # same target sharing one tmp path race each other's atomic
    # replace (writer A's replace unlinks the tmp writer B is about
    # to replace -> FileNotFoundError; surfaced by concurrent
    # /model/rollback requests moving the CHAMPION pointer). A sibling
    # (never /tmp or tempfile.mkstemp) guarantees same-filesystem
    # rename: cross-device "renames" degrade to copy+unlink, which is
    # not atomic and can tear (ORX602).
    return p.parent / f".{p.name}{TMP_MARKER}{os.getpid()}-{threading.get_ident()}"


def fsync_dir(path: str | os.PathLike) -> None:
    """fsync a directory so a completed rename inside it is durable —
    without this the *entry* can vanish on power loss even though the
    file's bytes survived. Platforms that refuse O_RDONLY fsync on
    directories (some network filesystems) are skipped, not failed."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - fs without dir fsync support
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def open_write(uri: str | os.PathLike, mode: str = "wb") -> Iterator[IO]:
    """Atomic AND durable everywhere: local writes go through temp +
    fsync + rename + parent-dir fsync (a rename can survive a crash
    while its contents don't — fsync the temp file first — and a rename
    itself isn't durable until the directory entry is synced); remote
    writes go to a temp key that is moved into place only on success —
    fsspec finalizes a blob on close() even when the with-body raised,
    so writing the final key directly would commit truncated data."""
    if is_remote(str(uri)):
        fs, path = _fs(str(uri))
        tmp = f"{path}{TMP_MARKER}{os.getpid()}"
        try:
            with fs.open(tmp, mode) as f:
                yield f
        except BaseException:
            with contextlib.suppress(Exception):
                fs.rm(tmp)
            raise
        crashpoint("storage.commit.pre")
        fs.mv(tmp, path)
        crashpoint("storage.commit.post")
    else:
        p = _local(uri)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = _tmp_sibling(p)
        try:
            with open(tmp, mode, encoding="utf-8" if "b" not in mode else None) as f:
                yield f
                f.flush()
                os.fsync(f.fileno())
        except BaseException:
            with contextlib.suppress(Exception):
                tmp.unlink()
            raise
        crashpoint("storage.commit.pre")
        tmp.replace(p)
        crashpoint("storage.commit.post")
        fsync_dir(p.parent)


def commit_bytes(path: str | os.PathLike, data: bytes) -> None:
    """THE recognized local commit helper (ORX601/ORX603): write a small
    state file — CHAMPION pointer, offset ledger, segment-base sidecar,
    topic meta — atomically and durably: sibling temp + fsync + rename +
    parent-dir fsync, with crashpoints at each step boundary. Callers
    that already hold a Path (filebus sidecars) use this instead of the
    URI-level write_text."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_sibling(p)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        with contextlib.suppress(Exception):
            tmp.unlink()
        raise
    crashpoint("storage.commit.pre")
    tmp.replace(p)
    crashpoint("storage.commit.post")
    fsync_dir(p.parent)


def commit_text(path: str | os.PathLike, text: str) -> None:
    commit_bytes(path, text.encode("utf-8"))


def sweep_tmp(dir_uri: str | os.PathLike) -> int:
    """Remove stale writer temp litter (crashed mid-commit) directly
    under a directory: any ``.<name>.tmp-<pid>-...`` sibling left by
    open_write/commit_bytes. A temp file is only ever garbage once its
    writer is gone — renames happen in the writer's own lifetime — so
    sweeping at repair/open time is safe for files whose writer pid is
    dead (or foreign). Returns the number removed."""
    if is_remote(str(dir_uri)):
        return 0
    d = _local(dir_uri)
    if not d.is_dir():
        return 0
    removed = 0
    for p in d.iterdir():
        if not p.is_file() or TMP_MARKER not in p.name or not p.name.startswith("."):
            continue
        pid_part = p.name.split(TMP_MARKER, 1)[1].split("-", 1)[0]
        try:
            pid = int(pid_part)
        except ValueError:
            continue
        if pid != os.getpid() and not _pid_alive(pid):
            with contextlib.suppress(OSError):
                p.unlink()
                removed += 1
    return removed


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - pid exists, other user
        return True
    return True


@contextlib.contextmanager
def open_gzip_read(uri: str | os.PathLike) -> Iterator[IO]:
    with open_read(uri, "rb") as raw, gzip.open(raw, "rt", encoding="utf-8") as g:
        yield g


@contextlib.contextmanager
def open_gzip_write(uri: str | os.PathLike) -> Iterator[IO]:
    with open_write(uri, "wb") as raw, gzip.open(raw, "wt", encoding="utf-8") as g:
        yield g


def exists(uri: str | os.PathLike) -> bool:
    if is_remote(str(uri)):
        fs, path = _fs(str(uri))
        return fs.exists(path)
    return _local(uri).exists()


def list_names(uri: str | os.PathLike) -> list[str]:
    """Entry names (final path components) directly under a directory /
    prefix; empty when it doesn't exist."""
    if is_remote(str(uri)):
        fs, path = _fs(str(uri))
        if not fs.exists(path):
            return []
        return sorted({p.rstrip("/").rsplit("/", 1)[-1] for p in fs.ls(path, detail=False)})
    d = _local(uri)
    if not d.is_dir():
        return []
    return sorted(p.name for p in d.iterdir())


def delete(uri: str | os.PathLike, recursive: bool = False) -> None:
    if is_remote(str(uri)):
        fs, path = _fs(str(uri))
        if fs.exists(path):
            fs.rm(path, recursive=recursive)
        return
    p = _local(uri)
    if p.is_dir():
        if recursive:
            shutil.rmtree(p, ignore_errors=True)
        else:
            p.rmdir()
    else:
        p.unlink(missing_ok=True)


def mkdirs(uri: str | os.PathLike) -> None:
    if is_remote(str(uri)):
        return  # object stores have no directories
    _local(uri).mkdir(parents=True, exist_ok=True)


def size(uri: str | os.PathLike) -> int:
    if is_remote(str(uri)):
        fs, path = _fs(str(uri))
        return fs.size(path)
    return _local(uri).stat().st_size


def read_text(uri: str | os.PathLike) -> str:
    with open_read(uri, "rb") as f:
        return f.read().decode("utf-8")


def write_text(uri: str | os.PathLike, text: str) -> None:
    with open_write(uri, "wb") as f:
        f.write(text.encode("utf-8"))


def upload_dir(local_dir: str | Path, dst_uri: str) -> None:
    """Recursively copy a local directory tree to a destination URI
    (model-candidate promotion to an object store). The PMML file
    (model.pmml) is uploaded LAST so a consumer that sees it can rely on
    the sibling artifacts being complete."""
    root = Path(local_dir)
    files = [p for p in root.rglob("*") if p.is_file()]
    files.sort(key=lambda p: (p.name == "model.pmml", str(p)))
    for p in files:
        rel = p.relative_to(root)
        target = join(dst_uri, *rel.parts)
        with open(p, "rb") as f, open_write(target, "wb") as out:
            shutil.copyfileobj(f, out)
