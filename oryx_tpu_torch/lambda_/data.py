"""Historical-data storage for the batch layer.

Rebuild of SaveToHDFSFunction (framework/oryx-lambda/.../batch/
SaveToHDFSFunction.java:31-77: append each non-empty micro-batch as
``dataDir/oryx-<timestampMs>.data``), the past-data re-read in
BatchUpdateFunction.java:103-130, and age-based GC in
DeleteOldDataFn.java:38-78 (timestamp parsed from the file/dir name).

Records are JSON lines ``{"k": key, "m": message}`` — the plain-file
equivalent of the reference's Hadoop SequenceFile<Text,Text>.

Directories are URIs: plain paths use the local filesystem, `gs://` /
`memory://` etc. route through the object-store backend
(oryx_tpu_torch.common.storage) — the HDFS-parity piece that lets every host
of a multi-host deployment share one data/model store.

Port note: a copy of ``oryx_tpu/lambda_/data.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Iterator

import numpy as np

from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common import storage
from oryx_tpu_torch.common.records import RecordBlock, Records

_DATA_FILE_RE = re.compile(r"^oryx-(\d+)\.(data|npz)$")
_MODEL_DIR_RE = re.compile(r"^(\d+)$")


def save_micro_batch(
    data_dir: str | Path,
    timestamp_ms: int,
    records: list[KeyMessage],
    fmt: str = "npz",
) -> str | None:
    """Append one micro-batch; empty batches write nothing
    (SaveToHDFSFunction.java:60-66).

    fmt "npz" (default) stores columnar numpy byte-string arrays — the
    binary analogue of the reference's SequenceFile<Text,Text>, read back
    as whole arrays with zero per-record Python. fmt "jsonl" keeps the
    line-per-record text form (`.data`); both are read transparently."""
    if not records:
        return None
    storage.mkdirs(data_dir)
    if fmt == "npz":
        path = storage.join(data_dir, f"oryx-{timestamp_ms}.npz")
        block = RecordBlock.from_key_messages(records)
        arrays = {"messages": block.messages}
        if block.keys is not None:
            arrays["keys"] = block.keys
        if block.none_keys is not None:
            arrays["none_keys"] = block.none_keys
        with storage.open_write(path, "wb") as f:
            np.savez_compressed(f, **arrays)
        return path
    if fmt != "jsonl":
        raise ValueError(f"unknown micro-batch format {fmt!r} (want npz or jsonl)")
    path = storage.join(data_dir, f"oryx-{timestamp_ms}.data")
    with storage.open_write(path, "wb") as f:
        for rec in records:
            f.write(
                (json.dumps({"k": rec.key, "m": rec.message}, separators=(",", ":")) + "\n").encode("utf-8")
            )
    return path


def _data_file_names(data_dir: str | Path) -> list[str]:
    names = [n for n in storage.list_names(data_dir) if _DATA_FILE_RE.match(n)]
    names.sort(key=lambda n: int(_DATA_FILE_RE.match(n).group(1)))
    return names


def _read_block(path) -> RecordBlock:
    if str(path).endswith(".npz"):
        with storage.open_read(path, "rb") as f:
            with np.load(f, allow_pickle=False) as z:
                return RecordBlock(
                    z["keys"] if "keys" in z else None,
                    z["messages"],
                    z["none_keys"] if "none_keys" in z else None,
                )
    records: list[KeyMessage] = []
    with storage.open_read(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line:
                rec = json.loads(line)
                records.append(KeyMessage(rec.get("k"), rec.get("m", "")))
    if not records:
        return RecordBlock(None, np.empty(0, dtype="S1"))
    return RecordBlock.from_key_messages(records)


class FileRecords(Records):
    """Lazy view over a data dir's surviving micro-batches, oldest first:
    one stored block in memory at a time (the re-read path of
    BatchUpdateFunction.java:103-130, without materializing history)."""

    def __init__(self, data_dir: str | Path) -> None:
        self._dir = data_dir

    def is_empty(self) -> bool:
        return not _data_file_names(self._dir)

    def blocks(self) -> Iterator[RecordBlock]:
        for name in _data_file_names(self._dir):
            yield _read_block(storage.join(self._dir, name))


def read_past_data(data_dir: str | Path) -> Iterator[KeyMessage]:
    """Stream all surviving historical records, oldest file first."""
    return iter(FileRecords(data_dir))


def delete_old_data(
    data_dir: str | Path, max_age_hours: int, now_ms: int | None = None
) -> list[str]:
    """Delete data files older than max_age_hours; -1 disables
    (DeleteOldDataFn.java:54-74)."""
    return _delete_old(data_dir, _DATA_FILE_RE, max_age_hours, now_ms, recursive=False)


def delete_old_models(
    model_dir: str | Path, max_age_hours: int, now_ms: int | None = None
) -> list[str]:
    """Delete versioned model dirs (named <timestampMs>) older than
    max_age_hours; -1 disables."""
    return _delete_old(model_dir, _MODEL_DIR_RE, max_age_hours, now_ms, recursive=True)


def _delete_old(
    root: str | Path,
    pattern: re.Pattern,
    max_age_hours: int,
    now_ms: int | None,
    recursive: bool,
) -> list[str]:
    if max_age_hours < 0:
        return []
    cutoff = (time.time() * 1000 if now_ms is None else now_ms) - max_age_hours * 3600_000
    deleted = []
    for name in storage.list_names(root):
        m = pattern.match(name)
        if m and int(m.group(1)) < cutoff:
            target = storage.join(root, name)
            storage.delete(target, recursive=recursive)
            deleted.append(target)
    return deleted
