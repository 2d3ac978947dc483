"""Torn-write corruption injector for recovery drills.

The crashpoint catalog (``common/crashpoints``) kills processes at
chosen commit points; this module fabricates the on-disk aftermath
directly — a torn final record, a truncated segment, a CRC-garbled shm
frame, stale commit-temp litter, an unreadable CHAMPION pointer — so
chaos tests and the fleet crash campaign can drive every repair path
(``FileBroker.repair``, ``ShmBroker.repair``, ``RegistryStore.fsck``)
without having to catch a real writer at exactly the wrong instant.

Primitives operate on raw paths; the ``*_filebus`` / ``*_shm`` /
``*_registry`` helpers locate the right file from broker/store layout.
Every injector returns a short description of the damage it did, so a
drill's report can say what was broken as well as what was repaired.

Test/ops-only: nothing in the serving or pipeline path imports this.

Port note: a copy of ``oryx_tpu/common/corruption.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

__all__ = [
    "tear_tail",
    "truncate_to",
    "append_garbage",
    "flip_byte",
    "litter_tmp",
    "tear_filebus_partition",
    "garble_filebus_ledger",
    "garble_shm_frame",
    "garble_shm_header",
    "garble_champion",
    "amputate_generation",
    "litter_promote",
    "point_champion_at",
]


# -- raw-path primitives -----------------------------------------------------


def tear_tail(path: str | Path, cut: int = 3) -> str:
    """Cut ``cut`` bytes off the end of a file — the classic torn append:
    the final record loses its newline and part of its payload."""
    p = Path(path)
    size = p.stat().st_size
    keep = max(0, size - cut)
    with open(p, "rb+") as f:
        f.truncate(keep)
    return f"tore {size - keep} byte(s) off {p.name} (now {keep}B)"


def truncate_to(path: str | Path, nbytes: int) -> str:
    """Truncate a file to an absolute byte length (mid-record when the
    caller picks an offset inside one)."""
    p = Path(path)
    with open(p, "rb+") as f:
        f.truncate(nbytes)
    return f"truncated {p.name} to {nbytes}B"


def append_garbage(path: str | Path, data: bytes = b"\x00\xffgarbage") -> str:
    """Append junk with no record framing — a torn write that made it to
    disk but never completed."""
    p = Path(path)
    with open(p, "ab") as f:
        f.write(data)
    return f"appended {len(data)}B of garbage to {p.name}"


def flip_byte(path: str | Path, offset: int, count: int = 1) -> str:
    """XOR ``count`` byte(s) at ``offset`` — bit rot / a torn sector."""
    p = Path(path)
    with open(p, "rb+") as f:
        f.seek(offset)
        original = f.read(count)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in original))
    return f"flipped {count} byte(s) at offset {offset} in {p.name}"


def litter_tmp(directory: str | Path, name: str = "STATE", pid: int = 999_999_999) -> str:
    """Drop a stale commit-side temp file (``.{name}.tmp-<pid>-0``) as a
    dead writer would — repair must sweep it, readers must never see it."""
    d = Path(directory)
    p = d / f".{name}.tmp-{pid}-0"
    p.write_bytes(b"half-written state from a dead writer")
    return f"littered {p.name} in {d}"


# -- filebus -----------------------------------------------------------------


def tear_filebus_partition(root: str | Path, topic: str, partition: int = 0, cut: int = 7) -> str:
    """Tear the active segment's tail for a filebus topic partition."""
    log_path = Path(root) / topic / f"partition-{partition}.log"
    return "filebus: " + tear_tail(log_path, cut=cut)


def garble_filebus_ledger(root: str | Path, group: str) -> str:
    """Overwrite a consumer group's offset ledger with non-JSON junk —
    repair must quarantine it so the group replays from earliest."""
    from oryx_tpu_torch.bus import filebus

    ledger = Path(root) / filebus._OFFSETS_DIR / f"{group}.json"
    ledger.parent.mkdir(parents=True, exist_ok=True)
    ledger.write_bytes(b"{torn mid-writ")
    return f"filebus: garbled offset ledger {ledger.name}"


# -- shm ring ----------------------------------------------------------------


def garble_shm_frame(ring_path: str | Path) -> str:
    """Flip a payload byte inside the newest unconsumed data frame so its
    CRC no longer matches — fsck must roll the head back to the last
    intact frontier. Raises ValueError when the ring holds no data frame.

    Walks the frame chain exactly as fsck does (the CRC covers the
    payload, not the 8-byte alignment padding, so a blind poke at the
    frame tail could land on padding and change nothing)."""
    from oryx_tpu_torch.bus import blockcodec, shmbus

    p = Path(ring_path)
    with open(p, "rb") as f:
        data = f.read()
    head = shmbus._U64.unpack_from(data, shmbus._OFF_HEAD)[0]
    pos = shmbus._U64.unpack_from(data, shmbus._OFF_TAIL)[0]
    ring_bytes = shmbus._U64.unpack_from(data, shmbus._OFF_RING_BYTES)[0]
    target = None
    while pos < head:
        rem = ring_bytes - pos % ring_bytes
        if rem < blockcodec.HEADER_BYTES:
            pos += rem
            continue
        off = shmbus._HEADER_PAGE + pos % ring_bytes
        magic, kind, _flags, _seq, _count, length, _crc = blockcodec.HEADER.unpack_from(
            data, off
        )
        wire = blockcodec.HEADER_BYTES + blockcodec.pad8(length)
        if magic != blockcodec.MAGIC or wire > rem or pos + wire > head:
            break
        if kind != blockcodec.KIND_PAD and length > 0:
            target = off + blockcodec.HEADER_BYTES  # first payload byte
        pos += wire
    if target is None:
        raise ValueError(f"shm ring {p.name} holds no data frame; nothing to garble")
    return "shm: " + flip_byte(p, target)


def garble_shm_header(ring_path: str | Path) -> str:
    """Write an impossible head/tail geometry (tail > head) into the ring
    header — fsck must refuse to trust it and reset the ring empty."""
    from oryx_tpu_torch.bus import shmbus

    p = Path(ring_path)
    with open(p, "rb+") as f:
        f.seek(shmbus._OFF_HEAD)
        f.write(shmbus._U64.pack(1))
        f.seek(shmbus._OFF_TAIL)
        f.write(shmbus._U64.pack(2))
    return f"shm: wrote insane head/tail geometry into {p.name}"


# -- registry ----------------------------------------------------------------


def garble_champion(model_dir: str | Path) -> str:
    """Overwrite the CHAMPION pointer with truncated JSON — fsck must
    quarantine it and fall back to the newest intact generation."""
    p = Path(model_dir) / "CHAMPION"
    p.write_text('{"generation_id": "12')
    return "registry: garbled CHAMPION pointer"


def amputate_generation(model_dir: str | Path, generation_id: str) -> str:
    """Delete a generation's model.pmml, leaving the half-written dir a
    promote that died mid-copy would — fsck must quarantine it."""
    p = Path(model_dir) / str(generation_id) / "model.pmml"
    os.unlink(p)
    return f"registry: amputated model.pmml from generation {generation_id}"


def litter_promote(model_dir: str | Path, generation_id: str = "99999", pid: int = 999_999_999) -> str:
    """Strand a dead promoter's ``.promote-<gen>-<pid>`` staging dir."""
    d = Path(model_dir) / f".promote-{generation_id}-{pid}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "model.pmml").write_text("<torn")
    return f"registry: stranded promote litter {d.name}"


def point_champion_at(model_dir: str | Path, generation_id: str) -> str:
    """Point CHAMPION at an arbitrary (possibly nonexistent) generation —
    fsck must reset it to the newest intact one."""
    p = Path(model_dir) / "CHAMPION"
    p.write_text(json.dumps({"generation_id": str(generation_id), "updated_at_ms": 0}))
    return f"registry: pointed CHAMPION at {generation_id}"
