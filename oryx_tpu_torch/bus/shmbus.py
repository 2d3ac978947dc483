"""Shared-memory ring-buffer broker: the zero-copy high-rate transport.

The reference deployment leans on Kafka's page-cache + sendfile path to
move record batches without copying them through user space; this broker
is the single-host rebuild of that idea for the speed layer's 100K+
events/s input stream. Each topic partition is one mmap'ed ring file that
every producer/consumer process maps into its own address space; record
batches travel as binary frames (bus/blockcodec.py) written once into the
ring and *decoded as numpy array views over the mapped memory* — a
consumer's parse stage is pointer arithmetic, not text splitting, and the
bytes are never copied out of the transport (LMAX-disruptor shape: one
writer cursor, per-consumer guard cursors, wrap with sequence gating).

Layout of ``<root>/<topic>/partition-<i>.ring``::

    [0, 4096)      header page
        0   u64  ring file magic
        8   u64  ring_bytes (data region size)
        16  u64  head        monotonic byte offset of the write frontier
        24  u64  tail        monotonic byte offset of the reclaim floor
        32  u64  next_seqno  record offset the next frame starts at
        40  u64  base_seqno  earliest retained record offset
        1024     consumer slot table: 64 slots x 32 bytes
                 [pid u64, guard_pos u64, heartbeat_ns u64, reserved u64]
    [4096, 4096 + ring_bytes)   frame data (bus/blockcodec.py frames)

Invariants that make the lock-free read side safe:

- ``head`` is published LAST, after a frame's header+payload bytes are in
  place, so a producer that dies mid-write leaves the ring exactly as it
  was — torn writes are invisible. (A *corrupted* frame under head — e.g.
  bad RAM, or a test poking bytes — fails its CRC; the consumer skips the
  frame by its header length, counts ``bus.shm.crc-resyncs`` and carries
  on at the next frame boundary.)
- Frames never straddle the ring end: when the remainder at the end is
  too small for the next frame the writer emits a PAD frame (kind 0)
  covering it, and a remainder smaller than one header is dead space both
  sides skip arithmetically. Readers and writers therefore agree on frame
  boundaries from (position % ring_bytes) alone.
- The writer may only advance ``tail`` (reclaim space) past bytes that
  every *live* registered consumer guard has released: backpressure is
  bounded blocking (``oryx.bus.shm.full-block-ms``, then BlockingIOError
  — an OSError, so layer retry policies see an ordinary transient), never
  a silent drop. Guards of dead processes are evicted by pid liveness.
- Consumer guards auto-advance at poll entry: views handed out by one
  poll stay valid until the next poll (the GuardedBlockFeed contract).
  ``pin()``/``release()`` freeze the guard across a multi-poll drain.

Writers serialize through the same fcntl flock the file bus uses, so any
number of producer processes can share a partition. Group offsets reuse
the file bus ledger (``__offsets__/<group>.json``) — positions are record
offsets with the same clamp-forward-on-retention semantics, so at-least-
once resume behaves exactly like the file bus.

Port note: a copy of ``oryx_tpu/bus/shmbus.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import struct
import time
import zlib
from pathlib import Path

import numpy as np

from oryx_tpu_torch.bus import blockcodec
from oryx_tpu_torch.bus.core import (
    Broker,
    KeyMessage,
    TopicConsumer,
    TopicProducer,
    partition_for,
    resolve_partitions,
)
from oryx_tpu_torch.bus.filebus import FileBroker, _Flock
from oryx_tpu_torch.common import metrics, storage, tracing
from oryx_tpu_torch.common.crashpoints import crashpoint

log = logging.getLogger(__name__)

RING_FILE_MAGIC = 0x31676E5278797230  # b"0ryxRng1" little-endian

_HEADER_PAGE = 4096
_OFF_MAGIC = 0
_OFF_RING_BYTES = 8
_OFF_HEAD = 16
_OFF_TAIL = 24
_OFF_NEXT_SEQNO = 32
_OFF_BASE_SEQNO = 40
_SLOTS_OFF = 1024
_SLOT_BYTES = 32
_MAX_SLOTS = 64

_U64 = struct.Struct("<Q")

# one buffered text frame's worth of records when batching send_many
_TEXT_FRAME_SLICE_BYTES = 1 << 20

_DEF_RING_MB = 64
_DEF_SLOTS = 64
_DEF_FULL_BLOCK_MS = 2000.0
_DEF_FRAME_RECORDS = 65536


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _cfg(key: str, default):
    try:
        from oryx_tpu_torch.common.config import get_default

        v = get_default().get(f"oryx.bus.shm.{key}", None)
    except Exception:
        return default
    return default if v is None else v


class _Ring:
    """One mmap'ed partition ring (process-local handle; the mapped pages
    are shared with every other process that opens the same file)."""

    def __init__(self, path: Path) -> None:
        self.path = path
        self.lock_path = path.with_suffix(".lock")
        self._closed = False
        self._f = open(path, "r+b")
        try:
            self.mm = mmap.mmap(self._f.fileno(), 0)
        except BaseException:
            self._f.close()
            raise
        if self.u64(_OFF_MAGIC) != RING_FILE_MAGIC:
            self.close()
            raise OSError(f"not a shm ring file: {path}")
        self.ring_bytes = self.u64(_OFF_RING_BYTES)
        if (
            self.ring_bytes <= 0
            or _HEADER_PAGE + self.ring_bytes > os.fstat(self._f.fileno()).st_size
        ):
            # the size word itself is garbled: nothing downstream can be
            # trusted and nothing in-file can rebuild it — refuse loudly
            # (ShmBroker.repair recreates the ring from topic meta)
            self.close()
            raise OSError(f"corrupt shm ring header (ring_bytes) in {path}")
        # repair-on-open: a torn multi-word header update (or external
        # corruption) shows up as impossible head/tail/seqno geometry
        if self._header_insane():
            with _Flock(self.lock_path):
                if self._header_insane():
                    self._reset_empty()
        from oryx_tpu_torch.common import ledger

        ledger.register("ring", self, live=lambda r: not r._closed)

    def _header_insane(self) -> bool:
        head, tail = self.u64(_OFF_HEAD), self.u64(_OFF_TAIL)
        nxt, base = self.u64(_OFF_NEXT_SEQNO), self.u64(_OFF_BASE_SEQNO)
        return tail > head or head - tail > self.ring_bytes or base > nxt

    def _reset_empty(self) -> None:
        """Loud last-resort repair: empty the ring at a consistent seqno.
        Unconsumed frames are lost — upstream layers replay from their
        offset ledgers (at-least-once), nothing is served silently wrong.
        Caller holds the writer flock."""
        seq = max(self.u64(_OFF_NEXT_SEQNO), self.u64(_OFF_BASE_SEQNO))
        self.set_u64(_OFF_HEAD, 0)
        self.set_u64(_OFF_TAIL, 0)
        self.set_u64(_OFF_NEXT_SEQNO, seq)
        self.set_u64(_OFF_BASE_SEQNO, seq)
        metrics.registry.counter("bus.repair.shm-reset").inc()
        log.warning(
            "bus repair: reset shm ring %s to empty at seqno %d "
            "(impossible head/tail geometry)", self.path, seq,
        )

    # -- header words -------------------------------------------------------

    def u64(self, off: int) -> int:
        return _U64.unpack_from(self.mm, off)[0]

    def set_u64(self, off: int, v: int) -> None:
        _U64.pack_into(self.mm, off, v)

    def close(self) -> None:
        if self._closed:  # idempotent: brokers and consumers both reach here
            return
        self._closed = True
        try:
            self.mm.close()
        except BufferError:
            # numpy views over the map are still alive somewhere; the OS
            # reclaims the mapping at process exit
            pass
        self._f.close()

    # -- consumer slots -----------------------------------------------------

    def claim_slot_and_snapshot(self, usable_slots: int) -> tuple[int, int, int, int, int]:
        """Claim a free guard slot (under the writer lock, so the claim and
        the head/tail/seqno snapshot are mutually consistent). Returns
        (slot, head, tail, next_seqno, base_seqno); the guard starts at
        ``tail`` so nothing can be reclaimed out from under the caller
        while it decides where to start."""
        with _Flock(self.lock_path):
            tail = self.u64(_OFF_TAIL)
            for s in range(min(usable_slots, _MAX_SLOTS)):
                off = _SLOTS_OFF + s * _SLOT_BYTES
                pid = self.u64(off)
                if pid != 0 and _pid_alive(pid):
                    continue
                if pid != 0:
                    metrics.registry.counter("bus.shm.evicted-consumers").inc()
                _U64.pack_into(self.mm, off + 8, tail)
                _U64.pack_into(self.mm, off + 16, time.monotonic_ns())
                self.set_u64(off, os.getpid())
                return (
                    s,
                    self.u64(_OFF_HEAD),
                    tail,
                    self.u64(_OFF_NEXT_SEQNO),
                    self.u64(_OFF_BASE_SEQNO),
                )
        raise OSError(
            f"shm ring {self.path.name}: all {min(usable_slots, _MAX_SLOTS)} "
            "consumer slots are claimed by live processes"
        )

    def set_guard(self, slot: int, pos: int) -> None:
        off = _SLOTS_OFF + slot * _SLOT_BYTES
        _U64.pack_into(self.mm, off + 8, pos)
        _U64.pack_into(self.mm, off + 16, time.monotonic_ns())

    def release_slot(self, slot: int) -> None:
        self.set_u64(_SLOTS_OFF + slot * _SLOT_BYTES, 0)

    def _min_guard(self) -> int | None:
        """Smallest guard position over live registered consumers (dead
        pids are evicted on sight). None when no consumer is registered."""
        best: int | None = None
        for s in range(_MAX_SLOTS):
            off = _SLOTS_OFF + s * _SLOT_BYTES
            pid = self.u64(off)
            if pid == 0:
                continue
            if not _pid_alive(pid):
                self.set_u64(off, 0)
                metrics.registry.counter("bus.shm.evicted-consumers").inc()
                continue
            pos = self.u64(off + 8)
            best = pos if best is None else min(best, pos)
        return best

    # -- write side (always under the partition flock) ----------------------

    def append(self, frames, full_block_ms: float) -> int:
        """Append (kind, flags, count, payload, crc|None) frames; assigns
        seqnos and publishes head after each frame. Returns records
        appended. ``crc=None`` computes it; a precomputed crc lets replay
        producers pay only a header pack + memcpy per frame."""
        rb = self.ring_bytes
        n = 0
        with _Flock(self.lock_path):
            head = self.u64(_OFF_HEAD)
            seq = self.u64(_OFF_NEXT_SEQNO)
            deadline = time.monotonic() + full_block_ms / 1000.0
            for kind, flags, count, payload, crc in frames:
                wire = blockcodec.HEADER_BYTES + blockcodec.pad8(len(payload))
                if wire > rb // 2:
                    raise ValueError(
                        f"frame of {wire} bytes exceeds half the shm ring "
                        f"({rb} bytes); raise oryx.bus.shm.ring-mb"
                    )
                rem = rb - head % rb
                if rem < blockcodec.HEADER_BYTES:
                    # dead zone too small for any header: skipped by rule
                    self._ensure_space(head, rem, deadline)
                    head += rem
                elif rem < wire:
                    head = self._write_pad(head, rem, seq, deadline)
                head = self._write_frame(
                    head, kind, flags, seq, count, payload, crc, wire, deadline
                )
                if kind != blockcodec.KIND_PAD:
                    seq += count
                    n += count
        return n

    def _write_frame(self, head, kind, flags, seq, count, payload, crc, wire, deadline):
        self._ensure_space(head, wire, deadline)
        if crc is None:
            crc = zlib.crc32(payload)
        off = _HEADER_PAGE + head % self.ring_bytes
        mm = self.mm
        blockcodec.HEADER.pack_into(
            mm, off, blockcodec.MAGIC, kind, flags, seq, count, len(payload), crc
        )
        body = off + blockcodec.HEADER_BYTES
        mm[body : body + len(payload)] = payload
        pad = blockcodec.pad8(len(payload)) - len(payload)
        if pad:
            mm[body + len(payload) : off + wire] = b"\x00" * pad
        if kind != blockcodec.KIND_PAD:
            self.set_u64(_OFF_NEXT_SEQNO, seq + count)
        crashpoint("bus.shm.publish.pre")
        self.set_u64(_OFF_HEAD, head + wire)  # publish last: torn = invisible
        crashpoint("bus.shm.publish.post")
        return head + wire

    def _write_pad(self, head, rem, seq, deadline):
        """A PAD frame covering the too-small remainder at the ring end."""
        self._ensure_space(head, rem, deadline)
        off = _HEADER_PAGE + head % self.ring_bytes
        blockcodec.HEADER.pack_into(
            self.mm, off, blockcodec.MAGIC, blockcodec.KIND_PAD, 0, seq, 0,
            rem - blockcodec.HEADER_BYTES, 0,
        )
        metrics.registry.counter("bus.shm.pad-frames").inc()
        self.set_u64(_OFF_HEAD, head + rem)
        return head + rem

    def _ensure_space(self, head: int, need: int, deadline: float) -> None:
        """Reclaim whole frames up to the slowest live consumer guard until
        ``need`` bytes fit; bounded blocking past that (backpressure —
        never a silent drop)."""
        rb = self.ring_bytes
        waited = False
        while True:
            tail = self.u64(_OFF_TAIL)
            if head + need - tail <= rb:
                return
            limit = self._min_guard()
            floor = head if limit is None else min(limit, head)
            new_tail, base = tail, None
            while new_tail < floor and head + need - new_tail > rb:
                nxt, b = self._skip_frame(new_tail, floor)
                if nxt is None:
                    break
                new_tail = nxt
                if b is not None:
                    base = b
            if new_tail != tail:
                self.set_u64(_OFF_TAIL, new_tail)
                if base is not None:
                    self.set_u64(_OFF_BASE_SEQNO, base)
                continue
            if time.monotonic() >= deadline:
                metrics.registry.counter("bus.shm.backpressure-timeouts").inc()
                raise BlockingIOError(
                    f"shm ring {self.path.name} full: a slow consumer holds "
                    f"the guard at {limit} (head {head}, ring {rb} bytes)"
                )
            if not waited:
                metrics.registry.counter("bus.shm.backpressure-waits").inc()
                waited = True
            time.sleep(0.001)

    def _skip_frame(self, tail: int, floor: int):
        """Advance tail past one frame/dead-zone. Returns (new_tail,
        new_base_seqno|None), or (None, None) when the next frame reaches
        past ``floor`` (guarded — cannot reclaim)."""
        rb = self.ring_bytes
        rem = rb - tail % rb
        if rem < blockcodec.HEADER_BYTES:
            return tail + rem, None
        off = _HEADER_PAGE + tail % rb
        magic, kind, _flags, seqno, count, length, _crc = blockcodec.HEADER.unpack_from(
            self.mm, off
        )
        if magic != blockcodec.MAGIC or blockcodec.HEADER_BYTES + length > rem:
            # unreachable unless the map was corrupted externally; resync
            return tail + 8, None
        wire = blockcodec.HEADER_BYTES + blockcodec.pad8(length)
        if tail + wire > floor:
            return None, None
        if kind == blockcodec.KIND_PAD:
            return tail + wire, None
        return tail + wire, seqno + count

    # -- fsck ----------------------------------------------------------------

    def fsck(self, repair: bool = False) -> dict:
        """Walk the published region [tail, head) validating every frame
        header and payload CRC. A break in the chain — garbled header,
        frame reaching past head, CRC mismatch — marks the durable
        frontier: everything before it is intact, everything after is
        suspect (a torn multi-byte head publish, or corruption under an
        already-published head). With ``repair=True`` the head rolls back
        to the frontier (``bus.repair.shm-head-rollback``) and impossible
        header geometry empties the ring loudly (``bus.repair.shm-reset``)
        — consumers then replay from upstream ledgers rather than decode
        garbage. Returns {"frames", "head-rollback", "reset"} where the
        action counts are 1 when taken, -1 when needed but repair=False."""
        report = {"frames": 0, "head-rollback": 0, "reset": 0}
        with _Flock(self.lock_path):
            if self._header_insane():
                if repair:
                    self._reset_empty()
                    report["reset"] = 1
                else:
                    report["reset"] = -1
                return report
            rb = self.ring_bytes
            head, pos = self.u64(_OFF_HEAD), self.u64(_OFF_TAIL)
            seq_frontier = None
            while pos < head:
                rem = rb - pos % rb
                if rem < blockcodec.HEADER_BYTES:
                    pos += rem
                    continue
                off = _HEADER_PAGE + pos % rb
                magic, kind, _flags, seqno, count, length, crc = (
                    blockcodec.HEADER.unpack_from(self.mm, off)
                )
                wire = blockcodec.HEADER_BYTES + blockcodec.pad8(length)
                if magic != blockcodec.MAGIC or wire > rem or pos + wire > head:
                    break
                if kind != blockcodec.KIND_PAD:
                    body = off + blockcodec.HEADER_BYTES
                    if zlib.crc32(self.mm[body : body + length]) != crc:
                        break
                    seq_frontier = seqno + count
                report["frames"] += 1
                pos += wire
            if pos < head:
                if repair:
                    self.set_u64(_OFF_HEAD, pos)
                    if seq_frontier is not None:
                        self.set_u64(_OFF_NEXT_SEQNO, seq_frontier)
                    report["head-rollback"] = 1
                    metrics.registry.counter("bus.repair.shm-head-rollback").inc()
                    log.warning(
                        "bus repair: rolled shm ring %s head back %d byte(s) "
                        "to the last intact frame", self.path, head - pos,
                    )
                else:
                    report["head-rollback"] = -1
        return report


class ShmBroker(Broker):
    """`shm:` scheme broker. Locator: ``shm:/dir[?ring_mb=N&...]``."""

    def __init__(
        self,
        root: str,
        ring_bytes: int | None = None,
        slots: int | None = None,
        full_block_ms: float | None = None,
        frame_records: int | None = None,
    ) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.ring_bytes = int(
            ring_bytes
            if ring_bytes is not None
            else float(_cfg("ring-mb", _DEF_RING_MB)) * (1 << 20)
        )
        self.slots = int(slots if slots is not None else _cfg("slots", _DEF_SLOTS))
        self.full_block_ms = float(
            full_block_ms
            if full_block_ms is not None
            else _cfg("full-block-ms", _DEF_FULL_BLOCK_MS)
        )
        self.frame_records = int(
            frame_records
            if frame_records is not None
            else _cfg("frame-records", _DEF_FRAME_RECORDS)
        )
        # offsets ledger + topic-dir deletion are byte-compatible with the
        # file bus; delegate instead of re-implementing the flocked JSON
        self._files = FileBroker(str(self.root))
        self._rings: dict[tuple[str, int], _Ring] = {}

    @staticmethod
    def options_from_query(query: str) -> dict:
        out: dict = {}
        if query:
            from urllib.parse import parse_qsl

            for k, v in parse_qsl(query):
                k = k.replace("-", "_")
                if k == "ring_mb":
                    out["ring_bytes"] = int(float(v) * (1 << 20))
                elif k == "ring_bytes":
                    out["ring_bytes"] = int(v)
                elif k in ("slots", "frame_records"):
                    out[k] = int(v)
                elif k == "full_block_ms":
                    out["full_block_ms"] = float(v)
        return out

    def locator(self) -> str:
        return f"shm:{self.root}"

    # -- admin --------------------------------------------------------------

    def _topic_dir(self, topic: str) -> Path:
        return self.root / topic

    def _meta_path(self, topic: str) -> Path:
        return self._topic_dir(topic) / ".meta.json"

    def create_topic(self, topic: str, partitions: int = 1, config: dict | None = None) -> None:
        d = self._topic_dir(topic)
        d.mkdir(parents=True, exist_ok=True)
        meta = self._meta_path(topic)
        with _Flock(d / ".meta.lock"):
            if not meta.exists():
                storage.commit_text(
                    meta,
                    json.dumps(
                        {
                            "partitions": max(1, partitions),
                            "config": config or {},
                            "ring-bytes": self.ring_bytes,
                        }
                    ),
                )
        for i in range(self._num_partitions(topic)):
            self._ensure_ring_file(topic, i)

    def topic_exists(self, topic: str) -> bool:
        return self._meta_path(topic).exists()

    def delete_topic(self, topic: str) -> None:
        for key in [k for k in self._rings if k[0] == topic]:
            self._rings.pop(key).close()
        self._files.delete_topic(topic)  # rmtree + offsets ledger cleanup

    def _num_partitions(self, topic: str) -> int:
        try:
            return int(json.loads(self._meta_path(topic).read_text())["partitions"])
        except (OSError, json.JSONDecodeError, KeyError):
            return 1

    def _topic_ring_bytes(self, topic: str) -> int:
        """The ring size every process must agree on: recorded in topic
        meta at creation, not taken from each broker's own defaults."""
        try:
            return int(json.loads(self._meta_path(topic).read_text())["ring-bytes"])
        except (OSError, json.JSONDecodeError, KeyError):
            return self.ring_bytes

    def _ring_path(self, topic: str, i: int) -> Path:
        return self._topic_dir(topic) / f"partition-{i}.ring"

    def _ensure_ring_file(self, topic: str, i: int) -> None:
        path = self._ring_path(topic, i)
        try:
            if path.stat().st_size >= _HEADER_PAGE:
                return
        except OSError:
            pass
        with _Flock(path.with_suffix(".lock")):
            try:
                if path.stat().st_size >= _HEADER_PAGE:
                    return
            except OSError:
                pass
            ring_bytes = self._topic_ring_bytes(topic)
            header = bytearray(_HEADER_PAGE)
            _U64.pack_into(header, _OFF_MAGIC, RING_FILE_MAGIC)
            _U64.pack_into(header, _OFF_RING_BYTES, ring_bytes)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            with open(tmp, "wb") as f:
                f.write(header)
                f.truncate(_HEADER_PAGE + ring_bytes)  # sparse data region
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # appears fully initialized or not at all
            storage.fsync_dir(path.parent)

    def _ring(self, topic: str, i: int) -> _Ring:
        ring = self._rings.get((topic, i))
        if ring is None:
            self._ensure_ring_file(topic, i)
            ring = self._rings[(topic, i)] = _Ring(self._ring_path(topic, i))
        return ring

    def repair(self, topic: str | None = None) -> dict:
        """fsck-style sweep: every partition ring's frame chain is CRC
        validated and repaired (_Ring.fsck), an unopenable ring file —
        bad magic, garbled size word — is recreated empty from the topic
        meta (``bus.repair.shm-recreated``; the upstream layer replays),
        and the shared offset-ledger machinery is swept via the file
        broker. Returns a count report."""
        report = {
            "frames": 0, "head-rollback": 0, "reset": 0,
            "recreated": 0, "tmp-swept": 0,
        }
        topics = (
            [topic]
            if topic is not None
            else [
                d.name
                for d in sorted(self.root.iterdir())
                if d.is_dir() and (d / ".meta.json").exists()
            ]
        )
        for t in topics:
            if not self.topic_exists(t):
                continue
            report["tmp-swept"] += storage.sweep_tmp(self._topic_dir(t))
            for i in range(self._num_partitions(t)):
                path = self._ring_path(t, i)
                try:
                    sub = self._ring(t, i).fsck(repair=True)
                except OSError:
                    # unopenable ring: recreate from topic meta (loud)
                    self._rings.pop((t, i), None)
                    with _Flock(path.with_suffix(".lock")):
                        path.unlink(missing_ok=True)
                    self._ensure_ring_file(t, i)
                    report["recreated"] += 1
                    metrics.registry.counter("bus.repair.shm-recreated").inc()
                    log.warning("bus repair: recreated unopenable shm ring %s", path)
                    continue
                for k, v in sub.items():
                    report[k] += v
        return report

    # -- offsets ------------------------------------------------------------

    def get_offsets(self, group: str, topic: str) -> dict[int, int]:
        return self._files.get_offsets(group, topic)

    def set_offsets(self, group: str, topic: str, offsets: dict[int, int]) -> None:
        self._files.set_offsets(group, topic, offsets)

    def latest_offsets(self, topic: str) -> dict[int, int]:
        return {
            i: self._ring(topic, i).u64(_OFF_NEXT_SEQNO)
            for i in range(self._num_partitions(topic))
        }

    def earliest_offsets(self, topic: str) -> dict[int, int]:
        """First retained record offset per partition (the ring reclaim
        floor — the analogue of the file bus post-retention floor)."""
        return {
            i: self._ring(topic, i).u64(_OFF_BASE_SEQNO)
            for i in range(self._num_partitions(topic))
        }

    # -- produce/consume ----------------------------------------------------

    def producer(self, topic: str) -> "_ShmProducer":
        if not self.topic_exists(topic):
            self.create_topic(topic, 1)
        return _ShmProducer(self, topic)

    def consumer(
        self, topic: str, group: str | None = None, from_beginning: bool = False,
        partitions: list[int] | None = None,
    ) -> "_ShmConsumer":
        if not self.topic_exists(topic):
            self.create_topic(topic, 1)
        return _ShmConsumer(self, topic, group, from_beginning, partitions)

    def close(self) -> None:
        """Drop every process-local ring handle (file + mmap). Idempotent;
        the ring files themselves stay on disk for other processes."""
        rings, self._rings = self._rings, {}
        for ring in rings.values():
            ring.close()


class _ShmProducer(TopicProducer):
    def __init__(self, broker: ShmBroker, topic: str) -> None:
        self._broker = broker
        self._topic = topic
        self._nparts = broker._num_partitions(topic)

    @property
    def update_broker(self) -> str:
        return self._broker.locator()

    @property
    def topic(self) -> str:
        return self._topic

    def send(self, key: str | None, message: str) -> None:
        p = partition_for(key, self._nparts)
        blob = (blockcodec.encode_record(key, message) + "\n").encode("utf-8")
        self._append(p, [(blockcodec.KIND_TEXT, 0, 1, blob, None)])

    def send_many(self, records) -> int:
        if self._nparts == 1:  # no bucketing pass on single-partition topics
            per = {0: records if isinstance(records, list) else list(records)}
        else:
            per = {}
            for key, message in records:
                per.setdefault(partition_for(key, self._nparts), []).append(
                    (key, message)
                )
        n = 0
        for p, recs in per.items():
            frames = [
                (blockcodec.KIND_TEXT, 0, count, blob, None)
                for blob, count in blockcodec.encode_wire_lines(
                    recs, slice_bytes=_TEXT_FRAME_SLICE_BYTES
                )
            ]
            n += self._append(p, frames)
        return n

    def send_interactions(
        self,
        users: np.ndarray,
        items: np.ndarray,
        values: np.ndarray,
        user_prefix: bytes = b"u",
        item_prefix: bytes = b"i",
        timestamps: np.ndarray | None = None,
        partition: int = 0,
    ) -> int:
        """Publish rating events as typed columnar frames: consumers get
        int32/f32 array views, no text ever exists. Chunked to
        ``oryx.bus.shm.frame-records`` per frame."""
        # cap frames to a quarter of the ring as well as frame-records, so
        # small rings (tests, bounded-memory deployments) never trip the
        # half-ring frame limit
        rec_bytes = 12 + (8 if timestamps is not None else 0)
        ring = self._broker._ring(self._topic, partition)
        step = max(1, min(self._broker.frame_records, ring.ring_bytes // 4 // rec_bytes))
        frames = []
        # sampled ambient trace context rides as a zero-count trace frame
        # (columnar payloads have nowhere to put a text record); untraced
        # publishes — the 100K events/s bench path — emit nothing
        hdr = tracing.header_record()
        if hdr is not None:
            frames.append(
                (blockcodec.KIND_TRACE, 0, 0, hdr[1].encode("utf-8"), None)
            )
        for a in range(0, len(values), step):
            b = min(len(values), a + step)
            payload, flags, crc = blockcodec.encode_interactions_payload(
                users[a:b],
                items[a:b],
                values[a:b],
                user_prefix,
                item_prefix,
                None if timestamps is None else timestamps[a:b],
            )
            frames.append((blockcodec.KIND_COLS, flags, b - a, payload, crc))
        return self._append(partition, frames)

    def send_payload(
        self, kind: int, flags: int, count: int, payload: bytes, crc: int,
        partition: int = 0,
    ) -> int:
        """Replay a pre-encoded frame payload (with its precomputed CRC):
        per-send cost is one header pack + one memcpy — the benchmark's
        zero-per-event-format-cost producer path."""
        return self._append(partition, [(kind, flags, count, payload, crc)])

    def _append(self, p: int, frames) -> int:
        ring = self._broker._ring(self._topic, p)
        n = ring.append(frames, self._broker.full_block_ms)
        metrics.registry.counter("bus.shm.frames").inc(len(frames))
        metrics.registry.counter("bus.shm.records").inc(n)
        return n

    def close(self) -> None:
        pass


class _ShmConsumer(TopicConsumer):
    """Reads frames straight out of the mapped ring.

    Positions are record offsets (seqnos), exactly like the file bus line
    offsets, and support mid-frame values: a budget that lands inside a
    frame slices the decoded arrays/lines and the next poll resumes at
    the same frame. The guard slot auto-advances to the current read
    point at each poll entry — everything handed out by the previous poll
    is released then — unless ``pin()`` is in effect.
    """

    def __init__(
        self, broker: ShmBroker, topic: str, group: str | None,
        from_beginning: bool, partitions: list[int] | None = None,
    ) -> None:
        self._broker = broker
        self._topic = topic
        self._group = group
        self._closed = False
        self._pinned = False
        nparts = broker._num_partitions(topic)
        parts = resolve_partitions(nparts, partitions)
        stored = broker.get_offsets(group, topic) if group else {}
        self._rings = {i: broker._ring(topic, i) for i in parts}
        self._slot: dict[int, int] = {}
        self._pos: dict[int, int] = {}
        self._cursor: dict[int, int] = {}
        # per-partition trace context captured from a KIND_TRACE frame,
        # attached to the next delivered block
        self._pending_trace: dict[int, str] = {}
        try:
            for i, ring in self._rings.items():
                slot, head, tail, nseq, bseq = ring.claim_slot_and_snapshot(broker.slots)
                self._slot[i] = slot
                if stored:
                    # stored offset older than the ring retains: clamp forward
                    # (Kafka earliest-reset semantics, same as the file bus)
                    self._pos[i] = max(int(stored.get(i, 0)), bseq)
                    self._cursor[i] = tail
                elif from_beginning:
                    self._pos[i] = bseq
                    self._cursor[i] = tail
                else:
                    self._pos[i] = nseq
                    self._cursor[i] = head
                    ring.set_guard(slot, head)
        except BaseException:
            # a claim partway through the ring set failed (e.g. all slots
            # taken on a later ring): release the slots already claimed so
            # the aborted constructor doesn't strand guard positions that
            # would stall ring reclaim until pid eviction notices
            for i, slot in self._slot.items():
                try:
                    self._rings[i].release_slot(slot)
                except OSError:
                    pass
            raise
        from oryx_tpu_torch.common import ledger

        ledger.register("consumer", self, live=lambda c: not c.closed())

    # -- guard lifetime -----------------------------------------------------

    def pin(self) -> None:
        """Freeze the guard: views stay valid across subsequent polls
        until release(). Used by multi-poll drains (the speed layer)."""
        self._pinned = True

    def release(self) -> None:
        """Release everything consumed so far and resume per-poll guard
        advance. Views handed out since pin() become invalid."""
        for i, ring in self._rings.items():
            ring.set_guard(self._slot[i], self._cursor[i])
        self._pinned = False

    # -- fetch core ---------------------------------------------------------

    def _next_block(self, i: int, budget: int):
        """One decoded block from partition i, or None: consecutive text
        frames merge into a RecordBlock; a columnar frame returns an
        InteractionBlock of zero-copy views (never mixed in one block)."""
        from oryx_tpu_torch.common.records import InteractionBlock, RecordBlock

        ring = self._rings[i]
        mm = ring.mm
        rb = ring.ring_bytes
        head = ring.u64(_OFF_HEAD)
        tail = ring.u64(_OFF_TAIL)
        cur = self._cursor[i]
        if cur < tail:
            cur = tail  # reclaimed under us (post-seek); scan from floor
        if not self._pinned:
            ring.set_guard(self._slot[i], cur)
        pos = self._pos[i]
        lines: list[bytes] = []
        taken = 0
        resynced = False
        while cur < head and taken < budget:
            rem = rb - cur % rb
            if rem < blockcodec.HEADER_BYTES:
                cur += rem  # dead zone at the ring end
                continue
            off = _HEADER_PAGE + cur % rb
            magic, kind, flags, seqno, count, length, crc = (
                blockcodec.HEADER.unpack_from(mm, off)
            )
            if magic != blockcodec.MAGIC or blockcodec.HEADER_BYTES + length > rem:
                # lost framing (corrupted header): hunt for the next
                # aligned frame boundary
                if not resynced:
                    metrics.registry.counter("bus.shm.crc-resyncs").inc()
                    resynced = True
                cur += 8
                continue
            wire = blockcodec.HEADER_BYTES + blockcodec.pad8(length)
            if kind == blockcodec.KIND_TRACE:
                # zero-count control frame: capture the context for the
                # next delivered block (count=0 keeps seqnos untouched,
                # so the pos/seqno arithmetic below must not see it)
                body = off + blockcodec.HEADER_BYTES
                payload = memoryview(mm)[body : body + length]
                if zlib.crc32(payload) == crc:
                    self._pending_trace[i] = bytes(payload).decode(
                        "utf-8", "replace"
                    )
                else:
                    metrics.registry.counter("bus.shm.crc-resyncs").inc()
                cur += wire
                continue
            if kind == blockcodec.KIND_PAD or pos >= seqno + count:
                cur += wire  # pad, or a frame we already consumed
                continue
            body = off + blockcodec.HEADER_BYTES
            payload = memoryview(mm)[body : body + length]
            if zlib.crc32(payload) != crc:
                # torn/corrupted block: its records are unrecoverable —
                # skip the whole frame and resync at the next boundary
                metrics.registry.counter("bus.shm.crc-resyncs").inc()
                cur += wire
                pos = max(pos, seqno + count)
                continue
            if pos < seqno:
                pos = seqno  # gap aged out of the ring: clamp forward
            start = pos - seqno
            take = min(count - start, budget - taken)
            if kind == blockcodec.KIND_TEXT:
                frame_lines = bytes(payload).split(b"\n")
                if frame_lines and frame_lines[-1] == b"":
                    frame_lines.pop()
                lines.extend(frame_lines[start : start + take])
                pos += take
                taken += take
                if start + take == count:
                    cur += wire
                continue
            # KIND_COLS
            if lines:
                break  # emit the accumulated text first; frame stays unread
            users, items, values, ts, up, ip = blockcodec.columns_from_payload(
                payload, count, flags
            )
            sl = slice(start, start + take)
            block = InteractionBlock(
                users[sl],
                items[sl],
                values[sl],
                None if ts is None else ts[sl],
                up,
                ip,
            )
            pos += take
            if start + take == count:
                cur += wire
            self._pos[i] = pos
            self._cursor[i] = cur
            block.trace = self._pending_trace.pop(i, None)
            return block
        self._pos[i] = pos
        self._cursor[i] = cur
        if lines:
            block = blockcodec.lines_to_block(lines, RecordBlock)
            if block is not None and block.trace is None:
                block.trace = self._pending_trace.pop(i, None)
            return block
        return None

    # -- TopicConsumer ------------------------------------------------------

    def poll(self, max_records: int = 1000, timeout: float = 0.1) -> list[KeyMessage]:
        deadline = time.monotonic() + timeout
        out: list[KeyMessage] = []
        while True:
            for i in sorted(self._pos):
                while len(out) < max_records:
                    block = self._next_block(i, max_records - len(out))
                    if block is None:
                        break
                    out.extend(block.iter_key_messages())
            if out or self._closed or time.monotonic() >= deadline:
                return out
            time.sleep(0.0005)

    def poll_block(self, max_records: int = 1000, timeout: float = 0.1):
        """One block per call: a RecordBlock of text records, or an
        InteractionBlock whose arrays are views over the shared map (valid
        until the next poll, or release() when pinned)."""
        deadline = time.monotonic() + timeout
        while True:
            for i in sorted(self._pos):
                block = self._next_block(i, max_records)
                if block is not None and len(block):
                    return block
            if self._closed or time.monotonic() >= deadline:
                return None
            time.sleep(0.0005)

    def positions(self) -> dict[int, int]:
        return dict(self._pos)

    def seek(self, positions: dict[int, int]) -> None:
        for i, off in positions.items():
            i = int(i)
            self._pos[i] = int(off)
            # rescan from the reclaim floor; the fetch loop skips frames
            # below the target seqno arithmetically (header reads only)
            self._cursor[i] = self._rings[i].u64(_OFF_TAIL)

    def commit(self) -> None:
        if self._group:
            self._broker.set_offsets(self._group, self._topic, self._pos)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            for i, ring in self._rings.items():
                ring.release_slot(self._slot[i])

    def closed(self) -> bool:
        return self._closed
