"""File-backed broker: durable cross-process bus on a shared filesystem.

The single-host production analogue of Kafka + ZooKeeper in the reference:
each topic is a directory of append-only partition logs (one JSON record
per line), and consumer-group offsets live in a ledger file per group —
the rebuild of the reference's ZK offset storage (KafkaUtils.java:123-162)
that makes layers resume where they left off. Appends are serialized with
fcntl advisory locks so batch/speed/serving processes can share one bus
directory. Multi-host deployments plug a real broker behind the same
Broker interface.

Segmented logs + retention: each partition is a sequence of segments —
archived `partition-<i>.seg<base>.log` files (base = absolute offset of
their first record) plus the active `partition-<i>.log` whose base lives
in a `partition-<i>.base` sidecar. The producer rolls the active segment
past `segment-bytes` and deletes archived segments older than
`retention-hours`. This bounds the replay-from-zero recovery story the
same way Kafka topic retention does for the reference (admin.md:78-81
tells operators to bound update-topic retention): speed/serving restart
by replaying from the earliest *retained* offset, and a stored offset
that has aged out clamps forward to it (Kafka earliest-reset semantics).
Offsets are absolute and survive segment rolls.

Layout:
    <root>/<topic>/partition-<i>.log           active segment
    <root>/<topic>/partition-<i>.base          {"base": N} for the active
    <root>/<topic>/partition-<i>.seg<J>.log    archived segment, base J
    <root>/<topic>/.meta.json                  {"partitions": N, "config": {...}}
    <root>/__offsets__/<group>.json            {"<topic>": {"0": 17, ...}}

Port note: a copy of ``oryx_tpu/bus/filebus.py`` (JAX-free), with its
imports pointed at ``oryx_tpu_torch``. The layout and the record format
are the JAX package's, so either package reads a bus directory the
other wrote.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import time
from pathlib import Path

from oryx_tpu_torch.bus import blockcodec
from oryx_tpu_torch.bus.core import (
    Broker,
    KeyMessage,
    TopicConsumer,
    TopicProducer,
    partition_for,
    resolve_partitions,
)
from oryx_tpu_torch.common import metrics, storage
from oryx_tpu_torch.common.crashpoints import crashpoint

log = logging.getLogger(__name__)

_OFFSETS_DIR = "__offsets__"

_TAIL_SCAN_BYTES = 1 << 20


def _repair_torn_tail(path: Path) -> int:
    """Truncate a partition segment to its last newline-terminated record.

    Every committed record ends in ``\\n`` (the producer writes whole
    payloads under the partition flock), so bytes past the final newline
    can only be the torn tail of a writer that died mid-append — never
    acknowledged, safe to drop, and *necessary* to drop before fresh
    appends land after them and weld two half-records into one corrupt
    line. Caller holds the partition flock. Returns bytes dropped
    (0 = intact); counted on ``bus.repair.truncated``."""
    try:
        size = path.stat().st_size
    except OSError:
        return 0
    if size == 0:
        return 0
    with open(path, "rb+") as f:
        f.seek(size - 1)
        if f.read(1) == b"\n":
            return 0
        good = 0  # byte just past the last newline; 0 = no complete record
        pos = size
        while pos > 0:
            step = min(_TAIL_SCAN_BYTES, pos)
            f.seek(pos - step)
            nl = f.read(step).rfind(b"\n")
            if nl != -1:
                good = pos - step + nl + 1
                break
            pos -= step
        dropped = size - good
        f.truncate(good)
        f.flush()
        os.fsync(f.fileno())
    metrics.registry.counter("bus.repair.truncated").inc()
    log.warning(
        "bus repair: truncated %d torn byte(s) off %s (never acknowledged)",
        dropped, path,
    )
    return dropped


class _Flock:
    def __init__(self, path: Path) -> None:
        self._path = path

    def __enter__(self):
        self._f = open(self._path, "a+")
        fcntl.flock(self._f.fileno(), fcntl.LOCK_EX)
        return self._f

    def __exit__(self, *exc):
        fcntl.flock(self._f.fileno(), fcntl.LOCK_UN)
        self._f.close()
        return False


class FileBroker(Broker):
    def __init__(self, root: str) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def locator(self) -> str:
        return f"file:{self.root}"

    # -- admin --------------------------------------------------------------

    def _topic_dir(self, topic: str) -> Path:
        return self.root / topic

    def _meta_path(self, topic: str) -> Path:
        return self._topic_dir(topic) / ".meta.json"

    def create_topic(self, topic: str, partitions: int = 1, config: dict | None = None) -> None:
        d = self._topic_dir(topic)
        d.mkdir(parents=True, exist_ok=True)
        meta = self._meta_path(topic)
        if not meta.exists():
            storage.commit_text(
                meta, json.dumps({"partitions": max(1, partitions), "config": config or {}})
            )
            for i in range(max(1, partitions)):
                (d / f"partition-{i}.log").touch()

    def topic_exists(self, topic: str) -> bool:
        return self._meta_path(topic).exists()

    def delete_topic(self, topic: str) -> None:
        import shutil

        shutil.rmtree(self._topic_dir(topic), ignore_errors=True)
        off_dir = self.root / _OFFSETS_DIR
        if off_dir.is_dir():
            for ledger in off_dir.glob("*.json"):
                with _Flock(ledger.with_suffix(".lock")):
                    try:
                        data = json.loads(ledger.read_text() or "{}")
                    except json.JSONDecodeError:
                        data = {}
                    if topic in data:
                        del data[topic]
                        storage.commit_text(ledger, json.dumps(data))

    def _num_partitions(self, topic: str) -> int:
        try:
            return int(json.loads(self._meta_path(topic).read_text())["partitions"])
        except (OSError, json.JSONDecodeError, KeyError):
            return 1

    def _topic_config(self, topic: str) -> dict:
        try:
            return json.loads(self._meta_path(topic).read_text()).get("config") or {}
        except (OSError, json.JSONDecodeError):
            return {}

    # -- segments ------------------------------------------------------------

    def _active_path(self, topic: str, i: int) -> Path:
        return self._topic_dir(topic) / f"partition-{i}.log"

    def _active_base(self, topic: str, i: int) -> int:
        side = self._topic_dir(topic) / f"partition-{i}.base"
        try:
            return int(json.loads(side.read_text())["base"])
        except (OSError, json.JSONDecodeError, KeyError, ValueError):
            return 0  # pre-segmentation logs: active segment starts at 0

    def _set_active_base(self, topic: str, i: int, base: int) -> None:
        side = self._topic_dir(topic) / f"partition-{i}.base"
        storage.commit_text(side, json.dumps({"base": base}))

    def _segments(self, topic: str, i: int) -> list[tuple[int, Path]]:
        """(base, path) of every live segment, archived first, active last."""
        d = self._topic_dir(topic)
        segs: list[tuple[int, Path]] = []
        prefix = f"partition-{i}.seg"
        for p in d.glob(f"{prefix}*.log"):
            try:
                segs.append((int(p.name[len(prefix):-len(".log")]), p))
            except ValueError:
                continue
        segs.sort()
        segs.append((self._active_base(topic, i), self._active_path(topic, i)))
        return segs

    def earliest_offsets(self, topic: str) -> dict[int, int]:
        """First retained offset per partition (post-retention floor)."""
        return {
            i: self._segments(topic, i)[0][0]
            for i in range(self._num_partitions(topic))
        }

    def apply_retention(self, topic: str, now: float | None = None) -> list[Path]:
        """Delete archived segments older than the topic's retention-hours
        (config key; None/absent = keep forever). The active segment is
        never deleted. Returns the deleted paths."""
        hours = self._topic_config(topic).get("retention-hours")
        if hours is None:
            return []
        cutoff = (time.time() if now is None else now) - float(hours) * 3600.0
        deleted = []
        for i in range(self._num_partitions(topic)):
            # delete only a prefix of the segment chain — a hole in the
            # middle would make offsets between surviving segments
            # unreadable
            for base, path in self._segments(topic, i)[:-1]:  # skip active
                try:
                    if path.stat().st_mtime >= cutoff:
                        break
                    path.unlink(missing_ok=True)
                    deleted.append(path)
                except OSError:
                    break
        return deleted

    # -- offsets ------------------------------------------------------------

    def _ledger_path(self, group: str) -> Path:
        d = self.root / _OFFSETS_DIR
        d.mkdir(parents=True, exist_ok=True)
        return d / f"{group}.json"

    def _quarantine_ledger(self, ledger: Path) -> None:
        """A ledger that no longer parses is moved aside (forensics, not
        deletion) — consumers then resume from the earliest retained
        offset, which is the at-least-once answer: replayed work, never
        lost acknowledged input. Caller holds the ledger flock."""
        aside = ledger.with_name(f"{ledger.name}.corrupt-{os.getpid()}")
        try:
            os.replace(ledger, aside)
        except OSError:
            return
        # the quarantine must survive the next crash too, or the group
        # replays its earliest-offset reset against a resurrected ledger
        storage.fsync_dir(ledger.parent)
        metrics.registry.counter("bus.repair.ledger-quarantined").inc()
        log.warning(
            "bus repair: quarantined unreadable offset ledger %s -> %s "
            "(group resumes from earliest retained offsets)", ledger, aside,
        )

    def get_offsets(self, group: str, topic: str) -> dict[int, int]:
        ledger = self._ledger_path(group)
        if not ledger.exists():
            return {}
        with _Flock(ledger.with_suffix(".lock")):
            try:
                data = json.loads(ledger.read_text() or "{}")
            except json.JSONDecodeError:
                self._quarantine_ledger(ledger)
                # the group HAD commits we can no longer read. Answering
                # {} would drop it into fresh-group-starts-at-latest and
                # silently skip everything since those commits; pinning
                # it to the earliest retained offsets is the at-least-
                # once answer (replayed work, never lost input).
                return self.earliest_offsets(topic)
        return {int(k): int(v) for k, v in data.get(topic, {}).items()}

    def set_offsets(self, group: str, topic: str, offsets: dict[int, int]) -> None:
        ledger = self._ledger_path(group)
        with _Flock(ledger.with_suffix(".lock")):
            try:
                data = json.loads(ledger.read_text() or "{}") if ledger.exists() else {}
            except json.JSONDecodeError:
                self._quarantine_ledger(ledger)
                data = {}
            data.setdefault(topic, {}).update({str(k): int(v) for k, v in offsets.items()})
            crashpoint("bus.file.offsets.pre")
            storage.commit_text(ledger, json.dumps(data))
            crashpoint("bus.file.offsets.post")

    def latest_offsets(self, topic: str) -> dict[int, int]:
        out: dict[int, int] = {}
        for i in range(self._num_partitions(topic)):
            p = self._active_path(topic, i)
            # Under the partition lock: a concurrent roll replaces the
            # active file before bumping the base sidecar, so an unlocked
            # read could pair a fresh (empty) active with the stale base
            # and report an offset lower than reality.
            with _Flock(p.with_suffix(".lock")):
                base = self._active_base(topic, i)
                out[i] = base + (_count_lines(p) if p.exists() else 0)
        return out

    # -- fsck / repair -------------------------------------------------------

    def _repair_partition(self, topic: str, i: int, report: dict) -> None:
        """One partition's fsck, under its flock: torn active tail is
        truncated to the last complete record, and a base sidecar that is
        unreadable — or *behind* the archived segment chain — is rebuilt
        from the chain. A stale base is what a producer killed mid-roll
        leaves (the active segment archived, the new base never
        committed); left alone it would shadow every record in the
        freshly archived segment, silently losing acknowledged input.
        Found by the kill-point sweep at ``bus.file.roll.mid``
        (``oryx_tpu_torch/tools/crash_sweep.py``)."""
        path = self._active_path(topic, i)
        with _Flock(path.with_suffix(".lock")):
            if _repair_torn_tail(path):
                report["truncated"] += 1
            side = self._topic_dir(topic) / f"partition-{i}.base"
            stored = 0
            parseable = True
            if side.exists():
                try:
                    stored = int(json.loads(side.read_text())["base"])
                except (OSError, json.JSONDecodeError, KeyError, ValueError):
                    parseable = False
            # the archived chain's end; the active base can legitimately
            # EXCEED it (retention deleted every archived segment) but can
            # never trail it
            chain_end = 0
            for seg_base, seg_path in self._segments(topic, i)[:-1]:
                try:
                    chain_end = max(chain_end, seg_base + _count_lines(seg_path))
                except OSError:
                    continue
            if not parseable or stored < chain_end:
                self._set_active_base(topic, i, chain_end)
                report["bases-rebuilt"] += 1
                metrics.registry.counter("bus.repair.base-rebuilt").inc()
                log.warning(
                    "bus repair: rebuilt %s base sidecar for "
                    "%s/partition-%d (%d -> %d)",
                    "unreadable" if not parseable else "stale",
                    topic, i, stored, chain_end,
                )

    def repair(self, topic: str | None = None) -> dict:
        """fsck-style sweep over the bus directory: torn segment tails,
        unreadable base sidecars, stale commit temp litter, unreadable
        offset ledgers. Safe against live writers (every mutation runs
        under the same flocks the producers take). Run automatically on
        consumer open and via ``oryx-tpu repair``. Returns a count
        report; every action also lands on a bus.repair.* counter."""
        report = {
            "truncated": 0, "bases-rebuilt": 0,
            "tmp-swept": 0, "ledgers-quarantined": 0,
        }
        topics = (
            [topic]
            if topic is not None
            else [
                d.name
                for d in sorted(self.root.iterdir())
                if d.is_dir() and d.name != _OFFSETS_DIR and (d / ".meta.json").exists()
            ]
        )
        for t in topics:
            if not self.topic_exists(t):
                continue
            report["tmp-swept"] += storage.sweep_tmp(self._topic_dir(t))
            for i in range(self._num_partitions(t)):
                self._repair_partition(t, i, report)
        off_dir = self.root / _OFFSETS_DIR
        if topic is None and off_dir.is_dir():
            report["tmp-swept"] += storage.sweep_tmp(off_dir)
            for ledger in sorted(off_dir.glob("*.json")):
                with _Flock(ledger.with_suffix(".lock")):
                    try:
                        json.loads(ledger.read_text() or "{}")
                    except json.JSONDecodeError:
                        self._quarantine_ledger(ledger)
                        report["ledgers-quarantined"] += 1
        if report["tmp-swept"]:
            metrics.registry.counter("bus.repair.tmp-swept").inc(report["tmp-swept"])
        return report

    # -- produce/consume ----------------------------------------------------

    def producer(self, topic: str) -> TopicProducer:
        if not self.topic_exists(topic):
            self.create_topic(topic, 1)
        return _FileProducer(self, topic)

    def consumer(
        self, topic: str, group: str | None = None, from_beginning: bool = False,
        partitions: list[int] | None = None,
    ) -> TopicConsumer:
        if not self.topic_exists(topic):
            self.create_topic(topic, 1)
        # repair-on-open: a consumer whose offsets were computed against a
        # torn tail (e.g. latest_offsets counting a half-record) would sit
        # one record in the future forever; fsck the topic first
        self.repair(topic)
        return _FileConsumer(self, topic, group, from_beginning, partitions)


def _count_lines(path: Path) -> int:
    # only newline-terminated lines are records: a torn final line (writer
    # died mid-append) was never acknowledged and must not shift offsets
    n = 0
    with open(path, "rb") as f:
        for line in f:
            n += line.endswith(b"\n")
    return n


_DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024
_READ_CHUNK_BYTES = 1 << 20

# -- record wire format -------------------------------------------------------
#
# One record per line: `<key>\t<message>` with backslash escapes; see
# bus/blockcodec.py, the single home of both the text and the binary
# frame codecs (shared with netbus and shmbus so the formats cannot
# drift). The old private names stay as aliases for callers that grew
# up importing them from here.

_ESC_MAP = blockcodec._ESC_MAP
_NEEDS_ESC = blockcodec._NEEDS_ESC
_NEEDS_ESC_BODY = blockcodec._NEEDS_ESC_BODY
_SENTINEL = blockcodec._SENTINEL
_enc_field = blockcodec.enc_field
_encode_record = blockcodec.encode_record
_unescape = blockcodec.unescape


class _FileProducer(TopicProducer):
    def __init__(self, broker: FileBroker, topic: str) -> None:
        self._broker = broker
        self._topic = topic
        self._nparts = broker._num_partitions(topic)
        cfg = broker._topic_config(topic)
        self._segment_bytes = int(cfg.get("segment-bytes") or _DEFAULT_SEGMENT_BYTES)
        self._has_retention = cfg.get("retention-hours") is not None

    @property
    def update_broker(self) -> str:
        return self._broker.locator()

    @property
    def topic(self) -> str:
        return self._topic

    def send(self, key: str | None, message: str) -> None:
        p = partition_for(key, self._nparts)
        self._append_lines(p, _encode_record(key, message) + "\n")

    # One buffered write's worth of payload; also bounds how far a batch
    # can overshoot segment-bytes (the roll check runs once per slice).
    _WRITE_SLICE_BYTES = 4 * 1024 * 1024

    def send_many(self, records) -> int:
        """One flock + one buffered write per ~4MB slice per partition —
        the file-bus analogue of the reference producer's batching
        (TopicProducerImpl.java:194-202). A million-row model publish is
        a handful of lock/open/write cycles instead of a million, while
        segment rolls still happen at slice granularity so retention and
        replay stay bounded for arbitrarily large batches.

        Per-record work is kept off the hot path: the partition and the
        encoded key are cached per key object (speed-layer batches carry
        one constant key), and the needs-escape scan runs as ONE regex
        pass over each joined slice — a clean slice (the overwhelmingly
        common case: messages are JSON, keys are short tokens) is joined
        and written without ever touching records individually."""
        pending: dict[int, list[tuple[str, str]]] = {}
        pending_bytes = [0] * self._nparts
        pending_nuls = [0] * self._nparts
        n = 0

        def flush(p: int) -> None:
            recs = pending.pop(p, None)
            if not recs:
                return
            nuls, pending_nuls[p] = pending_nuls[p], 0
            pending_bytes[p] = 0
            # one pass over the joined slice instead of a regex scan per
            # record: \ and \r never occur in a clean framed slice, and a
            # raw \t / \n / \0 inside a message shows up as a count
            # mismatch against the expected separator/None-marker counts
            # (keys are already escaped). Any hit re-encodes the slice per
            # record (_enc_field no-ops on clean fields).
            blob = "\n".join(ek + "\t" + m for ek, m in recs)
            if (
                _NEEDS_ESC_BODY.search(blob) is not None
                or blob.count("\n") != len(recs) - 1
                or blob.count("\t") != len(recs)
                or blob.count("\x00") != nuls
            ):
                blob = "\n".join(ek + "\t" + _enc_field(m) for ek, m in recs)
            self._append_lines(p, blob + "\n")

        last_key: str | None | object = _SENTINEL
        p = 0
        ek = ""
        for key, message in records:
            if key is not last_key:
                p = partition_for(key, self._nparts)
                ek = "\x00" if key is None else _enc_field(key)
                last_key = key
            pending.setdefault(p, []).append((ek, message))
            pending_bytes[p] += len(ek) + len(message) + 2
            pending_nuls[p] += ek == "\x00"
            n += 1
            if pending_bytes[p] >= self._WRITE_SLICE_BYTES:
                flush(p)
        for p in list(pending):
            flush(p)
        return n

    def _append_lines(self, p: int, payload: str) -> None:
        path = self._broker._topic_dir(self._topic) / f"partition-{p}.log"
        with _Flock(path.with_suffix(".lock")):
            # a writer that died mid-append left a torn (un-acknowledged)
            # tail; it MUST go before fresh bytes land after it, or the
            # two half-records weld into one corrupt line
            _repair_torn_tail(path)
            try:
                if path.stat().st_size >= self._segment_bytes:
                    self._roll(p, path)
            except OSError:
                pass
            crashpoint("bus.file.append.pre")
            with open(path, "a", encoding="utf-8") as f:
                f.write(payload)
                f.flush()
            crashpoint("bus.file.append.post")

    def _roll(self, partition: int, path: Path) -> None:
        """Archive the full active segment and start a fresh one (under
        the partition flock). Retention runs opportunistically here so a
        long-lived bus stays bounded without an external GC process."""
        broker = self._broker
        base = broker._active_base(self._topic, partition)
        n = _count_lines(path)
        if n == 0:
            return
        archived = path.with_name(f"partition-{partition}.seg{base:020d}.log")
        if archived.exists():
            # the sidecar is stale — a writer died mid-roll (segment
            # archived, new base never committed) and we are about to
            # archive a fresh active over its segment, destroying
            # acknowledged records. Re-anchor the base past the archived
            # chain first; the active's records shift to the repaired
            # offsets, the archive keeps its own.
            for seg_base, seg_path in broker._segments(self._topic, partition)[:-1]:
                try:
                    base = max(base, seg_base + _count_lines(seg_path))
                except OSError:
                    continue
            broker._set_active_base(self._topic, partition, base)
            metrics.registry.counter("bus.repair.base-rebuilt").inc()
            log.warning(
                "bus repair: roll found stale base for %s/partition-%d; "
                "re-anchored to %d past the archived chain",
                self._topic, partition, base,
            )
            archived = path.with_name(f"partition-{partition}.seg{base:020d}.log")
        os.replace(path, archived)
        storage.fsync_dir(path.parent)
        crashpoint("bus.file.roll.mid")
        broker._set_active_base(self._topic, partition, base + n)
        path.touch()
        if self._has_retention:
            broker.apply_retention(self._topic)

    def close(self) -> None:
        pass


class _FileConsumer(TopicConsumer):
    def __init__(
        self, broker: FileBroker, topic: str, group: str | None,
        from_beginning: bool, partitions: list[int] | None = None,
    ) -> None:
        self._broker = broker
        self._topic = topic
        self._group = group
        self._closed = False
        nparts = broker._num_partitions(topic)
        parts = resolve_partitions(nparts, partitions)
        stored = broker.get_offsets(group, topic) if group else {}
        if stored:
            # a stored offset older than retention clamps forward to the
            # earliest retained record (Kafka earliest-reset semantics)
            earliest = broker.earliest_offsets(topic)
            self._pos = {
                i: max(stored.get(i, 0), earliest.get(i, 0)) for i in parts
            }
        elif from_beginning:
            earliest = broker.earliest_offsets(topic)
            self._pos = {i: earliest.get(i, 0) for i in parts}
        else:
            latest = broker.latest_offsets(topic)
            self._pos = {i: latest.get(i, 0) for i in parts}
        # (segment base, byte position of record self._pos[i]) per
        # partition; established lazily (one O(n) line skip), then advanced
        # incrementally so each poll seeks instead of re-reading. Survives
        # segment rolls: a rolled active keeps its base in the archived
        # name, so the cached byte stays valid for the same content.
        self._cursor: dict[int, tuple[int, int]] = {}
        from oryx_tpu_torch.common import ledger

        ledger.register("consumer", self, live=lambda c: not c.closed())

    def _read_partition_raw(self, i: int, budget: int, out: list[bytes]) -> None:
        """Append up to `budget` complete raw record lines (bytes, newline
        stripped) from partition i, walking the segment chain from
        self._pos[i]. Decoding is the caller's job — the hot consume path
        (poll_block) decodes whole batches columnar instead."""
        broker = self._broker
        while budget > 0:
            segs = broker._segments(self._topic, i)
            pos = self._pos[i]
            if pos < segs[0][0]:
                pos = self._pos[i] = segs[0][0]  # aged past: clamp forward
                self._cursor.pop(i, None)
            idx = len(segs) - 1
            while idx > 0 and segs[idx][0] > pos:
                idx -= 1
            seg_base, seg_path = segs[idx]
            is_active = idx == len(segs) - 1
            if not seg_path.exists():
                return
            got = 0
            with open(seg_path, "rb") as f:
                cur = self._cursor.get(i)
                if cur is not None and cur[0] == seg_base:
                    f.seek(cur[1])
                else:
                    for _ in range(pos - seg_base):
                        if not f.readline():
                            break
                # chunked reads + one split, with the byte cursor tracked
                # arithmetically — per-record readline()+tell() was ~20% of
                # the drain path. Over-read past `budget` is fine: the
                # cursor only advances over taken lines and every call
                # seeks to it first.
                byte0 = f.tell()
                consumed = 0
                while budget > 0:
                    chunk = f.read(_READ_CHUNK_BYTES)
                    if not chunk:
                        break
                    nl = chunk.rfind(b"\n")
                    # a record larger than the chunk has no newline yet:
                    # keep growing until one appears or the data truly
                    # ends (then it's a partial in-flight append)
                    while nl == -1 and len(chunk) % _READ_CHUNK_BYTES == 0:
                        more = f.read(_READ_CHUNK_BYTES)
                        if not more:
                            break
                        chunk += more
                        nl = chunk.rfind(b"\n")
                    if nl == -1:
                        break  # partial tail of an in-flight append; retry
                    lines = chunk[: nl + 1].split(b"\n")
                    lines.pop()  # trailing empty piece after the last \n
                    if len(lines) > budget:
                        lines = lines[:budget]
                        taken = sum(map(len, lines)) + len(lines)
                    else:
                        taken = nl + 1
                    got += len(lines)
                    consumed += taken
                    if b"" in lines:
                        lines = [ln for ln in lines if ln]
                    out.extend(lines)
                    budget -= len(lines)
                    if taken < len(chunk):
                        f.seek(byte0 + consumed)  # rewind the over-read
                if got:
                    self._cursor[i] = (seg_base, byte0 + consumed)
            self._pos[i] += got
            if is_active or got == 0:
                # active exhausted, or an archived segment yielded nothing
                # (roll race: re-resolve next poll instead of spinning)
                return
            # archived segment exhausted: fall through to the next one

    @staticmethod
    def _decode_line(line: bytes) -> KeyMessage | None:
        return blockcodec.decode_line(line)

    def _read_partition(self, i: int, budget: int, out: list[KeyMessage]) -> None:
        """Append up to `budget` records from partition i."""
        while budget > 0:
            raw: list[bytes] = []
            self._read_partition_raw(i, budget, raw)
            if not raw:
                return
            exhausted = len(raw) < budget  # raw gave all it currently has
            for line in raw:
                rec = self._decode_line(line)
                if rec is not None:
                    out.append(rec)
                    budget -= 1
            if exhausted:
                return

    def poll(self, max_records: int = 1000, timeout: float = 0.1) -> list[KeyMessage]:
        deadline = time.monotonic() + timeout
        while True:
            out: list[KeyMessage] = []
            for i in sorted(self._pos):
                self._read_partition(i, max_records - len(out), out)
                if len(out) >= max_records:
                    return out
            if out or self._closed or time.monotonic() >= deadline:
                return out
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))

    def poll_block(self, max_records: int = 1000, timeout: float = 0.1):
        """Columnar poll: raw record lines are sliced with bytes ops — no
        per-record decoding or KeyMessage construction. The tab wire
        format means even JSON payloads ("UP" deltas, MODEL PMML) carry
        no escapes, so effectively every record takes the fast path. This
        is what lets one consumer thread keep up with 100K+ events/s."""
        from oryx_tpu_torch.common.records import RecordBlock

        deadline = time.monotonic() + timeout
        while True:
            raw: list[bytes] = []
            for i in sorted(self._pos):
                self._read_partition_raw(i, max_records - len(raw), raw)
                if len(raw) >= max_records:
                    break
            if raw:
                return self._lines_to_block(raw, RecordBlock)
            if self._closed or time.monotonic() >= deadline:
                return None
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))

    def _lines_to_block(self, raw: list[bytes], RecordBlock):
        return _lines_to_block_standalone(raw, RecordBlock)

    def positions(self) -> dict[int, int]:
        return dict(self._pos)

    def seek(self, positions: dict[int, int]) -> None:
        for i, off in positions.items():
            i = int(i)
            self._pos[i] = int(off)
            # drop the cached byte cursor; the next read re-establishes it
            self._cursor.pop(i, None)

    def commit(self) -> None:
        if self._group:
            self._broker.set_offsets(self._group, self._topic, self._pos)

    def close(self) -> None:
        self._closed = True

    def closed(self) -> bool:
        return self._closed


# transported-batch codec aliases (implementation: bus/blockcodec.py,
# shared with netbus and shmbus so the wire formats cannot drift)
_lines_to_block_standalone = blockcodec.lines_to_block
_NEEDS_ESC_B = blockcodec._NEEDS_ESC_B
_enc_field_b = blockcodec.enc_field_b
_encode_wire_lines = blockcodec.encode_wire_lines
_decode_wire_lines = blockcodec.decode_wire_lines
_encode_block_lines = blockcodec.encode_block_lines
