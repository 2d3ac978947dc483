"""Shared wire codec for record batches: one module, two formats.

Every transport that ships record batches — the file bus's on-disk
segments, the TCP bus's length-prefixed frames, and the shared-memory
ring buffer — encodes them through here, so the formats cannot drift
between producers and consumers of different brokers.

Text format (kind=1, and the bare on-disk/netbus form): one record per
line, ``<key>\\t<message>`` with backslash escapes for ``\\ \\t \\n \\r
\\0`` and a lone NUL byte for a None key. Chosen over JSON-per-line
because framework messages are themselves JSON ("UP" deltas, MODEL PMML)
and JSON-in-JSON escapes every quote; with tab framing typical records
carry no escapes and both ends are pure byte slicing. Legacy
``{"k":...,"m":...}`` lines still decode.

Binary columnar format (kind=2): a fixed 32-byte frame header (magic,
kind, flags, seqno, count, length, crc32) followed by a short prefix
table and contiguous typed columns — user ids int32, item ids int32,
values float32, optional timestamps int64. A consumer decodes the whole
frame as numpy array *views* over the transport buffer (zero-copy): the
speed layer's parse stage becomes array arithmetic instead of text
splitting. Control messages (MODEL/MODEL-REF) travel as text frames
(kind=1) over the same framing, so one stream carries both.

Frame header layout (little-endian, 32 bytes):

    offset  size  field
    0       4     magic   0x4B4C4252 (b"RBLK")
    4       2     kind    0=pad/wrap  1=text lines  2=interaction columns
                          3=trace context (count=0: occupies no offsets)
                          4=pre-parsed HTTP request batch (native front)
    6       2     flags   bit 0: columns carry timestamps
    8       8     seqno   absolute topic offset of the first record
    16      4     count   records in the frame
    20      4     length  payload bytes (excluding header and padding)
    24      4     crc     zlib.crc32 of the payload
    28      4     (reserved/zero)

On the wire a frame occupies ``32 + pad8(length)`` bytes: payloads are
zero-padded to an 8-byte boundary so successive frames (and the int32
columns inside them) stay aligned.

Port note: a copy of ``oryx_tpu/bus/blockcodec.py`` (JAX-free), with its
imports pointed at ``oryx_tpu_torch``. The two packages share the
on-disk and wire formats byte for byte.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

MAGIC = 0x4B4C4252  # b"RBLK" little-endian
KIND_PAD = 0
KIND_TEXT = 1
KIND_COLS = 2
# trace-context carrier for the columnar shm path (count=0, so seqno /
# offset arithmetic is undisturbed); the text formats carry the same
# context as a reserved "@trc" record line instead
KIND_TRACE = 3
# pre-parsed HTTP request batch from the native serving front
# (native/httpfront.cpp hands these to serving/native_front.py); seqno
# counts requests since front start, count = records in the frame
KIND_HTTP = 4
FLAG_TIMESTAMPS = 1

# a trace control record's encoded line starts with this (the "@trc" key
# needs no escaping); common.tracing owns the key + message format
TRACE_LINE_PREFIX = b"@trc\t"

HEADER = struct.Struct("<IHHQIII4x")
HEADER_BYTES = HEADER.size  # 32
assert HEADER_BYTES == 32


def pad8(n: int) -> int:
    return (n + 7) & ~7


class FrameError(ValueError):
    """Structurally invalid frame (bad magic / insane length)."""


class FrameCrcError(FrameError):
    """Frame header parsed but the payload failed its CRC."""


# ---------------------------------------------------------------------------
# Text record codec (moved verbatim from bus/filebus.py so netbus, filebus
# and shmbus share one implementation)
# ---------------------------------------------------------------------------

_ESC_MAP = {0x5C: 0x5C, 0x74: 0x09, 0x6E: 0x0A, 0x72: 0x0D, 0x30: 0x00}
_NEEDS_ESC = re.compile(r"[\\\t\n\r\x00]")  # one C scan per field, not 5
# batch form for joined slices: \t and \n are the legitimate separators
# and \x00 the legitimate None-key marker there, so those three are
# checked by count, not by pattern
_NEEDS_ESC_BODY = re.compile(r"[\\\r]")
_NEEDS_ESC_B = re.compile(rb"[\\\t\n\r\x00]")
_SENTINEL = object()


def enc_field(s: str) -> str:
    if _NEEDS_ESC.search(s) is not None:
        s = (
            s.replace("\\", "\\\\")
            .replace("\t", "\\t")
            .replace("\n", "\\n")
            .replace("\r", "\\r")
            .replace("\x00", "\\0")
        )
    return s


def enc_field_b(b: bytes) -> bytes:
    if _NEEDS_ESC_B.search(b) is not None:
        b = (
            b.replace(b"\\", b"\\\\")
            .replace(b"\t", b"\\t")
            .replace(b"\n", b"\\n")
            .replace(b"\r", b"\\r")
            .replace(b"\x00", b"\\0")
        )
    return b


def encode_record(key: str | None, message: str) -> str:
    k = "\x00" if key is None else enc_field(key)
    return k + "\t" + enc_field(message)


def unescape(b: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(b)
    while i < n:
        c = b[i]
        if c == 0x5C and i + 1 < n:
            out.append(_ESC_MAP.get(b[i + 1], b[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return bytes(out)


def decode_line(line: bytes):
    """One raw line -> KeyMessage, or None for a corrupt line (skip it)."""
    from oryx_tpu_torch.bus.core import KeyMessage

    if line.startswith(b'{"k":'):  # legacy JSON-per-line record
        import json

        try:
            rec = json.loads(line)
            return KeyMessage(rec.get("k"), rec.get("m", ""))
        except json.JSONDecodeError:
            pass  # not legacy after all; try the tab format
    tab = line.find(b"\t")
    if tab == -1:
        return None  # corrupt complete line: skip it for good
    kf, mf = line[:tab], line[tab + 1 :]
    # the None sentinel is a LITERAL lone NUL (the encoder escapes any
    # real NUL), so test before unescaping
    if kf == b"\x00":
        key = None
    else:
        key = (unescape(kf) if b"\\" in kf else kf).decode("utf-8", "replace")
    if b"\\" in mf:
        mf = unescape(mf)
    return KeyMessage(key, mf.decode("utf-8", "replace"))


def encode_wire_lines(records, slice_bytes: int = 8 << 20):
    """Yield (blob, count) slices of tab-framed lines for an iterable of
    (key, message) pairs — the producer-side transport encoding.

    Messages are escaped per same-key run, not per record: the hot caller
    (the speed layer's UP publish, ~60K escape-free JSON messages under
    one key per micro-batch) pays one regex scan + two joins per run
    instead of 60K regex calls."""
    parts: list[str] = []  # encoded line groups for the current slice
    run: list[str] = []  # raw messages sharing the current key
    size = n = 0
    last_key: object = _SENTINEL
    ek = ""

    def close_run() -> None:
        nonlocal run
        if not run:
            return
        body = "\n".join(run)
        pref = ek + "\t"
        # membership scans, not regex: CPython's str __contains__ is a
        # memchr-speed scan per needle, ~10x re.search over the same
        # bytes. \n is checked by count, since it is the legitimate joiner
        if (
            "\\" not in body
            and "\r" not in body
            and "\t" not in body
            and "\x00" not in body
            and body.count("\n") == len(run) - 1
        ):
            parts.append(pref + ("\n" + pref).join(run))
        else:
            parts.append("\n".join(pref + enc_field(m) for m in run))
        run = []

    for key, message in records:
        if key is not last_key:
            close_run()
            ek = "\x00" if key is None else enc_field(key)
            last_key = key
        run.append(message)
        size += len(ek) + len(message) + 2
        n += 1
        if size >= slice_bytes:
            close_run()
            yield ("\n".join(parts) + "\n").encode("utf-8"), n
            parts, size, n = [], 0, 0
    close_run()
    if parts:
        yield ("\n".join(parts) + "\n").encode("utf-8"), n


def decode_wire_lines(blob: bytes):
    """Inverse of encode_wire_lines: yield (key, message) pairs."""
    for line in blob.split(b"\n"):
        if not line:
            continue
        rec = decode_line(line)
        if rec is not None:
            yield rec.key, rec.message


def encode_block_lines(block) -> bytes:
    """A RecordBlock as a tab-framed line blob (poll response transport).

    A block carrying a trace context re-emits it as a leading "@trc"
    line, so the context survives the netbus poll hop (server strips it
    into ``block.trace``, the wire re-frames it, the client's
    ``lines_to_block`` re-attaches it)."""
    head = b""
    trace = getattr(block, "trace", None)
    if trace:
        if isinstance(trace, str):
            trace = trace.encode("utf-8")
        head = TRACE_LINE_PREFIX + trace + b"\n"
    msgs = block.messages.tolist()
    if block.keys is None:
        return head + b"".join(b"\x00\t" + enc_field_b(m) + b"\n" for m in msgs)
    keys = block.keys.tolist()
    nones = (
        block.none_keys.tolist()
        if block.none_keys is not None
        else [False] * len(keys)
    )
    return head + b"".join(
        (b"\x00" if nn else enc_field_b(k)) + b"\t" + enc_field_b(m) + b"\n"
        for k, m, nn in zip(keys, msgs, nones)
    )


def lines_to_block(raw: list[bytes], RecordBlock):
    # trace control records ("@trc" lines): a producer prepends at most
    # one per batch, so the common shapes are an O(1) head check plus one
    # memchr-speed scan of the joined blob for the mid-batch case (two
    # producer batches coalesced into one poll); the per-line Python
    # filter runs only when that scan hits. The last header wins.
    trace = None
    if raw and raw[0].startswith(TRACE_LINE_PREFIX):
        trace = raw[0][len(TRACE_LINE_PREFIX):]
        raw = raw[1:]
    if not raw:
        return None
    # vectorized fast path: a batch is nearly always escape-free,
    # non-legacy (one memchr over the joined blob) and single-key
    # ("UP" runs, None-keyed input) — verify every line shares line
    # 0's key prefix, then strip it with one C-level memcpy view. No
    # per-line Python: this path carries the 100K+ events/s drain.
    blob = b"\n".join(raw)
    if b"\n" + TRACE_LINE_PREFIX in blob:
        kept = []
        for line in raw:
            if line.startswith(TRACE_LINE_PREFIX):
                trace = line[len(TRACE_LINE_PREFIX):]
            else:
                kept.append(line)
        raw = kept
        if not raw:
            return None
        blob = b"\n".join(raw)
    trace_s = trace.decode("utf-8", "replace") if trace is not None else None
    if b"\\" not in blob and b'{"k":' not in blob:
        tab = raw[0].find(b"\t")
        if tab != -1:
            pref = raw[0][: tab + 1]
            arr = np.array(raw, dtype="S")
            w = arr.dtype.itemsize
            m = w - len(pref)
            if m > 0 and bool(np.char.startswith(arr, pref).all()):
                body = arr.view("S1").reshape(len(raw), w)[:, len(pref):]
                msgs_a = np.ascontiguousarray(body).view(f"S{m}").ravel()
                key = pref[:-1]
                if key == b"\x00":
                    block = RecordBlock(None, msgs_a)  # no key column
                else:
                    block = RecordBlock(
                        np.full(len(raw), key, dtype=f"S{max(1, len(key))}"),
                        msgs_a,
                        None,
                    )
                block.trace = trace_s
                return block
    msgs: list[bytes] = []
    keys: list[bytes] = []
    nones: list[bool] = []
    any_key = False
    for line in raw:
        if b"\\" not in line and not line.startswith(b'{"k":'):
            tab = line.find(b"\t")
            if tab != -1:
                kf = line[:tab]
                if kf == b"\x00":
                    keys.append(b"")
                    nones.append(True)
                else:
                    keys.append(kf)
                    nones.append(False)
                    any_key = True
                msgs.append(line[tab + 1 :])
                continue
        rec = decode_line(line)  # legacy/escaped/corrupt: slow path
        if rec is None:
            continue
        if rec.key is None:
            keys.append(b"")
            nones.append(True)
        else:
            keys.append(rec.key.encode("utf-8"))
            nones.append(False)
            any_key = True
        msgs.append(rec.message.encode("utf-8"))
    if not msgs:
        return None
    np_msgs = np.array(msgs, dtype="S")
    if not any_key:
        block = RecordBlock(None, np_msgs)
    else:
        block = RecordBlock(
            np.array(keys, dtype="S"),
            np_msgs,
            np.array(nones, dtype=bool) if any(nones) else None,
        )
    block.trace = trace_s
    return block


# ---------------------------------------------------------------------------
# Binary frames
# ---------------------------------------------------------------------------


def encode_frame(kind: int, flags: int, seqno: int, count: int,
                 payload: bytes, crc: int | None = None) -> bytes:
    """Header + payload, zero-padded to an 8-byte boundary. Pass a
    precomputed ``crc`` to replay an identical payload with only a header
    rewrite (the benchmark's zero-per-event-cost producer path)."""
    if crc is None:
        crc = zlib.crc32(payload)
    head = HEADER.pack(MAGIC, kind, flags, seqno, count, len(payload), crc)
    tail = b"\x00" * (pad8(len(payload)) - len(payload))
    return head + payload + tail


def encode_text_frame(seqno: int, blob: bytes, count: int) -> bytes:
    """A tab-framed line blob (from encode_wire_lines/encode_block_lines)
    as one binary frame."""
    return encode_frame(KIND_TEXT, 0, seqno, count, blob)


def encode_interactions_payload(
    users: np.ndarray,
    items: np.ndarray,
    values: np.ndarray,
    user_prefix: bytes = b"u",
    item_prefix: bytes = b"i",
    timestamps: np.ndarray | None = None,
) -> tuple[bytes, int, int]:
    """Columnar payload for numeric rating events: (payload, flags, crc).

    ``users``/``items`` are int32 id codes; the short prefixes record how
    they map back to the string id space (``u123`` / ``i45``), so the
    text rendering of a frame is recoverable without carrying strings.
    Layout: u8 uplen, u8 iplen, u16 reserved, prefixes, zero padding to
    an 8-byte boundary, then users[i32], items[i32], values[f32] and
    (flagged) timestamps[i64], each contiguous.
    """
    users = np.ascontiguousarray(users, dtype=np.int32)
    items = np.ascontiguousarray(items, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float32)
    if not (len(users) == len(items) == len(values)):
        raise ValueError("column length mismatch")
    if len(user_prefix) > 255 or len(item_prefix) > 255:
        raise ValueError("id prefix longer than 255 bytes")
    sub = struct.pack("<BBH", len(user_prefix), len(item_prefix), 0)
    sub += user_prefix + item_prefix
    sub += b"\x00" * (pad8(len(sub)) - len(sub))
    parts = [sub, users.tobytes(), items.tobytes(), values.tobytes()]
    flags = 0
    if timestamps is not None:
        parts.append(np.ascontiguousarray(timestamps, dtype=np.int64).tobytes())
        flags |= FLAG_TIMESTAMPS
    payload = b"".join(parts)
    return payload, flags, zlib.crc32(payload)


def encode_interaction_frame(
    seqno: int,
    users: np.ndarray,
    items: np.ndarray,
    values: np.ndarray,
    user_prefix: bytes = b"u",
    item_prefix: bytes = b"i",
    timestamps: np.ndarray | None = None,
) -> bytes:
    payload, flags, crc = encode_interactions_payload(
        users, items, values, user_prefix, item_prefix, timestamps
    )
    return encode_frame(KIND_COLS, flags, seqno, len(values), payload, crc)


def columns_from_payload(payload, count: int, flags: int):
    """Decode a columnar payload into zero-copy array views:
    (users_i32, items_i32, values_f32, timestamps_i64|None,
    user_prefix, item_prefix). ``payload`` may be any buffer (bytes or a
    memoryview over shared memory); the views alias it."""
    buf = memoryview(payload)
    uplen, iplen, _ = struct.unpack_from("<BBH", buf, 0)
    user_prefix = bytes(buf[4 : 4 + uplen])
    item_prefix = bytes(buf[4 + uplen : 4 + uplen + iplen])
    off = pad8(4 + uplen + iplen)
    users = np.frombuffer(buf, dtype=np.int32, count=count, offset=off)
    off += 4 * count
    items = np.frombuffer(buf, dtype=np.int32, count=count, offset=off)
    off += 4 * count
    values = np.frombuffer(buf, dtype=np.float32, count=count, offset=off)
    off += 4 * count
    timestamps = None
    if flags & FLAG_TIMESTAMPS:
        timestamps = np.frombuffer(buf, dtype=np.int64, count=count, offset=off)
    return users, items, values, timestamps, user_prefix, item_prefix


# ---------------------------------------------------------------------------
# HTTP request records (KIND_HTTP): the native front's micro-batch unit
# ---------------------------------------------------------------------------

# per-record fixed header inside a KIND_HTTP payload:
#   u32 conn_id, u32 req_id, u8 method, u8 flags, u16 n_headers,
#   u32 target_len, u32 body_len, u32 rec_len (8-aligned total)
_HTTP_REC = struct.Struct("<IIBBHIII")
_HTTP_METHODS = ("GET", "POST", "DELETE", "HEAD", "OTHER")
HTTP_FLAG_HTTP10 = 1
HTTP_FLAG_CLOSE = 2


class HttpRecord:
    """One pre-parsed request from the native front. ``headers`` keeps
    the client's original name casing and order; consumers that need
    case-insensitive lookup wrap it (serving.native_front._Headers)."""

    __slots__ = ("conn_id", "req_id", "method", "flags", "target",
                 "headers", "body")

    def __init__(self, conn_id, req_id, method, flags, target, headers,
                 body) -> None:
        self.conn_id = conn_id
        self.req_id = req_id
        self.method = method
        self.flags = flags
        self.target = target
        self.headers = headers
        self.body = body


def decode_http_records(payload, count: int) -> list[HttpRecord]:
    """Decode a KIND_HTTP payload into its request records."""
    buf = memoryview(payload)
    out: list[HttpRecord] = []
    pos = 0
    for _ in range(count):
        if pos + _HTTP_REC.size > len(buf):
            raise FrameError("truncated http record header")
        (conn_id, req_id, method, flags, n_headers, target_len, body_len,
         rec_len) = _HTTP_REC.unpack_from(buf, pos)
        if pos + rec_len > len(buf) or rec_len < _HTTP_REC.size:
            raise FrameError(f"http record length {rec_len} overruns payload")
        off = pos + _HTTP_REC.size
        target = bytes(buf[off : off + target_len]).decode("latin-1")
        off += target_len
        headers: list[tuple[str, str]] = []
        for _h in range(n_headers):
            klen, vlen = struct.unpack_from("<HH", buf, off)
            off += 4
            k = bytes(buf[off : off + klen]).decode("latin-1")
            off += klen
            v = bytes(buf[off : off + vlen]).decode("latin-1")
            off += vlen
            headers.append((k, v))
        body = bytes(buf[off : off + body_len])
        out.append(
            HttpRecord(
                conn_id,
                req_id,
                _HTTP_METHODS[method] if method < 5 else "OTHER",
                flags,
                target,
                headers,
                body,
            )
        )
        pos += rec_len
    return out


class Frame:
    """A decoded frame: header fields + a payload view (NOT a copy —
    valid only as long as the underlying transport buffer is)."""

    __slots__ = ("kind", "flags", "seqno", "count", "length", "payload")

    def __init__(self, kind, flags, seqno, count, length, payload) -> None:
        self.kind = kind
        self.flags = flags
        self.seqno = seqno
        self.count = count
        self.length = length
        self.payload = payload

    def wire_bytes(self) -> int:
        return HEADER_BYTES + pad8(self.length)

    def text_lines(self) -> list[bytes]:
        lines = bytes(self.payload).split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        return lines

    def columns(self):
        return columns_from_payload(self.payload, self.count, self.flags)


def decode_frame(buf, pos: int = 0, check_crc: bool = True) -> Frame:
    """Parse the frame at ``buf[pos:]``. Raises FrameError on bad magic or
    an insane length, FrameCrcError when the payload fails its CRC (the
    torn/corrupted-block signal: the caller skips the frame and resyncs).
    """
    view = memoryview(buf)
    if pos + HEADER_BYTES > len(view):
        raise FrameError("truncated frame header")
    magic, kind, flags, seqno, count, length, crc = HEADER.unpack_from(view, pos)
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic:#x} at {pos}")
    if pos + HEADER_BYTES + length > len(view):
        raise FrameError(f"frame length {length} overruns buffer at {pos}")
    payload = view[pos + HEADER_BYTES : pos + HEADER_BYTES + length]
    if check_crc and kind != KIND_PAD and zlib.crc32(payload) != crc:
        raise FrameCrcError(f"frame CRC mismatch at {pos} (seqno {seqno})")
    return Frame(kind, flags, seqno, count, length, payload)
