"""Columnar record collections for the batch data path.

The reference's batch layer hands Spark RDDs of (key, message) pairs to
the update (BatchUpdateFunction.java:103-130): distributed, lazy, and
re-iterable. The TPU-native equivalent is a :class:`Records` collection —
re-iterable as ``KeyMessage`` objects for generic apps, and exposing
``blocks()`` of numpy byte-string columns so numeric apps (ALS) can parse
and aggregate whole micro-batches with vectorized numpy instead of a
Python loop per line. Nothing is materialized as one giant Python list:
``FileRecords`` streams one stored micro-batch file at a time, which is
what keeps a 100M-rating train within host RAM.

Messages travel as numpy ``S``-dtype (UTF-8 bytes) arrays: fixed-width,
contiguous, and directly consumable by the vectorized CSV parser in
app/als/data.py.

Port note: a copy of ``oryx_tpu/common/records.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np

from oryx_tpu_torch.bus.core import KeyMessage


class RecordBlock:
    """One columnar chunk: parallel key/message byte-string arrays.

    S arrays cannot hold None, so None keys travel as an explicit boolean
    mask — ``key=""`` and ``key=None`` survive a storage round-trip as
    distinct values, like the reference's nullable Text keys. (One
    S-dtype caveat: numpy strips *trailing* NUL bytes, so keys/messages
    ending in "\\x00" are not representable columnar.)
    """

    __slots__ = ("keys", "messages", "none_keys", "trace")

    def __init__(
        self,
        keys: np.ndarray | None,
        messages: np.ndarray,
        none_keys: np.ndarray | None = None,
    ) -> None:
        self.keys = keys  # S-dtype array, or None when every key is None
        self.messages = messages  # S-dtype array
        self.none_keys = none_keys  # bool array (True = key is None), or None
        # raw "@trc" control-record message (str) stripped by the
        # transport, or None; parse with common.tracing.parse_header
        self.trace = None

    def __len__(self) -> int:
        return len(self.messages)

    def iter_key_messages(self) -> Iterator[KeyMessage]:
        msgs = self.messages.tolist()  # list[bytes], C-level
        if self.keys is None:
            for m in msgs:
                yield KeyMessage(None, m.decode("utf-8", "replace"))
        else:
            nones = (
                self.none_keys.tolist()
                if self.none_keys is not None
                else [False] * len(msgs)
            )
            for k, m, is_none in zip(self.keys.tolist(), msgs, nones):
                yield KeyMessage(
                    None if is_none else k.decode("utf-8", "replace"),
                    m.decode("utf-8", "replace"),
                )

    @staticmethod
    def from_key_messages(records: Sequence[KeyMessage]) -> "RecordBlock":
        msgs = np.array([r.message.encode("utf-8") for r in records], dtype="S")
        if any(r.key is not None for r in records):
            keys = np.array(
                [(r.key or "").encode("utf-8") for r in records], dtype="S"
            )
            none_keys = np.array([r.key is None for r in records], dtype=bool)
            return RecordBlock(keys, msgs, none_keys if none_keys.any() else None)
        return RecordBlock(None, msgs)


class InteractionBlock:
    """A typed columnar chunk of rating events: int32 id codes + f32
    values, straight off a binary bus frame (bus/blockcodec.py kind=2).

    Quacks like a None-keyed :class:`RecordBlock` (``keys``/``messages``/
    ``none_keys``/``len``/``iter_key_messages``) so generic consumers and
    the dead-letter path keep working, but parse-aware consumers (the ALS
    speed manager) read ``users``/``items``/``values`` directly — the
    decode stage becomes array views instead of text splitting. The
    arrays may be zero-copy views over transport memory: they are valid
    until the consumer's next poll (or release()), the same lifetime
    contract GuardedBlockFeed already enforces for update blocks.
    """

    __slots__ = ("users", "items", "values", "timestamps",
                 "user_prefix", "item_prefix", "_messages", "trace")

    keys = None  # input events are None-keyed, like the text path
    none_keys = None

    def __init__(
        self,
        users: np.ndarray,
        items: np.ndarray,
        values: np.ndarray,
        timestamps: np.ndarray | None = None,
        user_prefix: bytes = b"u",
        item_prefix: bytes = b"i",
    ) -> None:
        self.users = users  # int32 id codes
        self.items = items  # int32 id codes
        self.values = values  # float32
        self.timestamps = timestamps  # int64 ms, or None
        self.user_prefix = user_prefix
        self.item_prefix = item_prefix
        self._messages = None
        self.trace = None  # raw "@trc" message carried by the transport

    def __len__(self) -> int:
        return len(self.values)

    def materialize(self) -> "InteractionBlock":
        """Copy the columns out of transport memory (for holders that
        outlive the poll window, e.g. a chaos-dup stash)."""
        out = InteractionBlock(
            np.array(self.users), np.array(self.items), np.array(self.values),
            None if self.timestamps is None else np.array(self.timestamps),
            self.user_prefix, self.item_prefix,
        )
        out.trace = self.trace
        return out

    @property
    def messages(self) -> np.ndarray:
        """Text rendering ``<up><user>,<ip><item>,<value>[,<ts>]`` as an
        S-array — the compatibility path (generic managers, dead-letter
        replay); parse-aware consumers never touch it. ``%.9g`` prints
        enough digits to round-trip any float32 exactly."""
        if self._messages is None:
            up = self.user_prefix.decode("ascii", "replace")
            ip = self.item_prefix.decode("ascii", "replace")
            us, its = self.users.tolist(), self.items.tolist()
            vs = self.values.tolist()
            if self.timestamps is not None:
                ts = self.timestamps.tolist()
                lines = [
                    f"{up}{u},{ip}{i},{v:.9g},{t}".encode()
                    for u, i, v, t in zip(us, its, vs, ts)
                ]
            else:
                lines = [
                    f"{up}{u},{ip}{i},{v:.9g}".encode()
                    for u, i, v in zip(us, its, vs)
                ]
            self._messages = np.array(lines, dtype="S") if lines else np.empty(0, "S1")
        return self._messages

    def iter_key_messages(self) -> Iterator[KeyMessage]:
        for m in self.messages.tolist():
            yield KeyMessage(None, m.decode("utf-8", "replace"))


class Records:
    """Re-iterable collection of records; base contract for the batch
    update's ``new_data``/``past_data`` arguments."""

    def blocks(self) -> Iterator[RecordBlock]:
        raise NotImplementedError

    def is_empty(self) -> bool:
        return next(iter(self.blocks()), None) is None

    def __iter__(self) -> Iterator[KeyMessage]:
        for block in self.blocks():
            yield from block.iter_key_messages()


class ListRecords(Records):
    """An in-memory list of KeyMessages (the drained input micro-batch)."""

    def __init__(self, records: list[KeyMessage]) -> None:
        self._records = records

    def blocks(self) -> Iterator[RecordBlock]:
        if self._records:
            yield RecordBlock.from_key_messages(self._records)

    def is_empty(self) -> bool:
        return not self._records

    def __iter__(self) -> Iterator[KeyMessage]:
        return iter(self._records)

    def __len__(self) -> int:
        return len(self._records)


class BlockRecords(Records):
    """A materialized list of columnar blocks (e.g. drained poll_block
    batches)."""

    def __init__(self, blocks: Sequence[RecordBlock]) -> None:
        self._blocks = list(blocks)

    def blocks(self) -> Iterator[RecordBlock]:
        return iter(self._blocks)

    def is_empty(self) -> bool:
        return not any(len(b) for b in self._blocks)

    def __len__(self) -> int:
        return sum(len(b) for b in self._blocks)


class ChainRecords(Records):
    """Concatenation of collections, kept lazy (past + new train data)."""

    def __init__(self, parts: Sequence[Records]) -> None:
        self._parts = list(parts)

    def blocks(self) -> Iterator[RecordBlock]:
        for part in self._parts:
            yield from part.blocks()

    def is_empty(self) -> bool:
        return all(p.is_empty() for p in self._parts)


def as_records(data: Iterable[KeyMessage]) -> Records:
    if isinstance(data, Records):
        return data
    return ListRecords(list(data))
