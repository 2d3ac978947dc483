"""ALS input parsing and aggregation.

Rebuild of the data-prep stages of ALSUpdate (app/oryx-app-mllib/.../als/
ALSUpdate.java): input lines are ``user,item,value[,timestamp]`` (CSV or
JSON array; empty value = delete, parsed as NaN, ALSUpdate.java:260-278);
time-decay multiplies old strengths by factor^days (decayRating:292-298)
then prunes below the zero threshold; aggregation combines repeated
(user,item) pairs — implicit: sum with NaN poisoning (delete wins over
the aggregate, MLFunctions.SUM_WITH_NAN), explicit: last value in
timestamp order wins (aggregateScores:332-352) — and NaN aggregates are
dropped (deletes).

Port note: a copy of ``oryx_tpu/app/als/data.py`` (numpy only) with its
imports pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Iterable, NamedTuple

import numpy as np

from oryx_tpu_torch.bus.core import KeyMessage
from oryx_tpu_torch.common.text import parse_line


class Interaction(NamedTuple):
    user: str
    item: str
    value: float  # NaN = delete marker
    timestamp_ms: int


_nan = math.nan


def parse_interactions(data: Iterable[KeyMessage | str]) -> list[Interaction]:
    """Parse lines, in input order. Lines missing a timestamp get 0 so
    pure-CSV triples still work in time-ordered contexts. Plain unquoted
    CSV (the wire-format fast path at 100k-event micro-batches) parses
    with a bare split; quoted CSV and JSON arrays go through parse_line."""
    out: list[Interaction] = []
    append = out.append
    for rec in data:
        line = rec if type(rec) is str else rec.message
        s = line.strip()
        if s and s[0] not in "[{" and '"' not in s:
            tokens = s.split(",")
        else:
            tokens = parse_line(s)
        if len(tokens) < 3:
            raise ValueError(f"bad ALS input: {line!r}")
        value = _nan if tokens[2] == "" else float(tokens[2])
        ts = int(float(tokens[3])) if len(tokens) > 3 and tokens[3] != "" else 0
        append(Interaction(tokens[0], tokens[1], value, ts))
    return out


def decay_interactions(
    interactions: list[Interaction],
    factor: float,
    zero_threshold: float,
    now_ms: int | None = None,
) -> list[Interaction]:
    if factor < 1.0:
        now = int(time.time() * 1000) if now_ms is None else now_ms
        decayed = []
        for it in interactions:
            if it.timestamp_ms >= now or math.isnan(it.value):
                decayed.append(it)
            else:
                days = (now - it.timestamp_ms) / 86_400_000.0
                decayed.append(
                    Interaction(it.user, it.item, it.value * factor**days, it.timestamp_ms)
                )
        interactions = decayed
    if zero_threshold > 0.0:
        interactions = [
            it for it in interactions if math.isnan(it.value) or it.value > zero_threshold
        ]
    return interactions


def aggregate(interactions: list[Interaction], implicit: bool) -> dict[tuple[str, str], float]:
    """Combine repeated (user,item) pairs; drop NaN aggregates (deletes)."""
    interactions = sorted(interactions, key=lambda it: it.timestamp_ms)
    agg: dict[tuple[str, str], float] = {}
    for it in interactions:
        key = (it.user, it.item)
        if implicit:
            prev = agg.get(key)
            # NaN anywhere poisons the sum => delete
            agg[key] = it.value if prev is None else prev + it.value
        else:
            agg[key] = it.value  # last wins
    return {k: v for k, v in agg.items() if not math.isnan(v)}


@dataclass
class RatingMatrix:
    """Indexed COO ready for the trainer."""

    user_ids: list[str]
    item_ids: list[str]
    user_idx: np.ndarray  # int32
    item_idx: np.ndarray  # int32
    values: np.ndarray  # float32

    @property
    def known_items(self) -> dict[str, set[str]]:
        """user -> item-id set, grouped with one argsort instead of a
        Python dict op per interaction."""
        if not len(self.user_idx):
            return {}
        order = np.argsort(self.user_idx, kind="stable")
        u_sorted = self.user_idx[order]
        bounds = np.flatnonzero(np.diff(u_sorted)) + 1
        groups = np.split(self.item_idx[order], bounds)
        firsts = u_sorted[np.concatenate(([0], bounds))]
        item_ids = self.item_ids
        return {
            self.user_ids[u]: {item_ids[j] for j in g.tolist()}
            for u, g in zip(firsts.tolist(), groups)
        }


def to_rating_matrix(agg: dict[tuple[str, str], float]) -> RatingMatrix:
    user_ids = sorted({u for u, _ in agg})
    item_ids = sorted({i for _, i in agg})
    u_index = {u: n for n, u in enumerate(user_ids)}
    i_index = {i: n for n, i in enumerate(item_ids)}
    n = len(agg)
    uu = np.empty(n, dtype=np.int32)
    ii = np.empty(n, dtype=np.int32)
    vv = np.empty(n, dtype=np.float32)
    for pos, ((u, i), v) in enumerate(agg.items()):
        uu[pos] = u_index[u]
        ii[pos] = i_index[i]
        vv[pos] = v
    return RatingMatrix(user_ids, item_ids, uu, ii, vv)


# ---------------------------------------------------------------------------
# Columnar (vectorized) pipeline
#
# The per-line functions above are the micro-batch path (speed layer, small
# generations). The batch trainer goes through these instead: whole blocks
# of input lines parse, decay, and aggregate as numpy array operations —
# the single-host stand-in for the reference's distributed RDD pipeline
# (BatchUpdateFunction.java:103-130 + MLFunctions aggregation), and the
# difference between minutes of Python parse and seconds of numpy at
# 100M-rating scale.
# ---------------------------------------------------------------------------


class InteractionColumns(NamedTuple):
    """Parallel arrays of interactions (bytes ids; NaN value = delete)."""

    users: np.ndarray  # S-dtype
    items: np.ndarray  # S-dtype
    values: np.ndarray  # float32
    timestamps: np.ndarray  # int64 ms


_EMPTY_COLUMNS = InteractionColumns(
    np.empty(0, "S1"), np.empty(0, "S1"), np.empty(0, np.float32), np.empty(0, np.int64)
)


def _extract_bytes(arr: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Vectorized variable-width substring gather: bytes arr[s:e) per row,
    returned as a fixed-width S array (NUL-padded)."""
    n = len(starts)
    if n == 0:
        return np.empty(0, dtype="S1")
    w = max(1, int(np.max(ends - starts)))
    idx = starts[:, None] + np.arange(w, dtype=np.int64)[None, :]
    mask = idx < ends[:, None]
    flat = np.where(mask, arr[np.minimum(idx, arr.size - 1)], 0).astype(np.uint8)
    return np.ascontiguousarray(flat).view(f"S{w}").ravel()


def parse_interaction_block(messages: np.ndarray | list[bytes]) -> InteractionColumns:
    """Vectorized parse of ``user,item,value[,timestamp]`` lines.

    `messages` is an S-dtype array (or list of bytes) of input lines. The
    whole block is parsed with numpy index arithmetic on one byte blob —
    no Python loop per line. Lines with quotes or JSON arrays fall back to
    the per-line parser (they cannot contain bare delimiter commas).
    """
    if isinstance(messages, np.ndarray):
        lines = messages.tolist()
    else:
        lines = list(messages)
    if not lines:
        return _EMPTY_COLUMNS
    blob = b"\n".join(lines) + b"\n"
    arr = np.frombuffer(blob, dtype=np.uint8)
    ends = np.flatnonzero(arr == 0x0A)
    if len(ends) != len(lines) or np.any(arr == 0x22):  # embedded \n or quote
        return _parse_block_slow(lines)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    first = arr[np.minimum(starts, arr.size - 1)]
    if np.any((first == 0x5B) | (first == 0x7B)):  # [ or { => JSON lines
        return _parse_block_slow(lines)
    commas = np.flatnonzero(arr == 0x2C)
    c_lo = np.searchsorted(commas, starts)
    c_hi = np.searchsorted(commas, ends)
    counts = c_hi - c_lo
    if np.any(counts < 2):
        bad = int(np.argmax(counts < 2))
        raise ValueError(f"bad ALS input: {lines[bad]!r}")
    c1 = commas[c_lo]
    c2 = commas[c_lo + 1]
    has_ts = counts >= 3
    c3 = np.where(has_ts, commas[np.minimum(c_lo + 2, len(commas) - 1)], ends)
    users = _extract_bytes(arr, starts, c1)
    items = _extract_bytes(arr, c1 + 1, c2)
    vf = _extract_bytes(arr, c2 + 1, c3)
    empty_v = c3 == c2 + 1
    if empty_v.any():
        vf = vf.astype(f"S{max(3, vf.dtype.itemsize)}")
        vf[empty_v] = b"nan"  # empty value = delete marker
    try:
        values = vf.astype(np.float64).astype(np.float32)
    except ValueError:
        return _parse_block_slow(lines)  # oddball numerics: per-line errors
    if has_ts.any():
        tf = _extract_bytes(arr, np.where(has_ts, c3 + 1, ends), ends)
        empty_t = ~has_ts | (ends == c3 + 1)
        if empty_t.any():
            tf = tf.astype(f"S{max(1, tf.dtype.itemsize)}")
            tf[empty_t] = b"0"
        try:
            timestamps = tf.astype(np.float64).astype(np.int64)
        except ValueError:
            return _parse_block_slow(lines)
    else:
        timestamps = np.zeros(len(lines), dtype=np.int64)
    return InteractionColumns(users, items, values, timestamps)


def _parse_block_slow(lines: list[bytes]) -> InteractionColumns:
    """Per-line fallback (quoted CSV / JSON arrays) via parse_interactions."""
    inter = parse_interactions([ln.decode("utf-8", "replace") for ln in lines])
    return InteractionColumns(
        np.array([it.user.encode("utf-8") for it in inter], dtype="S"),
        np.array([it.item.encode("utf-8") for it in inter], dtype="S"),
        np.array([it.value for it in inter], dtype=np.float32),
        np.array([it.timestamp_ms for it in inter], dtype=np.int64),
    )


def concat_columns(parts: list[InteractionColumns]) -> InteractionColumns:
    parts = [p for p in parts if len(p.values)]
    if not parts:
        return _EMPTY_COLUMNS
    if len(parts) == 1:
        return parts[0]
    return InteractionColumns(
        np.concatenate([p.users for p in parts]),
        np.concatenate([p.items for p in parts]),
        np.concatenate([p.values for p in parts]),
        np.concatenate([p.timestamps for p in parts]),
    )


def decay_columns(
    cols: InteractionColumns,
    factor: float,
    zero_threshold: float,
    now_ms: int | None = None,
) -> InteractionColumns:
    """Vectorized twin of decay_interactions."""
    users, items, values, ts = cols
    if factor < 1.0 and len(values):
        now = int(time.time() * 1000) if now_ms is None else now_ms
        old = (ts < now) & ~np.isnan(values)
        if old.any():
            days = (now - ts[old]).astype(np.float64) / 86_400_000.0
            values = values.copy()
            values[old] = (values[old].astype(np.float64) * factor**days).astype(
                np.float32
            )
    if zero_threshold > 0.0 and len(values):
        keep = np.isnan(values) | (values > zero_threshold)
        if not keep.all():
            users, items, values, ts = users[keep], items[keep], values[keep], ts[keep]
    return InteractionColumns(users, items, values, ts)


def _aggregate_indexed(uinv, n_items, iinv, values, ts, implicit):
    """The shared aggregate core: pair (user,item) codes, combine repeated
    pairs (implicit: float64 sum with NaN poisoning; explicit: last in
    (timestamp, arrival) order wins), drop NaN aggregates (deletes).
    Returns (surviving user codes, item codes, aggregated values)."""
    n = len(values)
    pair = uinv.astype(np.int64) * n_items + iinv.astype(np.int64)
    pq, pinv = np.unique(pair, return_inverse=True)
    if implicit:
        agg = np.bincount(pinv, weights=values.astype(np.float64), minlength=len(pq))
        agg = agg.astype(np.float32)
    else:
        # group by pair, ordered by (timestamp, arrival); last of each wins
        order = np.lexsort((np.arange(n), ts, pinv))
        sp = pinv[order]
        last = np.empty(len(sp), dtype=bool)
        last[:-1] = sp[:-1] != sp[1:]
        last[-1] = True
        agg = values[order][last]
    keep = ~np.isnan(agg)
    pq, agg = pq[keep], agg[keep]
    return pq // n_items, pq % n_items, agg


def rating_matrix_from_columns(cols: InteractionColumns, implicit: bool) -> RatingMatrix:
    """Vectorized aggregate + index: same semantics as
    ``to_rating_matrix(aggregate(...))`` — implicit sums with NaN
    poisoning, explicit last-in-timestamp-order wins, NaN aggregates
    (deletes) dropped, vocab built from surviving pairs only."""
    users, items, values, ts = cols
    n = len(values)
    if n == 0:
        return RatingMatrix([], [], np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.float32))
    uq, uinv = np.unique(users, return_inverse=True)
    iq, iinv = np.unique(items, return_inverse=True)
    uu_codes, ii_codes, agg = _aggregate_indexed(uinv, len(iq), iinv, values, ts, implicit)
    u_used, uu = np.unique(uu_codes, return_inverse=True)
    i_used, ii = np.unique(ii_codes, return_inverse=True)
    user_ids = [b.decode("utf-8", "replace") for b in uq[u_used].tolist()]
    item_ids = [b.decode("utf-8", "replace") for b in iq[i_used].tolist()]
    return RatingMatrix(
        user_ids,
        item_ids,
        uu.astype(np.int32),
        ii.astype(np.int32),
        agg.astype(np.float32),
    )


def rating_matrix_from_int_columns(
    users: np.ndarray,
    items: np.ndarray,
    values: np.ndarray,
    timestamps: np.ndarray | None,
    implicit: bool,
    user_prefix: bytes = b"u",
    item_prefix: bytes = b"i",
) -> RatingMatrix:
    """Typed-transport twin of :func:`rating_matrix_from_columns`: int32 id
    codes straight off a columnar bus frame, aggregated by the SAME core.
    The S-id path would render "u%d"/"i%d" strings for every event and
    then parse them back; here strings are materialized ONLY for the ids
    that survive aggregation (one np.char.mod over the used vocab), so the
    per-event cost is pure integer arithmetic. Vocab order is numeric
    rather than lexicographic — RatingMatrix consumers index through
    user_ids/item_ids, so ordering is internal only."""
    n = len(values)
    if n == 0:
        return RatingMatrix([], [], np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.float32))
    values = np.asarray(values, dtype=np.float32)
    ts = (
        np.zeros(n, dtype=np.int64)
        if timestamps is None
        else np.asarray(timestamps, dtype=np.int64)
    )
    uq, uinv = np.unique(np.asarray(users), return_inverse=True)
    iq, iinv = np.unique(np.asarray(items), return_inverse=True)
    uu_codes, ii_codes, agg = _aggregate_indexed(uinv, len(iq), iinv, values, ts, implicit)
    u_used, uu = np.unique(uu_codes, return_inverse=True)
    i_used, ii = np.unique(ii_codes, return_inverse=True)
    up = user_prefix.decode("ascii", "replace")
    ip = item_prefix.decode("ascii", "replace")
    user_ids = np.char.mod(up + "%d", uq[u_used]).tolist()
    item_ids = np.char.mod(ip + "%d", iq[i_used]).tolist()
    return RatingMatrix(
        user_ids,
        item_ids,
        uu.astype(np.int32),
        ii.astype(np.int32),
        agg.astype(np.float32),
    )
