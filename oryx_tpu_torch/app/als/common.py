"""Shared incremental-ALS state and math.

Rebuild of app/oryx-app-common .../als/FeatureVectors.java:36-161 (a
concurrent id -> float32-vector store with recent-ID tracking and
rotation reconciliation) and ALSUtils.java:24-108 (the fold-in update:
how a user vector changes in response to one new interaction, used on the
speed- and serving-layer hot paths).

IDs are strings end to end. (The reference hashes string IDs to int32
because Spark MLlib requires int IDs, ALSUpdate.java:305-326; the JAX
trainer indexes rows directly so no lossy hash is needed.)

Port note: a copy of ``oryx_tpu/app/als/common.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``. UP payloads parse with numpy: the native
parser (``oryx_tpu/native``) is not ported yet.
"""

from __future__ import annotations

import math
import re
from typing import Callable

import numpy as np

from oryx_tpu_torch.common.lang import ReadWriteLock
from oryx_tpu_torch.common.vectormath import Solver


class FeatureVectors:
    """Concurrent ID -> float32 vector store (FeatureVectors.java)."""

    def __init__(self) -> None:
        self._lock = ReadWriteLock()
        self._vectors: dict[str, np.ndarray] = {}
        self._recent_ids: set[str] = set()

    def size(self) -> int:
        with self._lock.read():
            return len(self._vectors)

    def get_vector(self, id_: str) -> np.ndarray | None:
        with self._lock.read():
            return self._vectors.get(id_)

    def set_vector(self, id_: str, vector: np.ndarray) -> None:
        vector = np.asarray(vector, dtype=np.float32)
        with self._lock.write():
            self._vectors[id_] = vector
            self._recent_ids.add(id_)

    def set_batch(self, ids: list[str], vectors: np.ndarray) -> None:
        """Insert/update many vectors under one write lock."""
        vectors = np.asarray(vectors, dtype=np.float32)
        with self._lock.write():
            for id_, vec in zip(ids, vectors):
                # copy: a row view would pin the whole batch matrix alive
                # for as long as any single id keeps its vector
                self._vectors[id_] = np.array(vec)
            self._recent_ids.update(ids)

    def get_batch(
        self, ids: list[str], dim: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectors for many ids: ([n, dim] float32 with zero rows for
        misses, [n] bool valid). Interface parity with the native store.
        ``dim`` keeps the matrix shape well-formed when the store is empty
        (e.g. right after a rotation removed every vector)."""
        n = len(ids)
        with self._lock.read():
            for v in self._vectors.values():
                dim = len(v)
                break
            dim = dim or 0
            mat = np.zeros((n, dim), dtype=np.float32)
            valid = np.zeros(n, dtype=bool)
            for j, id_ in enumerate(ids):
                v = self._vectors.get(id_)
                if v is not None:
                    mat[j], valid[j] = v, True
        return mat, valid

    def remove_vector(self, id_: str) -> None:
        with self._lock.write():
            self._vectors.pop(id_, None)
            self._recent_ids.discard(id_)

    def add_all_ids_to(self, out: set[str]) -> None:
        with self._lock.read():
            out.update(self._vectors.keys())

    def add_all_recent_to(self, out: set[str]) -> None:
        with self._lock.read():
            out.update(self._recent_ids)

    def retain_recent_and_ids(self, new_model_ids: set[str]) -> None:
        """On model rotation keep only ids in the new model OR written
        since the last rotation, then reset recency
        (FeatureVectors.retainRecentAndIDs:131-136 — this is what makes
        'recent writes survive model swap' true)."""
        with self._lock.write():
            keep = self._recent_ids | new_model_ids
            for id_ in [i for i in self._vectors if i not in keep]:
                del self._vectors[id_]
            self._recent_ids.clear()

    def items(self) -> list[tuple[str, np.ndarray]]:
        with self._lock.read():
            return list(self._vectors.items())

    def ids(self) -> list[str]:
        with self._lock.read():
            return list(self._vectors.keys())

    def for_each(self, fn: Callable[[str, np.ndarray], None]) -> None:
        for id_, v in self.items():
            fn(id_, v)

    def get_vtv(self) -> np.ndarray | None:
        """V^T V over all vectors (FeatureVectors.getVTV:150-154)."""
        with self._lock.read():
            if not self._vectors:
                return None
            m = np.stack(list(self._vectors.values())).astype(np.float64)
        return m.T @ m

    def to_matrix(self) -> tuple[list[str], np.ndarray]:
        """Packed (ids, [n, k] float32 matrix) snapshot, for device upload."""
        with self._lock.read():
            if not self._vectors:
                return [], np.zeros((0, 0), dtype=np.float32)
            ids = list(self._vectors.keys())
            mat = np.stack([self._vectors[i] for i in ids])
        return ids, mat


# -- fold-in math (ALSUtils) -------------------------------------------------


def compute_target_qui(implicit: bool, value: float, current_value: float) -> float:
    """Target estimated interaction strength after a new interaction of
    the given value, or NaN for "no change" (ALSUtils.computeTargetQui:
    37-59). Implicit targets move part of the way from the current
    estimate toward 1 (positive value) or 0 (negative), proportionally to
    the interaction strength; explicit targets are the value itself."""
    if not implicit:
        return value
    if value > 0.0 and current_value < 1.0:
        diff = 1.0 - max(0.0, current_value)
        return current_value + (value / (1.0 + value)) * diff
    if value < 0.0 and current_value > 0.0:
        diff = -min(1.0, current_value)
        return current_value + (value / (value - 1.0)) * diff
    return math.nan


def compute_updated_xu(
    solver: Solver,
    value: float,
    xu: np.ndarray | None,
    yi: np.ndarray | None,
    implicit: bool,
) -> np.ndarray | None:
    """New user vector after one (user, item, value) interaction, or None
    when no update applies (ALSUtils.computeUpdatedXu:74-106). Also used
    with roles swapped to update item vectors. Solves
    dXu = (YtY)^-1 (dQui * Yi) and adds it to Xu."""
    if yi is None:
        return None
    yi = np.asarray(yi, dtype=np.float32)
    qui = 0.0 if xu is None else float(np.dot(np.asarray(xu, dtype=np.float64), yi))
    # 0.5 reflects a "don't know" prior for a brand-new user
    target_qui = compute_target_qui(implicit, value, 0.5 if xu is None else qui)
    if math.isnan(target_qui):
        return None
    d_qui = target_qui - qui
    d_xu = solver.solve_f_to_f(d_qui * yi)
    if xu is None:
        return d_xu
    return np.asarray(xu, dtype=np.float32) + d_xu


# ---------------------------------------------------------------------------
# Columnar UP-message consumption (shared by the speed and serving managers)
# ---------------------------------------------------------------------------


def consume_blocks_columnar(block_iterator, model_ready, apply_up_batch, consume):
    """Columnar consume loop: contiguous runs of "UP" records hand off to
    ``apply_up_batch`` as raw byte lines; everything else — MODEL/
    MODEL-REF, blocks with no key column, records before a model exists —
    falls back to the per-record ``consume`` in order."""
    from oryx_tpu_torch.bus.core import KeyMessage

    for block in block_iterator:
        if not model_ready() or block.keys is None:
            consume(block.iter_key_messages())
            continue
        keys = block.keys.tolist()
        msgs = block.messages.tolist()
        n = len(msgs)
        i = 0
        while i < n:
            if keys[i] == b"UP":
                j = i
                while j < n and keys[j] == b"UP":
                    j += 1
                apply_up_batch(msgs[i:j])
                i = j
            else:
                consume(iter([KeyMessage(
                    keys[i].decode("utf-8", "replace"),
                    msgs[i].decode("utf-8", "replace"),
                )]))
                i += 1


# the separator of two ids in a known-items list: '","' or json.dumps's '", "'
_KNOWN_SEPARATOR = re.compile(rb'"\s*,\s*"')


def apply_up_lines(
    lines: list,
    k: int,
    set_x: Callable,
    set_y: Callable,
    slow_consume: Callable,
    on_known: Callable | None = None,
    strict_tail: bool = False,
) -> int:
    """Batched fast path for a run of raw "UP" byte lines.

    Groups ``["X","id",[floats]...`` / ``["Y",...`` lines, parses every
    float component in one numpy pass, and
    applies each group via one batched setter call. Records the fast
    parser can't take — escaped ids, malformed lines, (with
    ``strict_tail``) unrecognized trailing elements — are handed to
    ``slow_consume`` ONE AT A TIME, and pending groups flush first: a
    later fast update for the same id must not be overwritten by
    replaying this older record after it.

    ``on_known(pairs)`` receives the X-side (id, known-ids-list) pairs of
    each flushed group when given; it implies strict tail validation for
    X records (the known list is part of the wire contract there).
    Returns rows applied via the fast path (slow-path records are the
    caller's consume's to count)."""
    from oryx_tpu_torch.bus.core import KeyMessage

    parse_known = on_known is not None
    strict = strict_tail or parse_known

    def fresh():
        return {
            b'["X","': ([], [], [], [], set_x),
            b'["Y","': ([], [], [], [], set_y),
        }

    groups = fresh()
    applied = 0

    def flush() -> None:
        nonlocal groups, applied
        for which, (ids, vecs, origs, knowns, setter) in groups.items():
            if not ids:
                continue
            parts = b",".join(vecs).split(b",")
            flat = None
            if len(parts) == len(ids) * k:
                try:
                    flat = np.array(parts, dtype="S").astype(np.float32)
                except ValueError:
                    flat = None
            if flat is None:
                # oddball numerics: whole group per-record, in order
                for ln in origs:
                    slow_consume(KeyMessage("UP", ln.decode("utf-8", "replace")))
                continue
            setter(ids, flat.reshape(len(ids), k))
            applied += len(ids)
            if which == b'["X","' and parse_known:
                on_known([(u, kn) for u, kn in zip(ids, knowns) if kn])
        groups = fresh()

    for ln in lines:
        slow = False
        group = groups.get(ln[:6])
        known: list[str] | None = None
        at = end = -1
        # escaped ids defeat the byte-slicing parse. With a strict tail the
        # known list is parsed too, so a backslash ANYWHERE disqualifies;
        # otherwise the tail is ignored and only the id region matters
        # (known ids with JSON escapes must not collapse the fast path).
        if group is None or (strict and b"\\" in ln):
            slow = True
        else:
            at = ln.find(b'",[', 6)
            end = ln.find(b"]", at + 3) if at != -1 else -1
            if at == -1 or end == -1 or b"\\" in ln[:at]:
                slow = True
            elif strict:
                tail = ln[end + 1 :]
                if tail != b"]":
                    # optional known-ids list: ,["i1","i2"]] (X only)
                    if not (tail.startswith(b',[') and tail.endswith(b"]]")):
                        slow = True
                    else:
                        inner = tail[2:-2]
                        if inner == b"":
                            known = []
                        elif inner.startswith(b'"') and inner.endswith(b'"'):
                            # an unescaped quote can only close or open an
                            # id, so any '"' <space> ',' <space> '"' run
                            # separates two (json.dumps writes '", "')
                            parts = _KNOWN_SEPARATOR.split(inner[1:-1])
                            if any(b'"' in p for p in parts):
                                slow = True
                            else:
                                known = [p.decode("utf-8", "replace") for p in parts]
                        else:
                            slow = True
        if slow:
            flush()
            slow_consume(KeyMessage("UP", ln.decode("utf-8", "replace")))
            continue
        group[0].append(ln[6:at].decode("utf-8", "replace"))
        group[1].append(ln[at + 3 : end])
        group[2].append(ln)
        group[3].append(known)
    flush()
    return applied
