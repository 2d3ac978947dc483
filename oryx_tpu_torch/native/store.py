"""ctypes wrappers for ``feature_store.cpp`` (counterpart of
``oryx_tpu/native/store.py``): the concurrent feature-vector store, the
update-message formatters and the tiered cell store.

``NativeFeatureVectors`` is API-compatible with the pure-Python
``FeatureVectors`` (``oryx_tpu_torch.app.als.common``): the same method
surface and rotation semantics (FeatureVectors.java:36-161). It fixes
the vector dimension on first write; ctypes releases the GIL for every
call, so readers and writers on different shards run in parallel.
``make_feature_vectors`` returns it where the native library builds.

The formatters write vectors as ``%.9g`` text (every float32 reads back
exactly) in one thread-parallel native call; ``parse_float_csv`` reads
UP payload floats with ``strtof``. Where the library is absent (``g++``
failed, or ``ORYX_NATIVE=0``) the Python paths stay, as in the JAX
package: ``make_feature_vectors`` gives the Python store,
``format_vectors_json`` writes ``json.dumps`` text (the same float32
values read back), and ``format_update_messages[_multi]`` and
``parse_float_csv`` return None, so the caller assembles or parses in
Python.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Callable, Iterable

import numpy as np

from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.native import get_library


def _decode_ids(buf: bytes) -> list[str]:
    """Parse the length-prefixed id stream ([u32 len][bytes]...)."""
    ids = []
    pos = 0
    end = len(buf)
    while pos + 4 <= end:
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        ids.append(buf[pos : pos + n].decode("utf-8"))
        pos += n
    return ids


def _offsets_payload(ids: list[str]) -> tuple[np.ndarray, bytes]:
    """Ids for the native ABI as (offsets[n+1] int64, concatenated utf-8
    payload): id i is payload[offsets[i]:offsets[i+1]]. Builds in a few
    vectorized passes — the length-prefix interleaving this replaces cost
    a Python loop with a struct.pack per id, which dominated the speed
    layer's serialization profile at 100k-event micro-batches."""
    n = len(ids)
    offs = np.zeros(n + 1, dtype=np.int64)
    if not n:
        return offs, b""
    # ascii fast path: one join + one encode for the whole batch; byte
    # lengths equal char lengths exactly when the encode didn't grow, so
    # a single length check validates the assumption (non-ascii ids fall
    # back to the per-id encode)
    np.cumsum(np.fromiter(map(len, ids), np.int64, count=n), out=offs[1:])
    payload = "".join(ids).encode("utf-8")
    if len(payload) == offs[n]:
        return offs, payload
    bs = [s.encode("utf-8") for s in ids]
    np.cumsum(np.fromiter(map(len, bs), np.int64, count=n), out=offs[1:])
    return offs, b"".join(bs)


def _offsets_ptr(offs: np.ndarray):
    return offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeFeatureVectors:
    """Drop-in FeatureVectors backed by the C++ store."""

    def __init__(self, num_shards: int = 16) -> None:
        self._lib = get_library()
        if self._lib is None:  # pragma: no cover - build always works in CI
            raise RuntimeError("native library unavailable")
        self._num_shards = num_shards
        self._ptr = None
        self._dim: int | None = None
        self._init_lock = threading.Lock()

    def __del__(self):  # pragma: no cover - interpreter teardown
        ptr, self._ptr = self._ptr, None
        if ptr and self._lib is not None:
            self._lib.fs_destroy(ptr)

    def _ensure(self, dim: int):
        with self._init_lock:
            if self._ptr is None:
                self._ptr = self._lib.fs_create(dim, self._num_shards)
                self._dim = dim
            elif dim != self._dim:
                raise ValueError(f"vector dim {dim} != store dim {self._dim}")
        return self._ptr

    # -- FeatureVectors API --------------------------------------------------

    def size(self) -> int:
        if self._ptr is None:
            return 0
        return int(self._lib.fs_size(self._ptr))

    def set_vector(self, id_: str, vector: np.ndarray) -> None:
        vec = np.ascontiguousarray(vector, dtype=np.float32)
        ptr = self._ensure(vec.shape[0])
        key = id_.encode("utf-8")
        self._lib.fs_set(
            ptr, key, len(key), vec.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )

    def set_batch(self, ids: list[str], vectors: np.ndarray) -> None:
        """Insert/update many vectors in one native call (fs_set_batch):
        the self-consume hot path at 100K+ deltas/s."""
        n = len(ids)
        if n == 0:
            return
        mat = np.ascontiguousarray(vectors, dtype=np.float32)
        ptr = self._ensure(mat.shape[1])
        offs, payload = _offsets_payload(ids)
        self._lib.fs_set_batch(
            ptr,
            _offsets_ptr(offs),
            payload,
            n,
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )

    def get_vector(self, id_: str) -> np.ndarray | None:
        if self._ptr is None:
            return None
        out = np.empty(self._dim, dtype=np.float32)
        key = id_.encode("utf-8")
        found = self._lib.fs_get(
            self._ptr, key, len(key), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        return out if found else None

    def get_batch(
        self, ids: list[str], dim: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectors for many ids in one native call:
        ([n, dim] float32 with zero rows for misses, [n] bool valid).
        ``dim`` keeps the shape well-formed when the store is empty."""
        n = len(ids)
        if self._ptr is None or n == 0:
            return np.zeros((n, self._dim or dim or 0), dtype=np.float32), np.zeros(n, dtype=bool)
        offs, payload = _offsets_payload(ids)
        mat = np.zeros((n, self._dim), dtype=np.float32)
        valid = np.zeros(n, dtype=np.uint8)
        self._lib.fs_get_batch(
            self._ptr,
            _offsets_ptr(offs),
            payload,
            n,
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return mat, valid.astype(bool)

    def remove_vector(self, id_: str) -> None:
        if self._ptr is not None:
            key = id_.encode("utf-8")
            self._lib.fs_remove(self._ptr, key, len(key))

    def _pack(self, recent_only: bool = False) -> tuple[list[str], np.ndarray]:
        if self._ptr is None:
            return [], np.zeros((0, 0), dtype=np.float32)
        mat_cap = max(1, self.size() + 64) * self._dim
        ids_cap = max(1024, (self.size() + 64) * 64)
        while True:
            mat = np.empty(mat_cap, dtype=np.float32)
            ids_buf = ctypes.create_string_buffer(ids_cap)
            mat_needed = ctypes.c_int64()
            ids_needed = ctypes.c_int64()
            n = self._lib.fs_pack(
                self._ptr,
                mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                mat_cap,
                ids_buf,
                ids_cap,
                ctypes.byref(mat_needed),
                ctypes.byref(ids_needed),
                1 if recent_only else 0,
            )
            if n >= 0:
                ids = _decode_ids(ids_buf.raw[: ids_needed.value])
                return ids, mat[: n * self._dim].reshape(n, self._dim).copy()
            mat_cap = max(mat_needed.value, self._dim)
            ids_cap = max(ids_needed.value, 1024)

    def _pack_ids(self, recent_only: bool = False) -> list[str]:
        """IDs without copying vector data (fs_ids)."""
        if self._ptr is None:
            return []
        ids_cap = max(4096, (self.size() + 64) * 64)
        while True:
            ids_buf = ctypes.create_string_buffer(ids_cap)
            ids_needed = ctypes.c_int64()
            n = self._lib.fs_ids(
                self._ptr, ids_buf, ids_cap, ctypes.byref(ids_needed),
                1 if recent_only else 0,
            )
            if n >= 0:
                return _decode_ids(ids_buf.raw[: ids_needed.value])
            ids_cap = max(ids_needed.value, 4096)

    def to_matrix(self) -> tuple[list[str], np.ndarray]:
        return self._pack()

    def ids(self) -> list[str]:
        return self._pack_ids()

    def items(self) -> list[tuple[str, np.ndarray]]:
        ids, mat = self._pack()
        return [(i, mat[r]) for r, i in enumerate(ids)]

    def for_each(self, fn: Callable[[str, np.ndarray], None]) -> None:
        for id_, v in self.items():
            fn(id_, v)

    def add_all_ids_to(self, out: set[str]) -> None:
        out.update(self._pack_ids())

    def add_all_recent_to(self, out: set[str]) -> None:
        out.update(self._pack_ids(recent_only=True))

    def retain_recent_and_ids(self, new_model_ids: Iterable[str]) -> None:
        if self._ptr is None:
            return
        offs, payload = _offsets_payload(list(new_model_ids))
        self._lib.fs_retain(self._ptr, _offsets_ptr(offs), payload, len(offs) - 1)

    def get_vtv(self) -> np.ndarray | None:
        if self._ptr is None or self.size() == 0:
            return None
        out = np.zeros((self._dim, self._dim), dtype=np.float64)
        self._lib.fs_vtv(self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out


def format_vectors_json(mat: np.ndarray) -> list[str]:
    """Each row of [n, k] float32 as a JSON number-array string. Native
    %.9g formatting (round-trips float32) when the library is available;
    json.dumps fallback otherwise."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    n, k = mat.shape
    lib = get_library()
    if lib is None or n == 0:
        import json

        # match the native formatter: non-finite components become 0 so the
        # wire format stays valid JSON regardless of which path serialized
        return [json.dumps(np.nan_to_num(row, nan=0.0, posinf=0.0, neginf=0.0).tolist()) for row in mat]
    cap = n * (2 + k * 18)
    out = np.empty(cap, dtype=np.uint8)  # no zero-fill: the C side writes
    offsets = np.empty(n + 1, dtype=np.int64)
    needed = ctypes.c_int64()
    total = lib.json_format_vectors(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        cap,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(needed),
    )
    if total < 0:  # pragma: no cover - cap is the function's own worst case
        raise RuntimeError("json_format_vectors buffer underestimate")
    # one decode of the packed output, then O(row) str slices (ascii, so
    # byte offsets == char offsets)
    s = out[:total].tobytes().decode("ascii")
    off = offsets.tolist()
    return [s[off[i] : off[i + 1]] for i in range(n)]


# cap on one native-formatter call's output buffer (n rows x uniform
# worst-case stride); larger requests are sliced into bounded calls
_MULTI_BUFFER_BUDGET = 256 * 1024 * 1024


def _format_rows(
    n: int,
    stride: int,
    all_ascii: bool,
    num_threads: int | None,
    invoke,
) -> list[str] | None:
    """Shared tail of the update formatters: allocate the stride-spaced
    output + row-offset buffers, run the native call, slice rows out of
    the compacted byte run (one ascii decode when every payload is ascii,
    per-row utf-8 otherwise)."""
    out = np.empty(n * stride, dtype=np.uint8)
    starts = np.empty(n, dtype=np.int64)
    ends = np.empty(n, dtype=np.int64)
    threads = num_threads or min(8, os.cpu_count() or 1)
    total = invoke(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        threads,
    )
    if total < 0:  # pragma: no cover - strides are computed right here
        return None
    st, en = starts.tolist(), ends.tolist()
    if all_ascii:
        s = str(memoryview(out)[:total], "ascii")
        return [s[st[i] : en[i]] for i in range(n)]
    buf = memoryview(out)[:total]
    return [str(buf[st[i] : en[i]], "utf-8") for i in range(n)]


def format_update_messages(
    mat: np.ndarray,
    ids: list[str],
    other_ids: list[str],
    tag: str,
    include_known: bool = True,
    num_threads: int | None = None,
) -> list[str] | None:
    """Complete speed-layer update messages ["X"|"Y", id, [v..], [other]]
    for n rows in one thread-parallel native call, or None when the
    native library is unavailable (caller assembles in Python)."""
    lib = get_library()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    n, k = mat.shape
    if n == 0:
        return []
    if len(ids) != n or (include_known and len(other_ids) != n):
        return None  # malformed pairing; the native side trusts the lengths
    id_offs, id_payload = _offsets_payload(ids)
    other_offs, other_payload = _offsets_payload(other_ids if include_known else [""] * n)
    # ascii payloads mean byte offsets == char offsets when slicing output
    all_ascii = len(id_payload) == sum(map(len, ids)) and (
        not include_known or len(other_payload) == sum(map(len, other_ids))
    )
    max_id_len = max(
        1,
        int(np.diff(id_offs).max()) if n else 1,
        int(np.diff(other_offs).max()) if n else 1,
    )
    stride = int(lib.als_update_row_cap(k, max_id_len))
    return _format_rows(
        n, stride, all_ascii, num_threads,
        lambda out, starts, ends, threads: lib.als_format_updates(
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, k,
            _offsets_ptr(id_offs), id_payload,
            _offsets_ptr(other_offs), other_payload,
            tag.encode("ascii"),
            1 if include_known else 0,
            max_id_len, out, starts, ends, threads,
        ),
    )


def format_update_messages_multi(
    mat: np.ndarray,
    ids: list[str],
    known_lists: list[list[str]],
    tag: str,
    num_threads: int | None = None,
) -> list[str] | None:
    """Update messages ["X"|"Y", id, [v..], [k1, k2, ...]] where each row
    carries its own known-id LIST — the shape the speed layer needs after
    coalescing a micro-batch's per-event updates into one message per id
    (the known items of dropped duplicates merge into the survivor).
    Returns None when the native library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    n, k = mat.shape
    if n == 0:
        return []
    if len(ids) != n or len(known_lists) != n:
        return None
    id_offs, id_payload = _offsets_payload(ids)
    flat_known: list[str] = []
    row_offs = np.empty(n + 1, dtype=np.int64)
    row_offs[0] = 0
    for i, kl in enumerate(known_lists):
        flat_known.extend(kl)
        row_offs[i + 1] = len(flat_known)
    known_offs, known_payload = _offsets_payload(flat_known)
    all_ascii = len(id_payload) == sum(map(len, ids)) and len(known_payload) == sum(
        map(len, flat_known)
    )
    max_id_len = max(1, int(np.diff(id_offs).max()) if n else 1)
    # widest known list's worst-case bytes: 6x escape + quotes + comma each
    if len(flat_known):
        per_known = np.diff(known_offs) * 6 + 3
        cs = np.concatenate([[0], np.cumsum(per_known)])
        row_extra = cs[row_offs[1:]] - cs[row_offs[:-1]]
        max_known_extra = int(row_extra.max())
    else:
        row_extra = np.zeros(n, dtype=np.int64)
        max_known_extra = 0
    base_cap = int(lib.als_update_row_cap(k, max_id_len))
    stride = base_cap + max_known_extra
    if n > 1 and n * stride > _MULTI_BUFFER_BUDGET:
        # the stride is uniform (each thread region is stride-spaced), so
        # one id with a huge known union would inflate the buffer for
        # every row; slice rows so each call's n * stride stays bounded
        # (a pathological row lands in a small slice of its own)
        out_all: list[str] = []
        lo = 0
        while lo < n:
            hi, worst = lo + 1, int(row_extra[lo])
            while hi < n:
                w = max(worst, int(row_extra[hi]))
                if (hi - lo + 1) * (base_cap + w) > _MULTI_BUFFER_BUDGET:
                    break
                worst, hi = w, hi + 1
            part = format_update_messages_multi(
                mat[lo:hi], ids[lo:hi], known_lists[lo:hi], tag, num_threads
            )
            if part is None:  # pragma: no cover - lib vanished mid-call
                return None
            out_all.extend(part)
            lo = hi
        return out_all
    return _format_rows(
        n, stride, all_ascii, num_threads,
        lambda out, starts, ends, threads: lib.als_format_updates_multi(
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, k,
            _offsets_ptr(id_offs), id_payload,
            _offsets_ptr(row_offs),
            _offsets_ptr(known_offs), known_payload,
            tag.encode("ascii"),
            stride, out, starts, ends, threads,
        ),
    )


def parse_float_csv(payload: bytes, expected: int) -> np.ndarray | None:
    """Parse a comma-separated float run natively; None when the library
    is unavailable, the token count mismatches, or a token is malformed
    (caller falls back to numpy astype / per-record parsing)."""
    lib = get_library()
    if lib is None:
        return None
    out = np.empty(expected, dtype=np.float32)
    n = lib.parse_float_csv(
        payload, len(payload), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), expected
    )
    if n != expected:
        return None
    return out


def make_feature_vectors(num_shards: int = 16):
    """Native store when available, else the pure-Python FeatureVectors."""
    if get_library() is not None:
        return NativeFeatureVectors(num_shards)
    from oryx_tpu_torch.app.als.common import FeatureVectors

    return FeatureVectors()


# -- tiered HBM->RAM->disk cell plane -----------------------------------------
#
# Large-catalog mode for the IVF host plane: instead of one flat
# [n_slots, kf] float32 array that must fit RAM, cells live in a
# three-tier store — a small LRU of decoded ndarrays (the device/HBM
# working set; on the CPU stage-1 path this is the set of cells handed
# straight to BLAS), a byte-budgeted warm tier of pinned host-RAM
# copies, and an mmap'd append-only disk file holding every cell. The
# scan gathers probed tiles through ``TieredHostPlane.gather_tiles``;
# the batcher calls ``IVFIndex.prefetch_for_queries`` while a group
# assembles so disk->RAM promotion overlaps batching instead of
# stalling the matmul. Backed by the GIL-free ts_* C++ store when the
# native library is available, with a semantics-identical pure-Python
# fallback (PyTieredCellStore) otherwise.

# residency codes (ts_residency / PyTieredCellStore.residency)
TIER_ABSENT = 0
TIER_DISK = 1
TIER_RAM = 2

_TIER_LOCK = threading.Lock()
_TIER_CONFIG = {
    "enabled": False,
    "hot_cells": 32,  # decoded-ndarray LRU entries (the "HBM" tier)
    "ram_bytes": 256 << 20,  # warm-tier byte budget
    "spill_dir": None,  # cold-tier directory; None -> per-plane tempdir
}


def configure_tier(
    enabled: bool | None = None,
    hot_cells: int | None = None,
    ram_bytes: int | None = None,
    spill_dir: str | None = None,
) -> dict:
    """Set the tiered-store knobs (oryx.serving.store.tier.* in
    reference.conf); None leaves a knob unchanged. Returns the resulting
    config. Applies to planes built afterwards — live planes keep the
    budgets they were created with."""
    with _TIER_LOCK:
        if enabled is not None:
            _TIER_CONFIG["enabled"] = bool(enabled)
        if hot_cells is not None:
            _TIER_CONFIG["hot_cells"] = max(1, int(hot_cells))
        if ram_bytes is not None:
            _TIER_CONFIG["ram_bytes"] = max(0, int(ram_bytes))
        if spill_dir is not None:
            _TIER_CONFIG["spill_dir"] = str(spill_dir) or None
        return dict(_TIER_CONFIG)


def tier_config() -> dict:
    with _TIER_LOCK:
        return dict(_TIER_CONFIG)


def tier_active() -> bool:
    """Should newly built IVF host planes move into the tiered store?"""
    with _TIER_LOCK:
        return bool(_TIER_CONFIG["enabled"])


class NativeTieredCellStore:
    """ctypes wrapper for the ts_* two-tier (RAM + disk) cell store."""

    def __init__(self, n_cells: int, ram_budget_bytes: int, directory: str):
        self._lib = get_library()
        if self._lib is None:  # pragma: no cover - caller checks first
            raise RuntimeError("native library unavailable")
        self._n_cells = int(n_cells)
        d = directory.encode("utf-8")
        self._ptr = self._lib.ts_create(
            d, len(d), self._n_cells, int(ram_budget_bytes)
        )
        if not self._ptr:
            raise RuntimeError(f"ts_create failed for {directory}")

    def __del__(self):  # pragma: no cover - interpreter teardown
        self.close()

    def close(self) -> None:
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr and self._lib is not None:
            self._lib.ts_destroy(ptr)

    def put_cell(self, cell: int, data: np.ndarray) -> None:
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        rc = self._lib.ts_put_cell(
            self._ptr,
            int(cell),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.nbytes,
        )
        if rc < 0:
            raise ValueError(f"ts_put_cell({cell}) failed")

    def cell_bytes(self, cell: int) -> int:
        return int(self._lib.ts_cell_bytes(self._ptr, int(cell)))

    def read_cell(self, cell: int) -> np.ndarray | None:
        """Cell payload as a fresh uint8 array (RAM hit or disk read +
        warm-tier promotion), or None when the cell was never written."""
        nbytes = self.cell_bytes(cell)
        if nbytes < 0:
            return None
        out = np.empty(nbytes, dtype=np.uint8)
        got = self._lib.ts_read_cell(
            self._ptr,
            int(cell),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            nbytes,
        )
        return out if got == nbytes else None

    def prefetch(self, cells: np.ndarray) -> int:
        arr = np.ascontiguousarray(cells, dtype=np.int64)
        if not len(arr):
            return 0
        return int(
            self._lib.ts_prefetch(
                self._ptr,
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(arr),
            )
        )

    def residency(self) -> np.ndarray:
        out = np.zeros(self._n_cells, dtype=np.int64)
        self._lib.ts_residency(
            self._ptr,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._n_cells,
        )
        return out

    def stats(self) -> dict:
        out = np.zeros(8, dtype=np.int64)
        self._lib.ts_stats(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        keys = (
            "ram_cells", "disk_cells", "hits", "misses",
            "promotions", "demotions", "ram_bytes", "queue_len",
        )
        return dict(zip(keys, out.tolist()))

    def drop_ram(self, cell: int) -> None:
        self._lib.ts_drop_ram(self._ptr, int(cell))


class PyTieredCellStore:
    """Pure-Python fallback with the ts_* semantics: append-only disk
    file + byte-budgeted LRU warm tier + background prefetch thread.
    Same counters, same residency codes — the tier tests run both."""

    def __init__(self, n_cells: int, ram_budget_bytes: int, directory: str):
        self._path = os.path.join(directory, "cells.bin")
        self._fd = os.open(self._path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        self._n_cells = int(n_cells)
        self._off: list[tuple[int, int]] = [(-1, 0)] * self._n_cells
        self._file_bytes = 0
        self._budget = int(ram_budget_bytes)
        self._mu = threading.Lock()  # offsets + warm tier + counters
        self._ram: dict[int, bytes] = {}  # insertion order == LRU order
        self._ram_bytes = 0
        self._hits = self._misses = 0
        self._promotions = self._demotions = 0
        self._q: list[int] = []
        self._cv = threading.Condition()
        self._stopped = False
        self._worker = threading.Thread(
            target=self._run, name="py-tier-prefetch", daemon=True
        )
        self._worker.start()

    def __del__(self):  # pragma: no cover - interpreter teardown
        self.close()

    def close(self) -> None:
        with self._cv:
            if self._stopped:
                return
            self._stopped = True
            self._cv.notify_all()
        self._worker.join(timeout=5)
        with self._mu:
            fd, self._fd = self._fd, -1
        if fd >= 0:
            os.close(fd)
            try:
                os.unlink(self._path)
            except OSError:  # pragma: no cover - already swept
                pass

    # -- warm-tier internals (caller holds self._mu) --------------------------

    def _promote_locked(self, cell: int, data: bytes) -> None:
        if cell in self._ram:
            self._ram[cell] = self._ram.pop(cell)  # LRU touch
            return
        self._ram[cell] = data
        self._ram_bytes += len(data)
        self._promotions += 1
        while self._ram_bytes > self._budget and len(self._ram) > 1:
            old, buf = next(iter(self._ram.items()))
            del self._ram[old]
            self._ram_bytes -= len(buf)
            self._demotions += 1

    def _pread(self, cell: int) -> bytes | None:
        off, nbytes = self._off[cell]
        if off < 0 or self._fd < 0:
            return None
        return os.pread(self._fd, nbytes, off)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                cell = self._q.pop(0)
            with self._mu:
                if cell in self._ram:
                    continue
                data = self._pread(cell)
                if data is not None:
                    self._promote_locked(cell, data)

    # -- ts_* surface ---------------------------------------------------------

    def put_cell(self, cell: int, data: np.ndarray) -> None:
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1).tobytes()
        with self._mu:
            if not 0 <= cell < self._n_cells:
                raise ValueError(f"cell {cell} out of range")
            os.pwrite(self._fd, buf, self._file_bytes)
            self._off[cell] = (self._file_bytes, len(buf))
            self._file_bytes += len(buf)
            stale = self._ram.pop(cell, None)  # rewritten: drop stale copy
            if stale is not None:
                self._ram_bytes -= len(stale)

    def cell_bytes(self, cell: int) -> int:
        with self._mu:
            if not 0 <= cell < self._n_cells:
                return -1
            off, nbytes = self._off[cell]
            return nbytes if off >= 0 else -1

    def read_cell(self, cell: int) -> np.ndarray | None:
        with self._mu:
            data = self._ram.get(cell)
            if data is not None:
                self._hits += 1
                self._ram[cell] = self._ram.pop(cell)  # LRU touch
            else:
                data = self._pread(cell)
                if data is None:
                    return None
                self._misses += 1
                self._promote_locked(cell, data)
        return np.frombuffer(data, dtype=np.uint8).copy()

    def prefetch(self, cells: np.ndarray) -> int:
        queued = 0
        with self._mu:
            want = [int(c) for c in np.asarray(cells).tolist() if c not in self._ram]
        if not want:
            return 0
        with self._cv:
            for c in want:
                if c not in self._q:
                    self._q.append(c)
                    queued += 1
            self._cv.notify()
        return queued

    def residency(self) -> np.ndarray:
        out = np.zeros(self._n_cells, dtype=np.int64)
        with self._mu:
            for c in range(self._n_cells):
                if self._off[c][0] < 0:
                    out[c] = TIER_ABSENT
                else:
                    out[c] = TIER_RAM if c in self._ram else TIER_DISK
        return out

    def stats(self) -> dict:
        with self._mu:
            disk = sum(1 for off, _ in self._off if off >= 0)
            snap = {
                "ram_cells": len(self._ram),
                "disk_cells": disk,
                "hits": self._hits,
                "misses": self._misses,
                "promotions": self._promotions,
                "demotions": self._demotions,
                "ram_bytes": self._ram_bytes,
            }
        with self._cv:
            snap["queue_len"] = len(self._q)
        return snap

    def drop_ram(self, cell: int) -> None:
        with self._mu:
            buf = self._ram.pop(cell, None)
            if buf is not None:
                self._ram_bytes -= len(buf)
                self._demotions += 1


def make_tier_store(n_cells: int, ram_budget_bytes: int, directory: str):
    """Native ts_* store when the library is available, else the
    pure-Python fallback — same surface either way."""
    os.makedirs(directory, exist_ok=True)
    if get_library() is not None:
        return NativeTieredCellStore(n_cells, ram_budget_bytes, directory)
    return PyTieredCellStore(n_cells, ram_budget_bytes, directory)


class TieredHostPlane:
    """IVF host stage-1 plane served out of the tiered cell store.

    Holds the per-cell geometry (tile_start/tile_count in tile units),
    a decoded-ndarray LRU (the hot tier: cells handed straight to the
    BLAS gather, sized in cells), the routing arrays the batcher's
    prefetch hint needs, and the underlying cell store. ``gather_tiles``
    is the scan-path entry point — drop-in for the flat
    ``plane3[tl].reshape(-1, kf)`` block take in ``ivf._host_topk``.
    """

    def __init__(
        self,
        store,
        *,
        tile_start: np.ndarray,
        tile_count: np.ndarray,
        tile_slots: int,
        kf: int,
        centroids: np.ndarray,
        centroid_norms: np.ndarray,
        hot_cells: int,
        spill_dir: str,
        owns_dir: bool,
    ):
        self._store = store
        self._tile_start = np.asarray(tile_start, np.int64)
        self._tile_count = np.asarray(tile_count, np.int64)
        self._ts = int(tile_slots)
        self._kf = int(kf)
        self._cent = np.ascontiguousarray(centroids, np.float32)
        self._cnorms = np.asarray(centroid_norms, np.float32)
        self._hot_cap = max(1, int(hot_cells))
        self._hot: dict[int, np.ndarray] = {}  # insertion order == LRU
        self._mu = threading.Lock()
        self._spill_dir = spill_dir
        self._owns_dir = owns_dir
        n_tiles = int((self._tile_start + self._tile_count).max(initial=0))
        # tile -> owning cell (cells are tile-contiguous by construction)
        self._tile_cell = np.full(n_tiles, -1, np.int64)
        for c in range(len(self._tile_start)):
            s, n = int(self._tile_start[c]), int(self._tile_count[c])
            self._tile_cell[s : s + n] = c

    @classmethod
    def build(
        cls,
        host_plane: np.ndarray,
        *,
        tile_start: np.ndarray,
        tile_count: np.ndarray,
        tile_slots: int,
        centroids: np.ndarray,
        centroid_norms: np.ndarray,
        store=None,
        hot_cells: int | None = None,
        ram_bytes: int | None = None,
        spill_dir: str | None = None,
    ) -> "TieredHostPlane":
        """Spill a flat [n_slots, kf] host plane into the cell store,
        cell by cell, and return the serving handle. Config knobs
        default to ``configure_tier``'s current values; pass ``store``
        to adopt a prebuilt one (tests).

        Each plane's store lives in a directory of its own, under the
        configured spill dir when one is set. (The JAX package puts it in
        the spill dir itself, where the store's file is always
        ``cells.bin``: the plane a compaction builds truncates the file
        of the plane still serving.)"""
        cfg = tier_config()
        hot = cfg["hot_cells"] if hot_cells is None else int(hot_cells)
        budget = cfg["ram_bytes"] if ram_bytes is None else int(ram_bytes)
        base = cfg["spill_dir"] if spill_dir is None else spill_dir
        owns_dir = False
        if store is None:
            import tempfile

            if base is not None:
                os.makedirs(base, exist_ok=True)
            base = tempfile.mkdtemp(prefix="oryx-tier-", dir=base)
            owns_dir = True
            store = make_tier_store(len(tile_start), budget, base)
        plane = np.ascontiguousarray(host_plane, np.float32)
        kf = plane.shape[1]
        ts = int(tile_slots)
        starts = np.asarray(tile_start, np.int64)
        counts = np.asarray(tile_count, np.int64)
        for c in range(len(starts)):
            if counts[c] <= 0:
                continue
            lo = int(starts[c]) * ts
            hi = lo + int(counts[c]) * ts
            store.put_cell(c, plane[lo:hi])
        return cls(
            store,
            tile_start=starts,
            tile_count=counts,
            tile_slots=ts,
            kf=kf,
            centroids=centroids,
            centroid_norms=centroid_norms,
            hot_cells=hot,
            spill_dir=base or "",
            owns_dir=owns_dir,
        )

    # -- scan-path surface ----------------------------------------------------

    def routing_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(centroids [kf_pad, n_cells] f32, norms [n_cells]) for the
        batcher's host-side prefetch routing."""
        return self._cent, self._cnorms

    def _cell_array(self, cell: int) -> np.ndarray:
        """Decoded [count*ts, kf] f32 for one cell: hot-LRU hit, or a
        store read (RAM hit / disk promotion) + hot insert. Counts the
        prefetch hit/miss outcome: a gather that finds the cell already
        decoded or warm means the prefetch (or locality) won the race;
        a disk read on the scan path means it lost."""
        with self._mu:
            arr = self._hot.get(cell)
            if arr is not None:
                self._hot[cell] = self._hot.pop(cell)  # LRU touch
                metrics.registry.counter("serving.store.prefetch.hit").inc()
                return arr
        warm = self._store.residency()[cell] == TIER_RAM
        buf = self._store.read_cell(cell)
        if buf is None:  # pragma: no cover - geometry guarantees writes
            raise KeyError(f"tier cell {cell} missing")
        if warm:
            metrics.registry.counter("serving.store.prefetch.hit").inc()
        else:
            metrics.registry.counter("serving.store.prefetch.miss").inc()
        arr = buf.view(np.float32).reshape(-1, self._kf)
        with self._mu:
            self._hot[cell] = arr
            while len(self._hot) > self._hot_cap:
                del self._hot[next(iter(self._hot))]
        return arr

    def gather_tiles(self, tl) -> np.ndarray:
        """Probed tiles as one [len(tl)*ts, kf] f32 slab (tile order
        preserved — the caller's slot-id arrays line up row for row)."""
        tl = np.asarray(tl, np.int64)
        out = np.empty((len(tl) * self._ts, self._kf), np.float32)
        for j, t in enumerate(tl.tolist()):
            c = int(self._tile_cell[t])
            arr = self._cell_array(c)
            o = (t - int(self._tile_start[c])) * self._ts
            out[j * self._ts : (j + 1) * self._ts] = arr[o : o + self._ts]
        self._publish_gauges()
        return out

    def prefetch_cells(self, cells) -> int:
        """Advisory disk->RAM promotion hint for probed cells (async;
        the store's worker thread does the reads)."""
        arr = np.asarray(cells, np.int64)
        with self._mu:
            cold = arr[[int(c) not in self._hot for c in arr.tolist()]]
        n = self._store.prefetch(cold) if len(cold) else 0
        self._publish_gauges()
        return n

    def _publish_gauges(self) -> None:
        st = self._store.stats()
        with self._mu:
            hot = len(self._hot)
        metrics.registry.gauge("serving.store.tier.hbm.cells").set(hot)
        metrics.registry.gauge("serving.store.tier.ram.cells").set(st["ram_cells"])
        metrics.registry.gauge("serving.store.tier.disk.cells").set(st["disk_cells"])

    def stats(self) -> dict:
        st = self._store.stats()
        with self._mu:
            st["hot_cells"] = len(self._hot)
        return st

    def __del__(self):  # pragma: no cover - a replaced plane's last handle went
        self.close()

    def close(self) -> None:
        """Stop the store, drop its spill file and the plane's own
        directory. Idempotent; a plane that no index handle holds any
        more closes itself."""
        store, self._store = getattr(self, "_store", None), None
        if store is not None:
            store.close()
        if getattr(self, "_owns_dir", False) and self._spill_dir:
            import shutil

            shutil.rmtree(self._spill_dir, ignore_errors=True)
