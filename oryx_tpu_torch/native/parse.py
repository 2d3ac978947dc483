"""ctypes binding for the native columnar text parser (``parse.cpp``;
counterpart of ``oryx_tpu/native/parse.py``).

One GIL-released pass turns a text-frame block's fixed-width S-array of
``user,item,value[,timestamp]`` lines into the typed int32/int32/f32/i64
columns a KIND_COLS frame would have carried, plus the block-uniform id
prefixes. Strictly conservative: any line the native grammar cannot
reproduce bit-identically (quotes, JSON, non-canonical ids, oddball
numerics, malformed rows) makes the WHOLE block return None, and the
caller runs the Python parser — which also owns raising ``ValueError``
on genuinely bad input. ``None`` likewise when the library is absent
(build failure or ORYX_NATIVE=0), so pure-Python remains a clean
fallback everywhere.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from oryx_tpu_torch.native import get_library


class ParsedTextColumns(NamedTuple):
    """Typed columns for one text block, ready for
    ``rating_matrix_from_int_columns``."""

    users: np.ndarray  # int32
    items: np.ndarray  # int32
    values: np.ndarray  # float32
    timestamps: np.ndarray | None  # int64, None when no line carried one
    user_prefix: bytes
    item_prefix: bytes


def parse_text_columns(
    messages: np.ndarray | list[bytes], threads: int = 1
) -> ParsedTextColumns | None:
    """Parse a block of interaction lines natively, or None to fall back.

    ``messages`` is the S-dtype array a decoded RecordBlock holds (a list
    of bytes works too, for the non-block path). ``threads`` bounds the
    native worker threads; rows are split across them and the pass is
    GIL-released either way.
    """
    lib = get_library()
    if lib is None:
        return None
    if isinstance(messages, np.ndarray):
        arr = messages
    else:
        if not messages:
            return None
        try:
            arr = np.asarray(messages, dtype="S")
        except (TypeError, ValueError):
            return None
    if arr.dtype.kind != "S" or arr.ndim != 1:
        return None
    n = len(arr)
    w = arr.dtype.itemsize
    if n == 0 or w == 0:
        return None
    arr = np.ascontiguousarray(arr)
    users = np.empty(n, np.int32)
    items = np.empty(n, np.int32)
    values = np.empty(n, np.float32)
    ts = np.empty(n, np.int64)
    prefixes = np.zeros(32, np.uint8)
    flags = np.zeros(1, np.int32)
    c = ctypes
    rc = lib.als_parse_text_block(
        arr.ctypes.data_as(c.c_char_p),
        n,
        w,
        users.ctypes.data_as(c.POINTER(c.c_int32)),
        items.ctypes.data_as(c.POINTER(c.c_int32)),
        values.ctypes.data_as(c.POINTER(c.c_float)),
        ts.ctypes.data_as(c.POINTER(c.c_int64)),
        prefixes.ctypes.data_as(c.POINTER(c.c_uint8)),
        flags.ctypes.data_as(c.POINTER(c.c_int32)),
        max(1, int(threads)),
    )
    if rc != 0:
        return None
    uplen = int(prefixes[0])
    iplen = int(prefixes[16])
    return ParsedTextColumns(
        users,
        items,
        values,
        ts if int(flags[0]) & 1 else None,
        bytes(prefixes[1 : 1 + uplen]),
        bytes(prefixes[17 : 17 + iplen]),
    )
