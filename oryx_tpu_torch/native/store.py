"""Feature-vector store and update-message formatting for the ALS apps
(counterpart of ``oryx_tpu/native/store.py``, pure-Python parts only).

The JAX package formats vectors and speed-layer update messages in C++
when its native library is built, and falls back to Python when it is
not (``oryx_tpu/native/store.py:235-247``, ``:448-454``). The port's
native library holds only the HTTP front so far, so this module takes
those Python paths: vectors are ``json.dumps`` text (the native
formatter writes ``%.9g``; the float32 values read back equal) and the
store is the pure-Python ``FeatureVectors`` of ``app/als/common.py``.
The C++ store and parser are not ported.
"""

from __future__ import annotations

import json

import numpy as np

from oryx_tpu_torch.common.text import json_str


def format_vectors_json(mat: np.ndarray) -> list[str]:
    """Each row of [n, k] float32 as a JSON number-array string;
    non-finite components become 0 so the wire format stays valid JSON."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    return [
        json.dumps(np.nan_to_num(row, nan=0.0, posinf=0.0, neginf=0.0).tolist())
        for row in mat
    ]


def _message(tag: str, id_: str, vec_json: str, known: list[str] | None) -> str:
    """["X"|"Y", id, vector(, knownIds)] (ALSSpeedModelManager.
    toUpdateJSON:207-215)."""
    if known is None:
        return f'["{tag}",{json_str(id_)},{vec_json}]'
    return f'["{tag}",{json_str(id_)},{vec_json},[{",".join(json_str(s) for s in known)}]]'


def format_update_messages(
    mat: np.ndarray,
    ids: list[str],
    other_ids: list[str],
    tag: str,
    include_known: bool = True,
) -> list[str]:
    """Speed-layer update messages ["X"|"Y", id, [v..](, [other])] for n
    rows, with one other id per row when ``include_known``."""
    vecs = format_vectors_json(mat)
    return [
        _message(tag, id_, vec, [other_ids[i]] if include_known else None)
        for i, (id_, vec) in enumerate(zip(ids, vecs))
    ]


def format_update_messages_multi(
    mat: np.ndarray, ids: list[str], known_lists: list[list[str]], tag: str
) -> list[str]:
    """Update messages ["X"|"Y", id, [v..], [k1, k2, ...]] where each row
    carries its own known-id list — the shape the speed layer needs after
    coalescing a micro-batch's per-event updates into one message per id."""
    vecs = format_vectors_json(mat)
    return [_message(tag, i, v, kl) for i, v, kl in zip(ids, vecs, known_lists)]


def make_feature_vectors(num_shards: int = 16):
    """The pure-Python FeatureVectors (the JAX package's store when its
    native library is absent); ``num_shards`` is the native store's and
    is ignored."""
    from oryx_tpu_torch.app.als.common import FeatureVectors

    return FeatureVectors()
