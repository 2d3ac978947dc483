"""Wire-format text utilities: CSV and JSON line parse/join.

Rebuild of the reference's TextUtils (framework/oryx-common/src/main/java/
com/cloudera/oryx/common/text/TextUtils.java:38-190) and the parse function
in MLFunctions.PARSE_FN (app/oryx-app-common/.../common/fn/MLFunctions.java:
30-54): an input line is JSON if it starts with '[' or '{', otherwise CSV.
`join_json`/`parse_json` is the wire format for ALS feature-vector "UP"
updates.

Port note: a copy of ``oryx_tpu/common/text.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import csv
import io
import json
import math
from typing import Any, Sequence

__all__ = [
    "parse_json_array",
    "parse_delimited",
    "parse_csv",
    "parse_line",
    "join_delimited",
    "join_csv",
    "join_json",
    "read_json",
]


def parse_json_array(line: str) -> list:
    """Parse a JSON array line into a flat list of strings/values.

    Mirrors TextUtils.parseJSONArray: primitives become their string form,
    nested arrays/objects stay JSON-encoded strings.
    """
    arr = json.loads(line)
    if not isinstance(arr, list):
        raise ValueError(f"not a JSON array: {line!r}")
    out: list[str] = []
    for v in arr:
        if isinstance(v, (list, dict)):
            out.append(json.dumps(v))
        elif isinstance(v, bool):
            out.append("true" if v else "false")
        elif v is None:
            out.append("")
        else:
            out.append(str(v))
    return out


def parse_delimited(line: str, delimiter: str = ",") -> list[str]:
    if not line:
        return []
    if '"' not in line:  # fast path: no quoting, plain split (hot ingest path)
        return line.split(delimiter)
    reader = csv.reader(io.StringIO(line), delimiter=delimiter)
    for row in reader:
        return row
    return []


def parse_csv(line: str) -> list[str]:
    return parse_delimited(line, ",")


def parse_line(line: str) -> list[str]:
    """CSV-or-JSON auto-detect (MLFunctions.PARSE_FN semantics)."""
    stripped = line.strip()
    if stripped.startswith("[") or stripped.startswith("{"):
        return parse_json_array(stripped)
    return parse_csv(stripped)


def _fmt(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return str(v)


def join_delimited(items: Sequence[Any], delimiter: str = ",") -> str:
    buf = io.StringIO()
    writer = csv.writer(buf, delimiter=delimiter, lineterminator="")
    writer.writerow([_fmt(x) for x in items])
    return buf.getvalue()


def join_csv(items: Sequence[Any]) -> str:
    return join_delimited(items, ",")


class _CompactEncoder(json.JSONEncoder):
    def default(self, o: Any):
        try:
            import numpy as np

            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, np.generic):
                return o.item()
        except ImportError:  # pragma: no cover
            pass
        return super().default(o)


def join_json(items: Sequence[Any]) -> str:
    """Serialize a list as a compact JSON array (the 'UP' message format)."""
    return json.dumps(list(items), cls=_CompactEncoder, separators=(",", ":"), allow_nan=True)


def read_json(text: str) -> Any:
    return json.loads(text)


_PLAIN = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-.:@ "
)


def json_str(s: str) -> str:
    """JSON string literal; quoting fast path for typical IDs."""
    if all(c in _PLAIN for c in s):
        return f'"{s}"'
    return json.dumps(s)
