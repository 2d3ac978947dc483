"""Layered HOCON-style configuration.

Reimplements the behavior the reference gets from Typesafe Config +
``ConfigUtils`` (reference: framework/oryx-common/src/main/java/com/cloudera/
oryx/common/settings/ConfigUtils.java:37-160 and resources/reference.conf).
Config is the framework's dependency-injection mechanism: fully-qualified
class names and tuning values all come from one layered tree, and a config
can be serialized to a string and reparsed so it can be shipped to another
process (the reference ships it into the Tomcat servlet context this way,
ServingLayer.java:275-276).

This is a from-scratch HOCON *subset* parser supporting the features the
framework's own conf files use: ``#``/``//`` comments, nested objects,
dotted keys, ``=`` or ``:`` separators, lists, quoted/unquoted strings,
numbers, booleans, ``null``, ``${path}`` / ``${?path}`` substitutions, and
string-value concatenation (e.g. ``${base}"/data/"``).

Port note: a copy of ``oryx_tpu/common/config.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Iterator

__all__ = [
    "Config",
    "ConfigError",
    "parse_hocon",
    "from_string",
    "from_file",
    "get_default",
    "overlay_on",
    "set_default_overlay",
    "serialize",
    "key_value_to_properties",
]


class ConfigError(Exception):
    """Missing key, type mismatch, or parse failure."""


_MISSING = object()


# ---------------------------------------------------------------------------
# Tokenizer / parser
# ---------------------------------------------------------------------------

_PUNCT = set("{}[],=:")
_UNQUOTED_FORBIDDEN = set('{}[],=:#"\n\r$')


class _Sub:
    """An unresolved ``${path}`` substitution."""

    __slots__ = ("path", "optional")

    def __init__(self, path: str, optional: bool) -> None:
        self.path = path
        self.optional = optional

    def __repr__(self) -> str:  # pragma: no cover
        return f"${{{'?' if self.optional else ''}{self.path}}}"


class _Concat:
    """A value built from several adjacent tokens (string concatenation)."""

    __slots__ = ("parts",)

    def __init__(self, parts: list[Any]) -> None:
        self.parts = parts


class _Fallback:
    """An optional substitution shadowing an earlier value: ``a = ${?x}``
    over an existing ``a`` keeps the existing value when x is absent
    (HOCON fall-through semantics)."""

    __slots__ = ("sub", "fallback")

    def __init__(self, sub: "_Sub", fallback: Any) -> None:
        self.sub = sub
        self.fallback = fallback


def _tokenize(text: str) -> list[Any]:
    """Tokens: punctuation chars, "\n", ("str", s), ("raw", s), _Sub, and
    ("ws",) markers recording whitespace between adjacent value tokens (so
    string concatenation preserves separators, per HOCON)."""
    toks: list[Any] = []
    pending_ws = False

    def emit(tok: Any) -> None:
        nonlocal pending_ws
        if pending_ws and toks and _is_value_token(toks[-1]) and _is_value_token(tok):
            toks.append(("ws",))
        pending_ws = False
        toks.append(tok)

    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r":
            pending_ws = True
            i += 1
        elif c == "\n":
            emit("\n")
            i += 1
        elif c == "#" or text.startswith("//", i):
            while i < n and text[i] != "\n":
                i += 1
        elif c == '"':
            if text.startswith('"""', i):
                end = text.find('"""', i + 3)
                if end < 0:
                    raise ConfigError("unterminated triple-quoted string")
                emit(("str", text[i + 3 : end]))
                i = end + 3
            else:
                j = i + 1
                buf = []
                while j < n and text[j] != '"':
                    if text[j] == "\\" and j + 1 < n:
                        esc = text[j + 1]
                        if esc == "u":
                            if j + 6 > n:
                                raise ConfigError("malformed \\u escape")
                            try:
                                buf.append(chr(int(text[j + 2 : j + 6], 16)))
                            except ValueError as e:
                                raise ConfigError(f"malformed \\u escape: {text[j:j+6]!r}") from e
                            j += 6
                        else:
                            buf.append(
                                {
                                    "n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f",
                                    '"': '"', "\\": "\\", "/": "/",
                                }.get(esc, esc)
                            )
                            j += 2
                    else:
                        buf.append(text[j])
                        j += 1
                if j >= n:
                    raise ConfigError("unterminated string")
                emit(("str", "".join(buf)))
                i = j + 1
        elif c == "$":
            if text.startswith("${", i):
                end = text.find("}", i)
                if end < 0:
                    raise ConfigError("unterminated substitution")
                inner = text[i + 2 : end].strip()
                optional = inner.startswith("?")
                if optional:
                    inner = inner[1:].strip()
                emit(_Sub(inner, optional))
                i = end + 1
            else:
                # a literal '$' inside an unquoted value
                j = i + 1
                while j < n and text[j] not in _UNQUOTED_FORBIDDEN:
                    j += 1
                emit(("raw", text[i:j].strip()))
                i = j
        elif c in _PUNCT:
            emit(c)
            i += 1
        else:
            j = i
            while j < n and text[j] not in _UNQUOTED_FORBIDDEN:
                j += 1
            raw = text[i:j].strip()
            if raw:
                emit(("raw", raw))
            i = j if j > i else i + 1
    return toks


def _is_value_token(tok: Any) -> bool:
    return isinstance(tok, _Sub) or (
        isinstance(tok, tuple) and len(tok) == 2 and tok[0] in ("str", "raw")
    )


def _coerce_raw(raw: str) -> Any:
    if raw == "null":
        return None
    if raw == "true":
        return True
    if raw == "false":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


class _Parser:
    def __init__(self, toks: list[Any]) -> None:
        self.toks = toks
        self.pos = 0

    def peek(self) -> Any:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> Any:
        tok = self.peek()
        self.pos += 1
        return tok

    def skip_newlines(self) -> None:
        while self.peek() in ("\n", ","):
            self.pos += 1

    def parse_root(self) -> dict:
        self.skip_newlines()
        if self.peek() == "{":
            obj = self.parse_object()
        else:
            obj = self.parse_object_body(root=True)
        self.skip_newlines()
        if self.peek() is not None:
            raise ConfigError(f"trailing content at token {self.peek()!r}")
        return obj

    def parse_object(self) -> dict:
        assert self.next() == "{"
        obj = self.parse_object_body(root=False)
        if self.next() != "}":
            raise ConfigError("expected '}'")
        return obj

    def parse_object_body(self, root: bool) -> dict:
        obj: dict = {}
        while True:
            self.skip_newlines()
            tok = self.peek()
            if tok is None:
                if root:
                    return obj
                raise ConfigError("unexpected end of input in object")
            if tok == "}":
                return obj
            key = self.parse_key()
            tok = self.peek()
            if tok == "{":
                # object value without separator: key { ... }  (also merges)
                value = self.parse_object()
            else:
                sep = self.next()
                if sep not in ("=", ":"):
                    raise ConfigError(f"expected '=' or ':' after key {key!r}, got {sep!r}")
                while self.peek() == "\n":
                    self.pos += 1
                value = self.parse_value()
            _put_path(obj, key, value)

    def parse_key(self) -> list[str]:
        parts: list[str] = []
        while True:
            tok = self.peek()
            if tok == ("ws",):
                self.next()
                continue
            if isinstance(tok, tuple) and tok[0] in ("raw", "str"):
                self.next()
                text = tok[1]
                if tok[0] == "raw":
                    parts.extend(p for p in text.split(".") if p)
                else:
                    parts.append(text)
            else:
                break
        if not parts:
            raise ConfigError(f"expected key, got {self.peek()!r}")
        return parts

    def parse_value(self) -> Any:
        parts: list[Any] = []
        while True:
            tok = self.peek()
            if tok is None or tok in ("\n", ",", "}", "]"):
                break
            if tok == "{":
                parts.append(self.parse_object())
            elif tok == "[":
                parts.append(self.parse_list())
            elif isinstance(tok, _Sub):
                self.next()
                parts.append(tok)
            elif tok == ("ws",):
                self.next()
                parts.append(" ")  # preserved separator inside a concatenation
            elif isinstance(tok, tuple):
                self.next()
                kind, text = tok
                parts.append(_coerce_raw(text) if kind == "raw" else text)
            else:
                raise ConfigError(f"unexpected token {tok!r} in value")
        if not parts:
            raise ConfigError("empty value")
        if len(parts) == 1:
            return parts[0]
        return _Concat(parts)

    def parse_list(self) -> list:
        assert self.next() == "["
        items: list[Any] = []
        while True:
            self.skip_newlines()
            if self.peek() == "]":
                self.next()
                return items
            if self.peek() is None:
                raise ConfigError("unterminated list")
            items.append(self.parse_value())


def _put_path(obj: dict, path: list[str], value: Any) -> None:
    node = obj
    for part in path[:-1]:
        child = node.get(part)
        if not isinstance(child, dict):
            child = {}
            node[part] = child
        node = child
    last = path[-1]
    existing = node.get(last, _MISSING)
    if isinstance(existing, dict) and isinstance(value, dict):
        _deep_merge(existing, value)
    elif isinstance(value, _Sub) and value.optional and existing is not _MISSING:
        node[last] = _Fallback(value, existing)
    else:
        node[last] = value


def _deep_merge(base: dict, overlay: dict) -> dict:
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        elif isinstance(v, _Sub) and v.optional and k in base:
            base[k] = _Fallback(copy.deepcopy(v), base[k])
        else:
            base[k] = copy.deepcopy(v)
    return base


def _lookup(root: dict, path: str) -> Any:
    node: Any = root
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return _MISSING
        node = node[part]
    return node


def _resolve(root: dict) -> None:
    """Resolve ${path} substitutions iteratively (handles forward refs)."""

    for _ in range(20):
        changed, unresolved = _resolve_pass(root, root)
        if not unresolved:
            return
        if not changed:
            raise ConfigError(f"unresolvable substitution(s): {unresolved}")
    raise ConfigError("substitution cycle detected")


def _resolve_pass(node: Any, root: dict) -> tuple[bool, list[str]]:
    changed = False
    unresolved: list[str] = []

    def resolve_value(v: Any) -> tuple[Any, bool]:
        """Return (new_value, resolved?). An absent optional ${?path}
        resolves to _MISSING: the key is then removed entirely (HOCON
        semantics — it must not clobber a lower layer's value)."""
        if isinstance(v, _Sub):
            target = _lookup(root, v.path)
            if target is _MISSING or isinstance(target, (_Sub, _Concat)):
                if v.optional and target is _MISSING:
                    return _MISSING, True
                unresolved.append(v.path)
                return v, False
            return copy.deepcopy(target), True
        if isinstance(v, _Fallback):
            target = _lookup(root, v.sub.path)
            if target is _MISSING:
                return resolve_value(v.fallback)
            if isinstance(target, (_Sub, _Concat, _Fallback)):
                unresolved.append(v.sub.path)
                return v, False
            return copy.deepcopy(target), True
        if isinstance(v, _Concat):
            new_parts = []
            ok = True
            for p in v.parts:
                np, pok = resolve_value(p)
                ok = ok and pok
                new_parts.append(np)
            if not ok:
                return _Concat(new_parts), False
            real = [p for p in new_parts if p is not _MISSING]
            # whitespace separators don't defeat object merging:
            # `z = ${x} ${y}` over two objects merges them (HOCON)
            non_ws = [p for p in real if not (isinstance(p, str) and p.strip() == "")]
            if non_ws and all(isinstance(p, dict) for p in non_ws):
                merged: dict = {}
                for p in non_ws:
                    _deep_merge(merged, p)
                return merged, True
            return "".join("" if p is None or p is _MISSING else str(p) for p in real), True
        return v, True

    if isinstance(node, dict):
        for k, v in list(node.items()):
            if isinstance(v, (dict, list)):
                c, u = _resolve_pass(v, root)
                changed = changed or c
                unresolved.extend(u)
            elif isinstance(v, (_Sub, _Concat, _Fallback)):
                nv, ok = resolve_value(v)
                if ok:
                    if nv is _MISSING:
                        del node[k]
                    else:
                        node[k] = nv
                    changed = True
                elif nv is not v:
                    node[k] = nv
    elif isinstance(node, list):
        drop: list[int] = []
        for i, v in enumerate(list(node)):
            if isinstance(v, (dict, list)):
                c, u = _resolve_pass(v, root)
                changed = changed or c
                unresolved.extend(u)
            elif isinstance(v, (_Sub, _Concat, _Fallback)):
                nv, ok = resolve_value(v)
                if ok:
                    if nv is _MISSING:
                        drop.append(i)
                    else:
                        node[i] = nv
                    changed = True
                elif nv is not v:
                    node[i] = nv
        for i in reversed(drop):
            del node[i]
    return changed, unresolved


def parse_hocon(text: str, resolve: bool = True) -> dict:
    parser = _Parser(_tokenize(text))
    root = parser.parse_root()
    if resolve:
        _resolve(root)
    return root


# ---------------------------------------------------------------------------
# Config object
# ---------------------------------------------------------------------------


def _render_scalar(v: Any) -> str:
    """HOCON-style string rendering: booleans are true/false."""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


class Config:
    """Immutable view over a nested config dict with dotted-path access."""

    def __init__(self, data: dict) -> None:
        self._data = data

    # -- raw access ---------------------------------------------------------

    def get(self, path: str, default: Any = _MISSING) -> Any:
        v = _lookup(self._data, path)
        if v is _MISSING:
            if default is _MISSING:
                raise ConfigError(f"missing config key: {path}")
            return default
        return v

    def has(self, path: str) -> bool:
        """True if key exists and is non-null (Typesafe `hasPath` semantics)."""
        v = _lookup(self._data, path)
        return v is not _MISSING and v is not None

    # -- typed getters ------------------------------------------------------

    def get_string(self, path: str) -> str:
        v = self.get(path)
        if v is None or isinstance(v, (dict, list)):
            raise ConfigError(f"{path} is not a string: {v!r}")
        return _render_scalar(v)

    def get_int(self, path: str) -> int:
        v = self.get(path)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ConfigError(f"{path} is not a number: {v!r}")
        return int(v)

    def get_float(self, path: str) -> float:
        v = self.get(path)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ConfigError(f"{path} is not a number: {v!r}")
        return float(v)

    def get_bool(self, path: str) -> bool:
        v = self.get(path)
        if not isinstance(v, bool):
            raise ConfigError(f"{path} is not a boolean: {v!r}")
        return v

    def get_list(self, path: str) -> list:
        v = self.get(path)
        if not isinstance(v, list):
            raise ConfigError(f"{path} is not a list: {v!r}")
        return v

    def get_strings(self, path: str) -> list[str]:
        return [str(x) for x in self.get_list(path)]

    def get_config(self, path: str) -> "Config":
        v = self.get(path)
        if not isinstance(v, dict):
            raise ConfigError(f"{path} is not an object: {v!r}")
        return Config(v)

    # -- optional getters (null or missing -> None); mirrors
    # ConfigUtils.getOptionalString/getOptionalStringList/getOptionalDouble
    # (reference ConfigUtils.java:49-89) -----------------------------------

    def get_optional_string(self, path: str) -> str | None:
        v = _lookup(self._data, path)
        if v is _MISSING or v is None:
            return None
        if isinstance(v, (dict, list)):
            raise ConfigError(f"{path} is not a string: {v!r}")
        return _render_scalar(v)

    def get_optional_strings(self, path: str) -> list[str] | None:
        v = _lookup(self._data, path)
        if v is _MISSING or v is None:
            return None
        if isinstance(v, list):
            return [_render_scalar(x) for x in v]
        if isinstance(v, dict):
            raise ConfigError(f"{path} is not a string list: {v!r}")
        return [s.strip() for s in str(v).split(",") if s.strip()]

    def get_optional_float(self, path: str) -> float | None:
        v = _lookup(self._data, path)
        if v is _MISSING or v is None:
            return None
        return float(v)

    def get_optional_int(self, path: str) -> int | None:
        v = _lookup(self._data, path)
        if v is _MISSING or v is None:
            return None
        return int(v)

    def get_optional_bool(self, path: str) -> bool | None:
        v = _lookup(self._data, path)
        if v is _MISSING or v is None:
            return None
        if not isinstance(v, bool):
            raise ConfigError(f"{path} is not a boolean: {v!r}")
        return v

    # -- layering -----------------------------------------------------------

    def with_overlay(self, overlay: "Config | dict | str | None") -> "Config":
        """Return a new Config = self with `overlay` taking precedence.

        Mirrors ConfigUtils.overlayOn (reference ConfigUtils.java:69-80).
        """
        if overlay is None:
            return self
        if isinstance(overlay, str):
            # parse unresolved so ${...} in the overlay can reference base keys
            overlay = parse_hocon(overlay, resolve=False)
        elif isinstance(overlay, Config):
            overlay = overlay._data
        merged = copy.deepcopy(self._data)
        _deep_merge(merged, overlay)
        _resolve(merged)
        return Config(merged)

    def as_dict(self) -> dict:
        return copy.deepcopy(self._data)

    # -- serialization ------------------------------------------------------

    def serialize(self) -> str:
        """Render to a string that parse_hocon can read back.

        Mirrors ConfigUtils.serialize (reference ConfigUtils.java:90-101):
        used to ship config across process boundaries as one string.
        """
        return json.dumps(self._data, ensure_ascii=False)

    def pretty(self) -> str:
        return json.dumps(self._data, indent=2, sort_keys=True, ensure_ascii=False)

    def to_properties(self, prefix: str = "") -> dict[str, str]:
        """Flatten to dotted key -> string value (ConfigToProperties analogue)."""
        out: dict[str, str] = {}

        def walk(node: Any, path: str) -> None:
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}.{k}" if path else k)
            elif node is None:
                pass
            elif isinstance(node, list):
                out[path] = json.dumps(node)
            elif isinstance(node, bool):
                out[path] = "true" if node else "false"
            else:
                out[path] = str(node)

        walk(self._data, prefix)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"Config({json.dumps(self._data)[:200]})"


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

_DEFAULT_RESOURCES = [
    os.path.join(os.path.dirname(__file__), "resources", "reference.conf"),
    os.path.join(os.path.dirname(__file__), "..", "app", "resources", "reference.conf"),
]

_default_overlay: dict | None = None


def from_string(text: str) -> Config:
    return Config(parse_hocon(text))


def from_file(path: str) -> Config:
    with open(path, "r", encoding="utf-8") as f:
        return from_string(f.read())


def serialize(config: Config) -> str:
    return config.serialize()


def deserialize(text: str) -> Config:
    return from_string(text)


def set_default_overlay(overlay: dict | None) -> None:
    """Install a process-global overlay used by get_default() (test hook)."""
    global _default_overlay
    _default_overlay = overlay


def get_default() -> Config:
    """Layered default config: packaged reference.conf files, then the file
    named by $ORYX_CONF (the analogue of -Dconfig.file, oryx-run.sh:146-147),
    then any programmatic overlay installed by set_default_overlay()."""
    merged: dict = {}
    for res in _DEFAULT_RESOURCES:
        res = os.path.abspath(res)
        if os.path.exists(res):
            with open(res, "r", encoding="utf-8") as f:
                _deep_merge(merged, parse_hocon(f.read(), resolve=False))
    user = os.environ.get("ORYX_CONF")
    if user:
        with open(user, "r", encoding="utf-8") as f:
            _deep_merge(merged, parse_hocon(f.read(), resolve=False))
    if _default_overlay:
        _deep_merge(merged, copy.deepcopy(_default_overlay))
    _resolve(merged)
    return Config(merged)


def overlay_on(overlay: Config | dict | str | None, base: Config) -> Config:
    return base.with_overlay(overlay)


def key_value_to_properties(*pairs: Any) -> dict[str, str]:
    """keyValueToProperties analogue (ConfigUtils.java:103-118)."""
    if len(pairs) % 2 != 0:
        raise ValueError("odd number of key/value elements")
    it: Iterator[Any] = iter(pairs)
    return {str(k): str(v) for k, v in zip(it, it)}
