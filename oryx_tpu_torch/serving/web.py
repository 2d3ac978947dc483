"""HTTP routing: path templates, content negotiation, error mapping.

Rebuilds the JAX-RS surface the reference gets from Jersey: @Path-style
templates with single-segment ``{name}`` and greedy ``{name:+}`` params
(the reference's ``{userID : .+}`` idiom for multi-value paths, e.g.
RecommendToMany.java:57), CSV/JSON content negotiation
(CSVMessageBodyWriter.java:38-87), and OryxServingException →
HTTP-status mapping (OryxExceptionMapper.java:28).

Port note: a copy of ``oryx_tpu/serving/web.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import inspect
import json
import re
from dataclasses import dataclass, field
from typing import Any, Callable
from urllib.parse import parse_qs, unquote

__all__ = [
    "OryxServingException",
    "Request",
    "Response",
    "Router",
    "ServingContext",
    "resource",
    "global_registry",
]


class OryxServingException(Exception):
    """Maps to an HTTP error status (OryxServingException.java)."""

    def __init__(self, status: int, message: str = "") -> None:
        super().__init__(message or str(status))
        self.status = status
        self.message = message or str(status)


@dataclass
class Request:
    method: str
    path: str
    params: dict[str, Any]  # path template params ({x:+} values are lists)
    query: dict[str, list[str]]
    headers: dict[str, str]
    body: bytes = b""

    def q1(self, name: str, default: str | None = None) -> str | None:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def q_int(self, name: str, default: int) -> int:
        v = self.q1(name)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            raise OryxServingException(400, f"bad value for {name}: {v!r}")

    def q_float(self, name: str, default: float) -> float:
        v = self.q1(name)
        if v is None:
            return default
        try:
            return float(v)
        except ValueError:
            raise OryxServingException(400, f"bad value for {name}: {v!r}")

    def q_bool(self, name: str, default: bool = False) -> bool:
        v = self.q1(name)
        if v is None:
            return default
        return v.lower() == "true"

    def q_list(self, name: str) -> list[str]:
        return self.query.get(name, [])

    def text(self) -> str:
        return self.body.decode("utf-8")

    def json(self) -> Any:
        try:
            return json.loads(self.text())
        except json.JSONDecodeError as e:
            raise OryxServingException(400, f"bad JSON body: {e}")


@dataclass
class Response:
    status: int = 200
    body: Any = None
    content_type: str | None = None  # None = negotiate
    headers: dict[str, str] = field(default_factory=dict)


class ServingContext:
    """What resources get besides the request: the model manager, the input
    producer, and config (the reference stores these in servlet-context
    attributes, OryxResource.java:11-36 / AbstractOryxResource.java:54-73)."""

    def __init__(
        self,
        model_manager,
        input_producer,
        config,
        health=None,
        registry=None,
        rollback_publisher=None,
        instance_metrics=None,
        admission=None,
        experiments=None,
    ) -> None:
        self.model_manager = model_manager
        self.input_producer = input_producer
        self.config = config
        # ServingHealth (oryx_tpu_torch/serving/layer.py) when run under a full
        # ServingLayer; None in bare router tests
        self.health = health
        # RegistryStore over the batch model dir (oryx_tpu_torch/registry/store.py)
        # when one is configured; backs /model/generations and rollback
        self.registry = registry
        # callable(generation_id) -> publish key, provided by ServingLayer
        # (republishes an archived generation onto the update topic)
        self.rollback_publisher = rollback_publisher
        # this replica's own MetricsRegistry (per-replica truth when many
        # ServingLayers share one process); None in bare router tests
        self.instance_metrics = instance_metrics
        # AdmissionController (oryx_tpu_torch/serving/overload.py) when overload
        # control is enabled under a full ServingLayer; None otherwise
        self.admission = admission
        # ExperimentCoordinator (oryx_tpu_torch/experiments/coordinator.py)
        # when online experiments are enabled; backs GET /experiments
        self.experiments = experiments


# ---------------------------------------------------------------------------
# Resource registry
# ---------------------------------------------------------------------------

_REGISTRY: list[tuple[str, str, str, Callable]] = []  # (module, method, template, fn)


def resource(method: str, template: str):
    """Register a handler: @resource("GET", "/recommend/{userID}").

    Handlers may take (ctx, req) or just (req). Return value may be a
    Response, or any JSON-serializable object (negotiated to CSV when the
    client prefers text/csv)."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY.append((fn.__module__, method.upper(), template, fn))
        return fn

    return deco


def global_registry() -> list[tuple[str, str, str, Callable]]:
    return list(_REGISTRY)


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

_PARAM_RE = re.compile(r"\{([A-Za-z_][A-Za-z0-9_]*)(:\+)?\}")


def _compile_template(template: str) -> re.Pattern:
    pattern = "^"
    pos = 0
    for m in _PARAM_RE.finditer(template):
        pattern += re.escape(template[pos : m.start()])
        name, greedy = m.group(1), m.group(2)
        pattern += f"(?P<{name}>.+)" if greedy else f"(?P<{name}>[^/]+)"
        pos = m.end()
    pattern += re.escape(template[pos:]) + "$"
    return re.compile(pattern)


class _Route:
    def __init__(self, method: str, template: str, fn: Callable) -> None:
        self.method = method
        self.template = template
        self.fn = fn
        self.pattern = _compile_template(template)
        self.greedy_names = {m.group(1) for m in _PARAM_RE.finditer(template) if m.group(2)}
        # longer literal prefixes match first
        self.specificity = (template.count("/"), -len(self.greedy_names), len(template))

    def match(self, path: str) -> dict[str, Any] | None:
        m = self.pattern.match(path)
        if not m:
            return None
        params: dict[str, Any] = {}
        for name, value in m.groupdict().items():
            if name in self.greedy_names:
                params[name] = [unquote(seg) for seg in value.split("/") if seg]
            else:
                params[name] = unquote(value)
        return params


class Router:
    def __init__(self) -> None:
        self._routes: list[_Route] = []

    def add(self, method: str, template: str, fn: Callable) -> None:
        self._routes.append(_Route(method.upper(), template, fn))
        self._routes.sort(key=lambda r: r.specificity, reverse=True)

    def add_from_registry(self, packages: list[str] | None) -> int:
        """Register resources whose defining module falls under one of
        `packages` (None = all registered). The OryxApplication package-scan
        analogue (OryxApplication.java:62-86)."""
        count = 0
        for module, method, template, fn in global_registry():
            if packages is None or any(
                module == p or module.startswith(p + ".") for p in packages
            ):
                self.add(method, template, fn)
                count += 1
        return count

    def dispatch(self, ctx: ServingContext, req: Request) -> Response:
        path_matched = False
        for route in self._routes:
            params = route.match(req.path)
            if params is None:
                continue
            path_matched = True
            if route.method != req.method:
                continue
            req.params = params
            result = _invoke(route.fn, ctx, req)
            if isinstance(result, Response):
                return result
            return Response(200, result)
        if path_matched:
            raise OryxServingException(405, f"method {req.method} not allowed for {req.path}")
        raise OryxServingException(404, f"no resource for {req.path}")


def _invoke(fn: Callable, ctx: ServingContext, req: Request) -> Any:
    sig = inspect.signature(fn)
    if len(sig.parameters) >= 2:
        return fn(ctx, req)
    return fn(req)


# ---------------------------------------------------------------------------
# Serialization / negotiation
# ---------------------------------------------------------------------------


def _csv_line(item: Any) -> str:
    from oryx_tpu_torch.common import text as text_utils

    if callable(getattr(item, "to_csv", None)):  # HasCSV, structurally
        return item.to_csv()
    if isinstance(item, (list, tuple)):
        return text_utils.join_csv(list(item))
    if isinstance(item, dict):
        return text_utils.join_csv(list(item.values()))
    return str(item)


def _jsonable(obj: Any) -> Any:
    if hasattr(obj, "to_json"):
        return obj.to_json()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    try:
        import numpy as np

        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.generic):
            return obj.item()
    except ImportError:  # pragma: no cover
        pass
    return obj


def render(response: Response, accept: str) -> tuple[int, bytes, str, dict[str, str]]:
    """Serialize a Response per the Accept header: text/csv renders one CSV
    line per item (CSVMessageBodyWriter semantics); JSON otherwise."""
    if response.body is None:
        return response.status, b"", "text/plain", response.headers
    ct = response.content_type
    if ct is None:
        wants_csv = "text/csv" in accept and "application/json" not in accept.split(",")[0]
        ct = "text/csv" if wants_csv else "application/json"
    if ct == "application/json":
        payload = json.dumps(_jsonable(response.body)).encode("utf-8")
    elif ct == "text/csv":
        body = response.body
        if isinstance(body, (list, tuple)):
            payload = ("\n".join(_csv_line(x) for x in body) + "\n").encode("utf-8")
        else:
            payload = (_csv_line(body) + "\n").encode("utf-8")
    else:
        payload = body_bytes(response.body)
    return response.status, payload, ct, response.headers


def body_bytes(body: Any) -> bytes:
    if isinstance(body, bytes):
        return body
    return str(body).encode("utf-8")
