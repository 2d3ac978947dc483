"""Request-scoped tenant identity.

The tenant is resolved once per HTTP request — from the ``/t/<tenant>/``
URL prefix or the ``X-Oryx-Tenant`` header — on the serving worker
thread, and everything downstream (batcher enqueue, shed accounting,
metric labels) reads it from a ContextVar instead of widening every
signature in between. Exactly the mechanism ``overload.probe_override``
uses for the reduced-probe fraction: the batcher snapshots the value
into its entry on the request thread, so the dispatcher thread never
touches the ContextVar.

Port note: a copy of ``oryx_tpu/tenancy/context.py`` (JAX-free), with
its imports pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar

# Header carrying an explicit tenant id; the URL prefix wins when both
# are present (the prefix is what the loadgen engine and fleet router
# emit, the header is the curl-friendly alternative).
TENANT_HEADER = "X-Oryx-Tenant"

# URL prefix form: /t/<tenant>/recommend/... routes to the tenant's
# model with the prefix stripped before resource dispatch.
TENANT_PATH_PREFIX = "/t/"

_current_tenant: ContextVar[str | None] = ContextVar("oryx_tenant", default=None)


def current_tenant() -> str | None:
    """The tenant the current request is being served for, if any."""
    return _current_tenant.get()


@contextmanager
def tenant_scope(tenant_id: str | None):
    """Scope a tenant identity over a router dispatch (None = untenanted)."""
    token = _current_tenant.set(tenant_id)
    try:
        yield
    finally:
        _current_tenant.reset(token)


def split_tenant_path(path: str) -> tuple[str | None, str]:
    """``(tenant, rest)`` for a ``/t/<tenant>/...`` path, or
    ``(None, path)`` unchanged. ``/t/als/recommend/u1`` ->
    ``("als", "/recommend/u1")``; a bare ``/t/als`` maps to ``/``."""
    if not path.startswith(TENANT_PATH_PREFIX):
        return None, path
    rest = path[len(TENANT_PATH_PREFIX) :]
    tenant, _, sub = rest.partition("/")
    if not tenant:
        return None, path
    return tenant, "/" + sub
