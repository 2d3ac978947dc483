"""Deterministic champion/challenger arm assignment.

Users are bucketed by a salted blake2b hash of their id mapped into
[0, 1): a user lands in the challenger arm iff their bucket falls below
``oryx.serving.ab.fraction``. The hash is keyed only on (salt, user), so
assignment is sticky for the lifetime of an experiment and identical on
every replica — no coordination, no assignment state.

The module also carries the per-request generation override: the serving
layer wraps challenger-arm dispatch in :func:`serve_generation` and
generation-aware model managers consult :func:`requested_generation`
inside ``get_model()``. This mirrors the ``probe_override`` ContextVar in
``serving/overload.py`` — per-request values thread through dispatch
without widening every signature on the path.

Port note: a copy of ``oryx_tpu/experiments/routing.py`` (JAX-free),
with its imports pointed at ``oryx_tpu_torch``; :func:`bucket_of` is the
same hash, so both packages put a user in the same arm.
"""

from __future__ import annotations

import hashlib
import re
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass

ARM_CHAMPION = "champion"
ARM_CHALLENGER = "challenger"
#: Response header naming the arm that served the request.
ARM_HEADER = "X-Oryx-Experiment-Arm"

_requested_generation: ContextVar[str | None] = ContextVar(
    "oryx_requested_generation", default=None
)


def requested_generation() -> str | None:
    """The generation the current request should be served from, when an
    experiment routed it to a non-live arm (None otherwise)."""
    return _requested_generation.get()


@contextmanager
def serve_generation(generation_id: str | None):
    """Scope a generation override to the current request."""
    token = _requested_generation.set(generation_id)
    try:
        yield
    finally:
        _requested_generation.reset(token)


_consuming_challenger: ContextVar[str | None] = ContextVar(
    "oryx_consuming_challenger", default=None
)


def consuming_challenger() -> str | None:
    """The generation id the tracker currently classifies as challenger,
    visible while the serving layer feeds an update block to the model
    manager. Generation-aware managers consult this in ``consume()`` to
    retain the challenger's model WITHOUT swapping it in as the default —
    only the arm router (via :func:`serve_generation`) may route requests
    to it. None outside experiment mode, so managers that ignore it keep
    the plain swap-on-arrival behavior."""
    return _consuming_challenger.get()


@contextmanager
def consume_challenger(generation_id: str | None):
    """Scope the tracked challenger id around one block consume."""
    token = _consuming_challenger.set(generation_id)
    try:
        yield
    finally:
        _consuming_challenger.reset(token)


def bucket_of(user: str, salt: str) -> float:
    """Deterministic bucket for `user` in [0, 1). Stable across
    processes and runs (Python's builtin ``hash`` is per-process
    salted, so it is useless here)."""
    digest = hashlib.blake2b(
        f"{salt}:{user}".encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / 2.0**64


@dataclass(frozen=True)
class ABConfig:
    """``oryx.serving.ab`` knob block."""

    fraction: float = 0.0
    salt: str = "oryx-ab"
    user_header: str = "X-Oryx-User"
    user_pattern: str = r"(?:^|/)recommend[A-Za-z]*/([^/]+)"
    join_window_s: float = 300.0
    max_tracked_users: int = 10000

    @classmethod
    def from_config(cls, config) -> "ABConfig":
        block = config.get_config("oryx.serving.ab")
        return cls(
            fraction=block.get_float("fraction"),
            salt=block.get_string("salt"),
            user_header=block.get_string("user-header"),
            user_pattern=block.get_string("user-pattern"),
            join_window_s=block.get_float("join-window-s"),
            max_tracked_users=block.get_int("max-tracked-users"),
        )

    @property
    def enabled(self) -> bool:
        return self.fraction > 0.0


class ArmRouter:
    """Stateless arm assignment: extract the experiment unit (user) from
    a request, hash it into an arm."""

    def __init__(self, cfg: ABConfig) -> None:
        self.cfg = cfg
        self._pattern = re.compile(cfg.user_pattern) if cfg.user_pattern else None
        self._header_key = cfg.user_header.lower()

    def user_of(self, path: str, headers=None) -> str | None:
        """The experiment unit for a request: the user header when
        present, else the first capture of the path pattern, else None
        (unattributed — served by the champion)."""
        if headers:
            for k in headers:
                if k.lower() == self._header_key:
                    value = headers[k]
                    if value:
                        return str(value)
                    break
        if self._pattern is not None:
            m = self._pattern.search(path.split("?", 1)[0])
            if m:
                return m.group(1)
        return None

    def assign(self, user: str) -> str:
        """Sticky arm for `user`."""
        if bucket_of(user, self.cfg.salt) < self.cfg.fraction:
            return ARM_CHALLENGER
        return ARM_CHAMPION
