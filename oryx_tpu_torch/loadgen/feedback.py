"""Scripted interaction feedback: close the recommendation loop.

The online experiment evaluator (oryx_tpu_torch/experiments/) can only judge
arms if served recommendations are followed by interaction events on the
input topic. In production those come from real users; in the harness,
:class:`ScriptedFeedback` plays the user: it parses each served response,
rolls a *deterministic* per-serve die against the serving generation's
scripted engagement rate, and on a hit emits a ``user,item,value`` event
for one of the served items — exactly the wire format the speed layer
(and the evaluator) already parse.

Determinism matters: the roll hashes (seed, user, per-user serve count),
so a run is reproducible and the realized engagement rate per generation
converges on the scripted one regardless of thread interleaving. Keep
the module stdlib-only: it runs inside the loadgen client.

Port note: a copy of ``oryx_tpu/loadgen/feedback.py`` (JAX-free).
"""

from __future__ import annotations

import hashlib
import json
import threading


def roll(seed: int, user, serve_index: int) -> float:
    """Deterministic uniform [0, 1) draw for one (user, serve)."""
    digest = hashlib.blake2b(
        f"{seed}:{user}:{serve_index}".encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / 2.0**64


class ScriptedFeedback:
    """An ``on_response`` hook for :class:`~oryx_tpu_torch.loadgen.engine.
    OpenLoopEngine` that emits scripted interaction events.

    ``send``: callable(line) delivering one ``user,item,value`` line to
    the input topic (the fleet harness wires a raw-broker producer).
    ``hit_rate_of``: callable(generation_id) -> engagement probability
    for answers served by that generation — the scripted ground truth
    that makes one arm genuinely better than the other.
    """

    def __init__(self, send, hit_rate_of, seed: int = 7) -> None:
        self.send = send
        self.hit_rate_of = hit_rate_of
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._serve_counts: dict[str, int] = {}
        self.sent = 0

    def on_response(self, user, status, headers, body: bytes) -> None:
        if status != 200 or not body:
            return
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return
        if not isinstance(payload, dict):
            return
        items = payload.get("items")
        served_user = payload.get("user", user)
        generation = payload.get("generation_id")
        if not isinstance(items, list) or not items:
            return
        with self._lock:
            index = self._serve_counts.get(str(served_user), 0)
            self._serve_counts[str(served_user)] = index + 1
        p = float(self.hit_rate_of(generation))
        draw = roll(self.seed, served_user, index)
        if draw >= p:
            return  # no engagement for this serve
        # pick the engaged item from the served list, biased to the top
        # rank the way real click distributions are: reuse the sub-p
        # draw, squared, as the rank position
        rank = int((draw / p) ** 2 * len(items))
        item = items[min(rank, len(items) - 1)]
        self.send(f"{served_user},{item},1")
        with self._lock:
            self.sent += 1
