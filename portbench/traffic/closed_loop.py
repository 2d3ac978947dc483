"""The closed-loop client: ``clients`` callers, each on a keep-alive
connection of its own, each sending its next ``GET`` as soon as its last
answer has come, users drawn by ``PowerLawUsers`` (a stream of its own per
caller and phase). It runs in a process of its own, so that its work does
not share the server's interpreter lock.

    python -m portbench.traffic.closed_loop

reads one JSON spec line on standard input, runs ``warmup_s`` seconds of
the same traffic, prints ``warm``, waits for a ``go`` line, then runs the
window's ``seconds``, prints ``done`` once every request has been
answered, then one JSON record per request and ``end`` last, and exits.
A caller sends nothing once the phase's seconds have passed; the requests
then in flight are answered and recorded, their ``done`` past the phase.
A request's latency runs from its send.
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time

import numpy as np

from portbench.traffic.skew import PowerLawUsers

STAGE_HEADER = "X-Oryx-Shed-Stage"
USERS_AT_ONCE = 4096


def caller_seed(seed: int, phase: int, caller: int) -> int:
    return int(np.random.SeedSequence([seed, phase, caller]).generate_state(1)[0])


class Keepalive:
    """One keep-alive HTTP connection, opened again after a failure."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.conn = None

    def get(self, user: int):
        """(status, stage, body) of ``GET path``; status -1 when the
        connection failed."""
        try:
            if self.conn is None:
                self.conn = http.client.HTTPConnection(
                    self.spec["host"], self.spec["port"], timeout=self.spec["timeout_s"])
            self.conn.request("GET", self.spec["path"].format(user=user))
            resp = self.conn.getresponse()
            return resp.status, resp.getheader(STAGE_HEADER), resp.read()
        except (OSError, http.client.HTTPException):
            self.close()
            return -1, None, b""

    def close(self):
        if self.conn is not None:
            self.conn.close()
        self.conn = None


class Caller(threading.Thread):
    def __init__(self, spec: dict, seconds: float, phase: int, caller: int, records: list):
        super().__init__(daemon=True)
        skew = spec["skew"]
        self.users = PowerLawUsers(spec["users"], skew["exponent"], skew["hot_count"],
                                   skew["hot_weight"], caller_seed(spec["seed"], phase, caller))
        self.conn, self.seconds, self.records = Keepalive(spec), seconds, records
        self.t0 = 0.0

    def run(self):
        end = self.t0 + self.seconds
        todo: list = []
        while (sent := time.perf_counter()) < end:
            if not todo:
                todo = self.users.sample(USERS_AT_ONCE).tolist()[::-1]
            user = todo.pop()
            status, stage, body = self.conn.get(user)
            done = time.perf_counter()
            self.records.append({
                "user": user, "sent": sent - self.t0, "done": done - self.t0,
                "ms": (done - sent) * 1e3, "status": status, "stage": stage,
                "body": body.decode("utf-8", "replace") if status == 200 else None,
            })
        self.conn.close()


def run_phase(spec: dict, seconds: float, phase: int) -> list:
    """Every caller's requests of one phase, once all have been answered."""
    records: list = []
    callers = [Caller(spec, seconds, phase, c, records) for c in range(spec["clients"])]
    t0 = time.perf_counter()
    for c in callers:
        c.t0 = t0
        c.start()
    for c in callers:
        c.join()
    return records


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    run_phase(spec, spec["warmup_s"], 0)
    print("warm", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    records = run_phase(spec, spec["seconds"], 1)
    out = sys.stdout
    out.write("done\n")
    out.flush()
    for rec in sorted(records, key=lambda r: r["sent"]):
        out.write(json.dumps(rec) + "\n")
    out.write("end\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
