"""The card's side of a traced window, from ``torch.profiler``: every kernel,
copy and memset with its start and length, the seconds in which one ran
(their union), the ops that took the most time, and the idle gaps named
by what the host was doing then.

Only CUDA activity is recorded, so the trace costs the program little host
time. The trace's timestamps are put on the host's wall clock
(``time.time()``) through its ``baseTimeNanoseconds``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def op_name(name: str) -> str:
    """A device event's name less ``void``, the anonymous namespace and the
    argument list: ``topn_tc_kernel<8, 0, false>``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0][:80]


@dataclass
class DeviceTrace:
    """Device ops of one traced window: (name, category, start s, seconds)."""

    window: tuple[float, float]
    ops: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def intervals(self) -> list[tuple[float, float]]:
        """The union of the ops' intervals, clipped to the window."""
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(s + d, w1)) for _, _, s, d in self.ops)
        out = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals())

    def kernel_seconds(self, match) -> float:
        """Seconds of the kernels whose ``op_name`` ``match`` accepts."""
        return sum(d for n, c, _, d in self.ops if c == "kernel" and match(op_name(n)))

    def top_ops(self, count: int = 10) -> list:
        totals: dict[str, float] = {}
        for n, _, _, d in self.ops:
            key = op_name(n)
            totals[key] = totals.get(key, 0.0) + d
        return [[k, v] for k, v in sorted(totals.items(), key=lambda t: -t[1])[:count]]

    def idle_gaps(self, host_spans: list, count: int = 10) -> list:
        """The window's idle seconds summed by what the host was doing at
        each gap's midpoint: the innermost of ``host_spans`` (name, start s,
        seconds) that covers it, or "no host span"; the ``count`` largest."""
        w0, w1 = self.window
        busy = self.intervals()
        gaps, at = [], w0
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if w1 > at:
            gaps.append((at, w1))
        spans = sorted(host_spans, key=lambda s: s[1])
        totals: dict[str, float] = {}
        active, nxt = [], 0
        for a, b in gaps:  # in time order, so the sweep only moves forward
            mid = 0.5 * (a + b)
            while nxt < len(spans) and spans[nxt][1] <= mid:
                active.append(spans[nxt])
                nxt += 1
            active = [s for s in active if s[1] + s[2] >= mid]
            name = min(active, key=lambda s: s[2])[0] if active else "no host span"
            totals[name] = totals.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(totals.items(), key=lambda t: -t[1])[:count]]


class Capture:
    """``with Capture(on) as cap:`` profiles the card over the body when
    ``on``; ``cap.trace`` is the DeviceTrace afterwards (None when off, and
    without ops where there is no CUDA device)."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: DeviceTrace | None = None

    def __enter__(self):
        import torch

        self._cuda = self.on and torch.cuda.is_available()
        if self._cuda:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        if not self._cuda:
            self.trace = DeviceTrace((self._t0, time.time()))
            return False
        import torch

        torch.cuda.synchronize()
        t1 = time.time()
        self._prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        base_us = float(data.get("baseTimeNanoseconds", 0)) / 1e3
        ops = [
            (e["name"], e["cat"], (e["ts"] + base_us) / 1e6, e["dur"] / 1e6)
            for e in data.get("traceEvents", [])
            if e.get("cat") in DEVICE_CATS and "dur" in e
        ]
        self.trace = DeviceTrace((self._t0, t1), ops)
        return False
