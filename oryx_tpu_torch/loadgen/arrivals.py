"""Open-loop arrival processes: when requests WOULD arrive.

An arrival process yields absolute arrival offsets (seconds from the
start of the run) independent of how the server is doing — that
independence is the entire point of open-loop load generation. All
randomness comes from one seeded numpy generator per process instance,
so a scenario re-runs with the identical arrival schedule.

Two processes cover the production shapes the harness needs:

- ``PoissonProcess`` — homogeneous Poisson arrivals at a fixed offered
  rate (exponential inter-arrivals), the memoryless baseline open-loop
  benchmarks assume.
- ``DiurnalRampProcess`` — a non-homogeneous Poisson process whose rate
  follows a raised-cosine diurnal curve between ``base_rate`` (trough)
  and ``peak_rate`` (peak) over ``period_s``, sampled by Lewis-Shedler
  thinning against the peak rate. Compressing a day into a bench-sized
  period exercises ramp-up behavior (batcher adaptation, autoscaling
  headroom) that a flat rate never touches.

Port note: a copy of ``oryx_tpu/loadgen/arrivals.py`` (JAX-free); the same seed gives the
same draws as the JAX package's.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np

__all__ = ["DiurnalRampProcess", "PoissonProcess"]


class PoissonProcess:
    """Homogeneous Poisson arrivals at `rate` requests/second."""

    def __init__(self, rate: float, seed: int = 0) -> None:
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        self.rate = float(rate)
        self.seed = int(seed)

    def offered_rate(self, t: float) -> float:
        return self.rate

    def times(self, duration_s: float) -> Iterator[float]:
        """Arrival offsets in [0, duration_s), in increasing order."""
        rng = np.random.default_rng(self.seed)
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / self.rate))
            if t >= duration_s:
                return
            yield t

    def expected_arrivals(self, duration_s: float) -> float:
        return self.rate * duration_s


class DiurnalRampProcess:
    """Non-homogeneous Poisson arrivals on a raised-cosine diurnal curve.

    rate(t) = base + (peak - base) * (1 - cos(2*pi*(t/period + phase)))/2

    starts at the trough (phase 0), peaks at period/2. Thinning: candidate
    arrivals are drawn at the peak rate and accepted with probability
    rate(t)/peak — exact for any bounded rate function.
    """

    def __init__(
        self,
        base_rate: float,
        peak_rate: float,
        period_s: float,
        seed: int = 0,
        phase: float = 0.0,
    ) -> None:
        if base_rate <= 0 or peak_rate < base_rate:
            raise ValueError(
                f"need 0 < base_rate <= peak_rate, got {base_rate}/{peak_rate}"
            )
        if period_s <= 0:
            raise ValueError(f"period_s must be positive, got {period_s}")
        self.base_rate = float(base_rate)
        self.peak_rate = float(peak_rate)
        self.period_s = float(period_s)
        self.phase = float(phase)
        self.seed = int(seed)

    def offered_rate(self, t: float) -> float:
        swing = (self.peak_rate - self.base_rate) / 2.0
        c = 1.0 - math.cos(2.0 * math.pi * (t / self.period_s + self.phase))
        return self.base_rate + swing * c

    def times(self, duration_s: float) -> Iterator[float]:
        rng = np.random.default_rng(self.seed)
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / self.peak_rate))
            if t >= duration_s:
                return
            if rng.random() < self.offered_rate(t) / self.peak_rate:
                yield t

    def expected_arrivals(self, duration_s: float) -> float:
        # integrate rate(t) numerically — good enough for test tolerances
        n = max(100, int(duration_s * 10))
        ts = np.linspace(0.0, duration_s, n)
        return float(np.trapezoid([self.offered_rate(t) for t in ts], ts))
