"""User-id skew: which simulated user each request belongs to. A frozen
copy of the port's ``loadgen/skew.py`` ``PowerLawUsers``: user indices in
[0, n_users) with density proportional to (i+1)^-exponent by inverse CDF,
an optional hot-key set overlaid; the same seed gives the same draws."""

from __future__ import annotations

import numpy as np

__all__ = ["PowerLawUsers"]


class PowerLawUsers:
    def __init__(
        self,
        n_users: int,
        exponent: float = 1.1,
        hot_count: int = 0,
        hot_weight: float = 0.0,
        seed: int = 0,
    ) -> None:
        if n_users < 1:
            raise ValueError(f"n_users must be >= 1, got {n_users}")
        if exponent <= 0:
            raise ValueError(f"exponent must be positive, got {exponent}")
        if not (0.0 <= hot_weight <= 1.0):
            raise ValueError(f"hot_weight must be in [0,1], got {hot_weight}")
        if hot_weight > 0.0 and hot_count < 1:
            raise ValueError("hot_weight set but hot_count < 1")
        self.n_users = int(n_users)
        self.exponent = float(exponent)
        self.hot_count = int(hot_count)
        self.hot_weight = float(hot_weight)
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)

    def _power_law(self, u: np.ndarray) -> np.ndarray:
        """Inverse CDF of density ~ x^-a on [1, n+1), mapped to [0, n)."""
        n = self.n_users
        a = self.exponent
        if abs(a - 1.0) < 1e-9:
            # a == 1: CDF is log(x)/log(n+1)
            x = np.power(float(n + 1), u)
        else:
            top = float(n + 1) ** (1.0 - a)
            x = np.power(1.0 + u * (top - 1.0), 1.0 / (1.0 - a))
        return np.minimum(x.astype(np.int64) - 1, n - 1)

    def sample(self, count: int) -> np.ndarray:
        """`count` user indices, power-law body + hot-key overlay."""
        rng = self._rng
        u = rng.random(count)
        ids = self._power_law(u)
        if self.hot_weight > 0.0:
            hot = rng.random(count) < self.hot_weight
            n_hot = int(hot.sum())
            if n_hot:
                ids[hot] = rng.integers(0, self.hot_count, n_hot)
        return ids

    def one(self) -> int:
        return int(self.sample(1)[0])
