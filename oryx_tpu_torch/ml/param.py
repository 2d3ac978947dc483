"""Hyperparameter value-range algebra and grid construction.

Rebuild of framework/oryx-ml/.../param/ (HyperParams.java:32-195,
ContinuousRange/DiscreteRange/ContinuousAround/DiscreteAround/Unordered):
a range yields `num` trial values (evenly spaced; discrete ranges
enumerate when dense enough; "around" values step symmetrically about a
center), the full cross-product of per-param trials is built, and a
random subset is drawn when the grid exceeds the requested candidates.

Port note: a copy of ``oryx_tpu/ml/param.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import abc
from typing import Any, Sequence

from oryx_tpu_torch.common import rng
from oryx_tpu_torch.common.config import Config

MAX_COMBOS = 65536


class HyperParamValues(abc.ABC):
    @abc.abstractmethod
    def get_trial_values(self, num: int) -> list:
        """`num` representative values across this range."""

    def sample(self, gen) -> Any:
        """One random draw from the range (random-search strategy).
        Ranges override with true uniform draws; discrete/neighborhood
        types draw among their trial values."""
        vals = self.get_trial_values(9)
        return vals[int(gen.integers(len(vals)))]


class _ContinuousRange(HyperParamValues):
    def __init__(self, lo: float, hi: float) -> None:
        if lo > hi:
            raise ValueError(f"min {lo} > max {hi}")
        self.lo, self.hi = float(lo), float(hi)

    def get_trial_values(self, num: int) -> list:
        assert num > 0
        if self.hi == self.lo:
            return [self.lo]
        if num == 1:
            return [(self.hi + self.lo) / 2.0]
        step = (self.hi - self.lo) / (num - 1)
        vals = [self.lo + i * step for i in range(num)]
        vals[-1] = self.hi
        return vals

    def sample(self, gen) -> float:
        return float(gen.uniform(self.lo, self.hi))


class _DiscreteRange(HyperParamValues):
    def __init__(self, lo: int, hi: int) -> None:
        if lo > hi:
            raise ValueError(f"min {lo} > max {hi}")
        self.lo, self.hi = int(lo), int(hi)

    def sample(self, gen) -> int:
        return int(gen.integers(self.lo, self.hi + 1))

    def get_trial_values(self, num: int) -> list:
        assert num > 0
        if self.hi == self.lo:
            return [self.lo]
        if num == 1:
            return [(self.hi + self.lo) // 2]
        if num == 2:
            return [self.lo, self.hi]
        if num > self.hi - self.lo:
            return list(range(self.lo, self.hi + 1))
        step = (self.hi - self.lo) / (num - 1)
        vals = [self.lo]
        for i in range(1, num - 1):
            vals.append(round(vals[i - 1] + step))
        vals.append(self.hi)
        return vals


class _ContinuousAround(HyperParamValues):
    def __init__(self, center: float, step: float) -> None:
        if step <= 0:
            raise ValueError("step must be positive")
        self.center, self.step = float(center), float(step)

    def get_trial_values(self, num: int) -> list:
        assert num > 0
        if num == 1:
            return [self.center]
        start = self.center - ((num - 1) / 2.0) * self.step
        vals = [start + i * self.step for i in range(num)]
        if num % 2 != 0:
            vals[num // 2] = self.center  # keep middle value exact
        return vals


class _DiscreteAround(HyperParamValues):
    def __init__(self, center: int, step: int) -> None:
        if step <= 0:
            raise ValueError("step must be positive")
        self.center, self.step = int(center), int(step)

    def get_trial_values(self, num: int) -> list:
        assert num > 0
        if num == 1:
            return [self.center]
        start = self.center - ((num - 1) * self.step // 2)
        return [start + i * self.step for i in range(num)]


class _Unordered(HyperParamValues):
    def __init__(self, values: Sequence[Any]) -> None:
        if not values:
            raise ValueError("no values")
        self.values = list(values)

    def get_trial_values(self, num: int) -> list:
        assert num > 0
        return self.values[:num] if num < len(self.values) else list(self.values)

    def sample(self, gen) -> Any:
        # over ALL values: the base default draws from get_trial_values(9),
        # which for unordered is a deterministic prefix — values past the
        # 9th would never be sampled
        return self.values[int(gen.integers(len(self.values)))]


def fixed(value: Any) -> HyperParamValues:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return _Unordered([value])
    if isinstance(value, int):
        return _DiscreteRange(value, value)
    return _ContinuousRange(value, value)


def range_param(lo, hi) -> HyperParamValues:
    if isinstance(lo, int) and isinstance(hi, int):
        return _DiscreteRange(lo, hi)
    return _ContinuousRange(lo, hi)


def around(center, step) -> HyperParamValues:
    if isinstance(center, int) and isinstance(step, int):
        return _DiscreteAround(center, step)
    return _ContinuousAround(center, step)


def unordered(values: Sequence[Any]) -> HyperParamValues:
    return _Unordered(values)


def from_config(config: Config, key: str) -> HyperParamValues:
    """Config value -> range (HyperParams.fromConfig:74-109 semantics):
    scalar int/float -> fixed; 2-element numeric list -> range; any other
    list -> unordered; other scalar -> unordered singleton."""
    v = config.get(key)
    if isinstance(v, list):
        if len(v) >= 2:
            if all(isinstance(x, int) and not isinstance(x, bool) for x in v[:2]):
                return _DiscreteRange(v[0], v[1])
            if all(isinstance(x, (int, float)) and not isinstance(x, bool) for x in v[:2]):
                return _ContinuousRange(v[0], v[1])
        return _Unordered([str(x) for x in v])
    if isinstance(v, bool) or v is None:
        return _Unordered([v])
    if isinstance(v, (int, float)):
        return fixed(v)
    s = str(v)
    try:
        return fixed(int(s))
    except ValueError:
        pass
    try:
        return fixed(float(s))
    except ValueError:
        pass
    return _Unordered([s])


def choose_values_per_hyper_param(num_params: int, candidates: int) -> int:
    """Smallest v with v**num_params >= candidates (HyperParams.java:179-193)."""
    if num_params < 1:
        return 0
    v = 0
    while True:
        v += 1
        if v**num_params >= candidates:
            return v


def choose_hyper_parameter_combos(
    ranges: Sequence[HyperParamValues], how_many: int, per_param: int
) -> list[list]:
    """Cross-product of per-param trial values, randomly subsampled to
    `how_many` and shuffled (HyperParams.chooseHyperParameterCombos:122-171).
    """
    if how_many <= 0:
        raise ValueError("how_many must be positive")
    if per_param < 0:
        raise ValueError("per_param must be >= 0")
    num_params = len(ranges)
    if num_params == 0 or per_param == 0:
        return [[]]
    if per_param**num_params > MAX_COMBOS:
        raise ValueError(f"{per_param}^{num_params} exceeds {MAX_COMBOS} combos")

    param_values = [r.get_trial_values(per_param) for r in ranges]
    total = 1
    for vals in param_values:
        total *= len(vals)

    combos: list[list] = []
    for combo in range(total):
        combination = []
        idx = combo
        for vals in param_values:
            combination.append(vals[idx % len(vals)])
            idx //= len(vals)
        combos.append(combination)

    gen = rng.get_random()
    if how_many >= total:
        gen.shuffle(combos)
        return combos
    picked = gen.permutation(total)[:how_many]
    return [combos[i] for i in picked]


def sample_hyper_parameter_combos(
    ranges: Sequence[HyperParamValues], how_many: int
) -> list[list]:
    """Random-search combos (oryx.ml.eval.hyperparam-search = "random"):
    each candidate draws every hyperparameter independently — continuous
    ranges uniformly over [lo, hi] rather than from a fixed grid, which
    dominates grid search when only a few of many dimensions matter
    (Bergstra & Bengio 2012). Duplicates are retried so small discrete
    spaces still yield distinct candidates when possible."""
    if how_many <= 0:
        raise ValueError("how_many must be positive")
    if len(ranges) == 0:
        return [[]]
    gen = rng.get_random()
    combos: list[list] = []
    seen: set = set()
    attempts = 0
    while len(combos) < how_many and attempts < how_many * 20:
        attempts += 1
        combo = [r.sample(gen) for r in ranges]
        key = tuple(combo)
        if key in seen:
            continue
        seen.add(key)
        combos.append(combo)
    return combos if combos else [[]]
