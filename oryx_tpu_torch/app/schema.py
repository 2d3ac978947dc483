"""Input schema: feature naming/typing declared in config.

Rebuild of InputSchema (app/oryx-app-common/.../schema/InputSchema.java:
37-282) and CategoricalValueEncodings (.../CategoricalValueEncodings.java:
33-100): feature names (or a count), id/ignored feature sets, numeric vs
categorical typing (declare one set, the complement gets the other type),
target feature, and the feature-index <-> predictor-index maps that skip
id/ignored columns.

Port note: a copy of ``oryx_tpu/app/schema.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from oryx_tpu_torch.common.config import Config, ConfigError


class InputSchema:
    def __init__(self, config: Config) -> None:
        names = config.get_strings("oryx.input-schema.feature-names")
        if not names:
            num = config.get_int("oryx.input-schema.num-features")
            if num <= 0:
                raise ConfigError("input-schema requires feature-names or num-features")
            names = [str(i) for i in range(num)]
        if len(set(names)) != len(names):
            raise ConfigError(f"duplicate feature names: {names}")
        self.feature_names: list[str] = names

        id_f = set(config.get_optional_strings("oryx.input-schema.id-features") or [])
        ignored = set(config.get_optional_strings("oryx.input-schema.ignored-features") or [])
        self._id_features = id_f
        self._ignored = ignored

        numeric = config.get_optional_strings("oryx.input-schema.numeric-features")
        categorical = config.get_optional_strings("oryx.input-schema.categorical-features")
        if (numeric is None) == (categorical is None):
            raise ConfigError("set exactly one of numeric-features / categorical-features")
        active = [n for n in names if n not in id_f and n not in ignored]
        # type declarations must name ACTIVE features only: the reference
        # rejects declared sets that aren't subsets of the actives
        # (InputSchema.java:89-101). Silently intersecting instead would
        # hide typos — a misspelled feature name drops the declaration and
        # flips the feature to the complementary type without a word.
        declared = set(numeric) if numeric is not None else set(categorical)
        extra = declared - set(active)
        if extra:
            which = "numeric" if numeric is not None else "categorical"
            raise ConfigError(
                f"{which}-features {sorted(extra)} are not active features "
                f"(active: {sorted(active)})"
            )
        if numeric is not None:
            self._numeric = declared
            self._categorical = {n for n in active if n not in self._numeric}
        else:
            self._categorical = declared
            self._numeric = {n for n in active if n not in self._categorical}

        self.target_feature = config.get_optional_string("oryx.input-schema.target-feature")
        if self.target_feature is not None and self.target_feature not in active:
            raise ConfigError(f"target feature {self.target_feature} is not active")

        # feature index <-> predictor index (predictors = active non-target
        # plus target? reference: predictors are all active features incl.
        # target; the target has a predictor index too, InputSchema.java:98-119)
        self._feature_to_predictor: dict[int, int] = {}
        self._predictor_to_feature: dict[int, int] = {}
        p = 0
        for i, n in enumerate(names):
            if n in id_f or n in ignored:
                continue
            self._feature_to_predictor[i] = p
            self._predictor_to_feature[p] = i
            p += 1
        self.num_predictors = p

    # -- queries (InputSchema.java API surface) -----------------------------

    @property
    def num_features(self) -> int:
        return len(self.feature_names)

    def is_id(self, name_or_index: str | int) -> bool:
        return self._name(name_or_index) in self._id_features

    def is_active(self, name_or_index: str | int) -> bool:
        n = self._name(name_or_index)
        return n not in self._id_features and n not in self._ignored

    def is_numeric(self, name_or_index: str | int) -> bool:
        return self._name(name_or_index) in self._numeric

    def is_categorical(self, name_or_index: str | int) -> bool:
        return self._name(name_or_index) in self._categorical

    def is_target(self, name_or_index: str | int) -> bool:
        return self.target_feature is not None and self._name(name_or_index) == self.target_feature

    def has_target(self) -> bool:
        return self.target_feature is not None

    @property
    def target_feature_index(self) -> int | None:
        if self.target_feature is None:
            return None
        return self.feature_names.index(self.target_feature)

    def feature_to_predictor_index(self, feature_index: int) -> int:
        return self._feature_to_predictor[feature_index]

    def predictor_to_feature_index(self, predictor_index: int) -> int:
        return self._predictor_to_feature[predictor_index]

    def _name(self, name_or_index: str | int) -> str:
        if isinstance(name_or_index, int):
            return self.feature_names[name_or_index]
        return name_or_index

    def __repr__(self) -> str:  # pragma: no cover
        return f"InputSchema({self.feature_names})"


class CategoricalValueEncodings:
    """Per-categorical-feature string<->int bimaps
    (CategoricalValueEncodings.java:33-100). Keyed by feature index."""

    def __init__(self, distinct_values: Mapping[int, Sequence[str]]) -> None:
        self._value_to_index: dict[int, dict[str, int]] = {}
        self._index_to_value: dict[int, dict[int, str]] = {}
        for feat, values in distinct_values.items():
            v2i = {v: i for i, v in enumerate(values)}
            self._value_to_index[feat] = v2i
            self._index_to_value[feat] = {i: v for v, i in v2i.items()}

    def index_for(self, feature: int, value: str) -> int:
        return self._value_to_index[feature][value]

    def value_for(self, feature: int, index: int) -> str:
        return self._index_to_value[feature][index]

    def value_to_index_map(self, feature: int) -> dict[str, int]:
        return dict(self._value_to_index.get(feature, {}))

    def index_to_value_map(self, feature: int) -> dict[int, str]:
        return dict(self._index_to_value.get(feature, {}))

    def category_counts(self) -> dict[int, int]:
        return {f: len(m) for f, m in self._value_to_index.items()}

    def category_count(self, feature: int) -> int:
        return len(self._value_to_index[feature])
