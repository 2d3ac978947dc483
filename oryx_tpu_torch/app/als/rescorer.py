"""Rescorer SPI: user-pluggable filtering/boosting of recommendations.

Rebuild of app/oryx-app-api .../als/{Rescorer,RescorerProvider,
AbstractRescorerProvider,MultiRescorer,MultiRescorerProvider}.java:
providers are named in config (oryx.als.rescorer-provider-class) and
asked per-request for a Rescorer given the request's rescorerParams.

Port note: a copy of ``oryx_tpu/app/als/rescorer.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import abc
import math
from typing import Sequence


class Rescorer(abc.ABC):
    @abc.abstractmethod
    def rescore(self, id_: str, original_score: float) -> float:
        """New score; NaN removes the candidate (Rescorer.java)."""

    def is_filtered(self, id_: str) -> bool:
        return False


class RescorerProvider(abc.ABC):
    """Per-endpoint rescorer factories (RescorerProvider.java); any may
    return None meaning 'no rescoring here'."""

    def get_recommend_rescorer(self, user_ids: Sequence[str], args: Sequence[str]) -> Rescorer | None:
        return None

    def get_recommend_to_anonymous_rescorer(self, item_ids: Sequence[str], args: Sequence[str]) -> Rescorer | None:
        return None

    def get_most_popular_items_rescorer(self, args: Sequence[str]) -> Rescorer | None:
        return None

    def get_most_active_users_rescorer(self, args: Sequence[str]) -> Rescorer | None:
        return None


class MultiRescorer(Rescorer):
    """AND-combination of several rescorers (MultiRescorer.java)."""

    def __init__(self, rescorers: Sequence[Rescorer]) -> None:
        self.rescorers = list(rescorers)

    def rescore(self, id_: str, original_score: float) -> float:
        score = original_score
        for r in self.rescorers:
            score = r.rescore(id_, score)
            if math.isnan(score):
                return score
        return score

    def is_filtered(self, id_: str) -> bool:
        return any(r.is_filtered(id_) for r in self.rescorers)


def _combine(rescorers: list[Rescorer]) -> Rescorer | None:
    rescorers = [r for r in rescorers if r is not None]
    if not rescorers:
        return None
    if len(rescorers) == 1:
        return rescorers[0]
    return MultiRescorer(rescorers)


class MultiRescorerProvider(RescorerProvider):
    """Chains several providers (MultiRescorerProvider.java)."""

    def __init__(self, providers: Sequence[RescorerProvider]) -> None:
        self.providers = list(providers)

    def get_recommend_rescorer(self, user_ids, args):
        return _combine([p.get_recommend_rescorer(user_ids, args) for p in self.providers])

    def get_recommend_to_anonymous_rescorer(self, item_ids, args):
        return _combine(
            [p.get_recommend_to_anonymous_rescorer(item_ids, args) for p in self.providers]
        )

    def get_most_popular_items_rescorer(self, args):
        return _combine([p.get_most_popular_items_rescorer(args) for p in self.providers])

    def get_most_active_users_rescorer(self, args):
        return _combine([p.get_most_active_users_rescorer(args) for p in self.providers])
