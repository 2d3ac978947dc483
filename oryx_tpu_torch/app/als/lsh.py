"""Locality-sensitive hashing for approximate ALS top-N.

Behavioral port of the reference's LocalitySensitiveHash
(app/oryx-app-serving/.../als/model/LocalitySensitiveHash.java:26-188):
sign-of-dot-product bit hashing of item vectors into 2^h partitions, with
candidate partitions being every index within `max_bits_differing` Hamming
distance of the query's partition. The hash count is the smallest h whose
probed-partition fraction is <= the configured sample rate while the probe
count still keeps >= num_cores workers busy.

LSH is opt-in via oryx.als.sample-rate < 1.0; the pruned candidates are
scored on the host (``serving_model._host_top_k``). Partition assignment
here is vectorized over the whole item matrix instead of the reference's
per-vector loop.

Port note: a copy of ``oryx_tpu/app/als/lsh.py`` (JAX-free), with its
imports pointed at ``oryx_tpu_torch``: a seeded ``common/rng.py`` draws
the same hash vectors in both packages.
"""

from __future__ import annotations

import math
from itertools import combinations

import numpy as np

from oryx_tpu_torch.common import rng as rng_mod

MAX_HASHES = 16


def choose_hashes_and_bits(sample_rate: float, num_cores: int) -> tuple[int, int]:
    """Smallest hash count (and widest Hamming radius) such that the probed
    fraction of partitions is <= sample_rate while the number of probed
    partitions stays near num_cores (LocalitySensitiveHash.java:41-76;
    probe count may overshoot num_cores by one binomial step)."""
    bits_differing = 0
    for num_hashes in range(MAX_HASHES):
        bits_differing = 0
        partitions_to_try = 1
        while bits_differing < num_hashes and partitions_to_try < num_cores:
            bits_differing += 1
            partitions_to_try += math.comb(num_hashes, bits_differing)
        if bits_differing == num_hashes and partitions_to_try < num_cores:
            continue  # can't keep enough cores busy; add hashes
        if partitions_to_try <= sample_rate * (1 << num_hashes):
            return num_hashes, bits_differing
    return MAX_HASHES, bits_differing


def _choose_orthogonal_vectors(num_hashes: int, num_features: int) -> np.ndarray:
    """Random hash vectors picked greedily most-orthogonal by rejection:
    keep drawing until 1000 consecutive candidates fail to lower the total
    |cosine| against the already-chosen set (LocalitySensitiveHash.java:
    80-105)."""
    gen = rng_mod.get_random()
    chosen = np.zeros((num_hashes, num_features), dtype=np.float32)
    norms = np.zeros(num_hashes)
    for i in range(num_hashes):
        best_score = np.inf
        best = None
        since_best = 0
        while since_best < 1000:
            candidate = gen.standard_normal(num_features).astype(np.float32)
            cnorm = float(np.linalg.norm(candidate))
            if cnorm == 0.0:
                continue
            if i == 0:
                score = 0.0
            else:
                dots = np.abs(chosen[:i] @ candidate)
                score = float((dots / (norms[:i] * cnorm)).sum())
            if score < best_score:
                best = candidate
                if score == 0.0:
                    break
                best_score = score
                since_best = 0
            else:
                since_best += 1
        chosen[i] = best
        norms[i] = float(np.linalg.norm(best))
    return chosen


class LocalitySensitiveHash:
    def __init__(self, sample_rate: float, num_features: int, num_cores: int) -> None:
        self.num_hashes, self.max_bits_differing = choose_hashes_and_bits(
            sample_rate, num_cores
        )
        self.hash_vectors = _choose_orthogonal_vectors(self.num_hashes, num_features)
        # all 2^h indices ordered by popcount, the XOR-mask prototype for
        # candidate enumeration (LocalitySensitiveHash.java:108-117)
        masks: list[int] = []
        for bits in range(self.num_hashes + 1):
            masks.extend(
                sum(1 << b for b in combo)
                for combo in combinations(range(self.num_hashes), bits)
            )
        self._masks_by_popcount = np.asarray(masks, dtype=np.int64)
        self._num_candidates = sum(
            math.comb(self.num_hashes, i) for i in range(self.max_bits_differing + 1)
        )

    @property
    def num_partitions(self) -> int:
        return 1 << self.num_hashes

    def index_for(self, vector: np.ndarray) -> int:
        """Partition index: bit i set iff hash_i . v > 0
        (getIndexFor:142-150)."""
        if self.num_hashes == 0:
            return 0
        dots = self.hash_vectors @ np.asarray(vector, dtype=np.float32)
        return int(((dots > 0.0) << np.arange(self.num_hashes)).sum())

    def partitions_for(self, matrix: np.ndarray) -> np.ndarray:
        """Vectorized index_for over rows of an [n, k] matrix."""
        if self.num_hashes == 0:
            return np.zeros(len(matrix), dtype=np.int64)
        bits = (matrix @ self.hash_vectors.T) > 0.0
        return (bits << np.arange(self.num_hashes)).sum(axis=1).astype(np.int64)

    def candidate_indices(self, vector: np.ndarray) -> np.ndarray:
        """All partition indices within max_bits_differing Hamming distance
        of the query's partition (getCandidateIndices:156-177)."""
        main = self.index_for(vector)
        if self.num_hashes == self.max_bits_differing:
            return np.arange(self.num_partitions, dtype=np.int64)
        if self.max_bits_differing == 0:
            return np.asarray([main], dtype=np.int64)
        return self._masks_by_popcount[: self._num_candidates] ^ main
