"""Deterministic randomness manager.

Rebuild of the reference's RandomManager (framework/oryx-common/src/main/
java/com/cloudera/oryx/common/random/RandomManager.java:29-100): normal mode
hands out OS-entropy generators; test mode (`use_test_seed()`) makes every
generator in the process deterministic so all tests are reproducible. The
test seed can be overridden with $ORYX_TEST_SEED (reference: system property
`oryx.test.seed`, RandomManager.java:41).

Port note: a copy of ``oryx_tpu/common/rng.py`` (JAX-free), without ``get_key``
(which imports jax).
"""

from __future__ import annotations

import os
import secrets
import threading

import numpy as np

_TEST_SEED_ENV = "ORYX_TEST_SEED"
_DEFAULT_TEST_SEED = 1234

_lock = threading.Lock()
_test_seed: int | None = None
_counter = 0


def use_test_seed() -> None:
    """Switch to deterministic seeding for ALL subsequent generators."""
    global _test_seed, _counter
    with _lock:
        _test_seed = int(os.environ.get(_TEST_SEED_ENV, _DEFAULT_TEST_SEED))
        _counter = 0


def clear_test_seed() -> None:
    global _test_seed
    with _lock:
        _test_seed = None


def in_test_mode() -> bool:
    return _test_seed is not None


def next_seed() -> int:
    """Next raw seed: deterministic sequence in test mode, OS entropy else."""
    global _counter
    with _lock:
        if _test_seed is not None:
            _counter += 1
            return _test_seed + _counter - 1
        return secrets.randbits(63)


def get_random(seed: int | None = None) -> np.random.Generator:
    """A host-side generator (NumPy PCG64)."""
    return np.random.default_rng(next_seed() if seed is None else seed)

