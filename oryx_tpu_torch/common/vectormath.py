"""Small host-side linear algebra: dot, norms, V^T V, and k x k solvers.

Rebuild of the reference's VectorMath (framework/oryx-common/src/main/java/
com/cloudera/oryx/common/math/VectorMath.java:27-110) and
LinearSystemSolver/Solver (.../math/LinearSystemSolver.java:28-70,
Solver.java:25-50): a pseudo-inverse solver over V^T V with a singularity
threshold of 1e-5, used on the ALS fold-in hot path in the speed and
serving layers. Device-side (batched, sharded) versions of these ops live
in oryx_tpu_torch.ops; these NumPy forms serve host-side per-request math where
a device round-trip would cost more than the flop count.

Port note: a copy of ``oryx_tpu/common/vectormath.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import numpy as np

SINGULARITY_THRESHOLD = 1.0e-5

__all__ = [
    "dot",
    "norm",
    "cosine_similarity",
    "transpose_times_self",
    "parse_vector",
    "random_vector_f",
    "Solver",
    "SingularMatrixSolverException",
    "get_solver",
]


class SingularMatrixSolverException(Exception):
    """Raised when V^T V is effectively singular (apparent rank deficiency).

    Mirrors SingularMatrixSolverException: carries the apparent rank so
    callers can log how degenerate the system is.
    """

    def __init__(self, apparent_rank: int, message: str = "") -> None:
        super().__init__(message or f"apparent rank {apparent_rank}")
        self.apparent_rank = apparent_rank


def dot(x: np.ndarray, y: np.ndarray) -> float:
    return float(np.dot(np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)))


def norm(x: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(x, dtype=np.float64)))


def cosine_similarity(x: np.ndarray, y: np.ndarray, norm_y: float | None = None) -> float:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    ny = norm(y) if norm_y is None else norm_y
    nx = norm(x)
    if nx == 0.0 or ny == 0.0:
        return 0.0
    return float(np.dot(x, y) / (nx * ny))


def transpose_times_self(vectors) -> np.ndarray | None:
    """V^T V over an iterable (or dict id->vector) of float vectors.

    Mirrors VectorMath.transposeTimesSelf (VectorMath.java:84-103): returns
    None for an empty collection.
    """
    if hasattr(vectors, "values"):
        vectors = vectors.values()
    vt = None
    count = 0
    rows = []
    for v in vectors:
        rows.append(np.asarray(v, dtype=np.float64))
        count += 1
    if count == 0:
        return None
    m = np.stack(rows)
    vt = m.T @ m
    return vt


def parse_vector(tokens) -> np.ndarray:
    return np.asarray([float(t) for t in tokens], dtype=np.float64)


def random_vector_f(features: int, rng: np.random.Generator) -> np.ndarray:
    """Random unit-normal float32 vector (VectorMath.randomVectorF)."""
    return rng.standard_normal(features).astype(np.float32)


class Solver:
    """Solves Ax=b for a fixed symmetric A = V^T V via pinv-style QR.

    Mirrors Solver (math/Solver.java): the decomposition is done once and
    reused across many right-hand sides (the fold-in hot path,
    ALSSpeedModel.getXTXSolver / ALSServingModel caching).
    """

    def __init__(self, a: np.ndarray) -> None:
        a = np.asarray(a, dtype=np.float64)
        # QR-based rank check with the reference's singularity threshold
        # (LinearSystemSolver.java:31,35-52).
        _, r = np.linalg.qr(a)
        diag = np.abs(np.diag(r))
        max_diag = diag.max() if diag.size else 0.0
        if max_diag == 0.0:
            raise SingularMatrixSolverException(0, "all-zero matrix")
        apparent_rank = int(np.sum(diag > SINGULARITY_THRESHOLD * max_diag))
        if apparent_rank < a.shape[0]:
            raise SingularMatrixSolverException(
                apparent_rank,
                f"apparent rank {apparent_rank} < dimension {a.shape[0]}",
            )
        self._a = a
        # Cholesky is valid since A is SPD once rank-checked; fall back to
        # lstsq on numerical failure.
        try:
            self._chol = np.linalg.cholesky(a)
        except np.linalg.LinAlgError:
            self._chol = None

    @property
    def matrix(self) -> np.ndarray:
        """The decomposed A = V^T V (for batched solves elsewhere)."""
        return self._a

    def solve_d_to_d(self, b: np.ndarray) -> np.ndarray:
        b = np.asarray(b, dtype=np.float64)
        if self._chol is not None:
            y = np.linalg.solve(self._chol, b)
            return np.linalg.solve(self._chol.T, y)
        return np.linalg.lstsq(self._a, b, rcond=None)[0]

    def solve_f_to_f(self, b: np.ndarray) -> np.ndarray:
        return self.solve_d_to_d(np.asarray(b, dtype=np.float64)).astype(np.float32)


def get_solver(a: np.ndarray | None) -> Solver | None:
    """LinearSystemSolver.getSolver: None in, None out."""
    if a is None:
        return None
    return Solver(a)
