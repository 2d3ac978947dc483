"""The yardstick's arithmetic: the card's peaks, the least time of a scan
and of a PyTorch op, and the operations and bytes of ALS and of a served
/recommend. Frozen here so that a change to the program cannot move it.

The peaks are one NVIDIA H100 SXM's published dense rates at its 700 W
limit. float32 work counts at 989/6 TFLOP/s: the fastest float32-accurate
product on this card is six bfloat16 tensor-core passes over three-piece
splits, which is how the port's float32 scan computes. A program change
that computes float32 in fewer passes needs a benchmark change to restate
that peak.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 989e12 / 6, "bfloat16": 989e12, "int8": 989e12}


def kernel_bound(dtype: str, b: int, kf: int, n: int, out_bytes: int) -> tuple[float, str]:
    """Least time in ms of a top-N scan of ``b`` queries over ``n`` items of
    ``kf`` features: the item plane at its dtype, the aux row (4 bytes an
    item), the queries and ``out_bytes`` moved once over the card's bytes
    per second, against 2*b*kf*n operations over the peak for the plane's
    type; the larger of the two, and which one it is."""
    item_bytes = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    moved = kf * n * item_bytes + 4 * n + 4 * b * kf + out_bytes
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * kf * n / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ops_bound(moved_bytes: float, operations: float) -> tuple[float, str]:
    """The larger of bytes over 3.35 TB/s and float32 operations over
    989/6 TFLOP/s, in ms, and which one it is."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = operations / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def als_gram_cost(nnz: int, rows_solved: int, num_users: int, num_items: int,
                  k: int) -> tuple[float, float]:
    """(bytes, operations) of one ALS iteration's gathers, normal equations
    and the two Gramians YtY and XtX (users' and items' half-sweeps): each
    rating's index, value and gathered factor read in both half-sweeps,
    each solved row's k x k system, right side and degree written once."""
    moved = nnz * 2 * (8 + 4 * k) + rows_solved * (4 + 4 * k * k + 4 * k)
    ops = 2 * nnz * 2 * (k * k + k) + 2 * 2 * (num_users + num_items) * k * k
    return float(moved), float(ops)


def als_solve_cost(rows_solved: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of one ALS iteration's batched Cholesky solves:
    each system and right side read once, the solution written once; a
    factorisation and two triangular solves."""
    return float(rows_solved * (4 * k * k + 8 * k)), float(rows_solved * 2 * k ** 3 / 3)


def als_model_flops(nnz: int, rows_u: int, rows_i: int, num_users: int, num_items: int,
                    k: int) -> float:
    """Model FLOPs of one ALS iteration, counted per half-sweep from the
    shapes: 2*nnz*k^2 for the rows' Gramians, rows*(k^3/3 + 4k^2) for the
    solves, 2*n_other*k^2 for the other side's Gramian."""
    flops = 0.0
    for rows, n_other in ((rows_u, num_items), (rows_i, num_users)):
        flops += 2.0 * nnz * k * k + rows * (k ** 3 / 3 + 4 * k * k) + 2.0 * n_other * k * k
    return flops


def recommend_flops(n_items: int, k: int) -> float:
    """Model FLOPs of one /recommend by an exact scan: one dot per item."""
    return 2.0 * n_items * k
