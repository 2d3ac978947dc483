"""Plain implicit ALS (Hu, Koren and Volinsky 2008, with Spark MLlib's
semantics), the reference for the training cells.

For each row u of one side, given the other side's factors Y:

    c_ui - 1 = alpha * |r_ui|,  p_ui = 1 if r_ui > 0 else 0
    A_u = Y^T Y + sum_i (c_ui - 1) y_i y_i^T + lambda * I
    b_u = sum_i c_ui * p_ui * y_i,   x_u = A_u^-1 b_u

over the items i that u rated; rows with no rating stay zero. One
iteration solves every user, then every item. Item factors start at
0.1 * N(0, 1) from ``numpy.random.default_rng(init_seed)``, drawn as
float64 and rounded to float32.

Rows are grouped by degree into blocks padded to the block's largest
degree, each block's systems built with one batched product and solved by
Cholesky, all in float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import exact_float32

GATHER_ELEMS = 1 << 27  # elements of a block's gathered [rows, degree, k] factors
SYSTEM_ELEMS = 1 << 26  # elements of a block's [rows, k, k] systems


def initial_items(num_items: int, k: int, init_seed: int) -> np.ndarray:
    return 0.1 * np.random.default_rng(init_seed).standard_normal((num_items, k)).astype(
        np.float32
    )


class _Side:
    """One side's ratings, rows grouped into degree blocks on ``device``:
    per block (rows, neighbour ids, values, mask), each [rows, degree]."""

    def __init__(self, rows, cols, vals, num_rows: int, k: int, device):
        rows_t = torch.from_numpy(rows.astype(np.int64)).to(device)
        order = torch.argsort(rows_t, stable=True)
        cols_t = torch.from_numpy(cols.astype(np.int64)).to(device)[order]
        vals_t = torch.from_numpy(vals.astype(np.float32)).to(device)[order]
        deg_t = torch.bincount(rows_t, minlength=num_rows)
        start_t = torch.cumsum(deg_t, 0) - deg_t
        deg = deg_t.cpu().numpy()
        live = np.flatnonzero(deg)
        live = live[np.argsort(deg[live], kind="stable")]
        self.num_rows = num_rows
        self.blocks = []
        max_rows = max(1, SYSTEM_ELEMS // (k * k))
        at = 0
        while at < len(live):
            n = min(max_rows, len(live) - at)
            while n > 1 and n * int(deg[live[at + n - 1]]) * k > GATHER_ELEMS:
                n //= 2
            sel = torch.from_numpy(live[at : at + n]).to(device)
            slots = torch.arange(int(deg[live[at + n - 1]]), device=device)
            mask = slots[None, :] < deg_t[sel][:, None]
            pos = torch.where(mask, start_t[sel][:, None] + slots[None, :], 0)
            self.blocks.append((sel, torch.where(mask, cols_t[pos], 0),
                                torch.where(mask, vals_t[pos], 0.0), mask.to(torch.float32)))
            at += n


def _half_sweep(side: _Side, other: torch.Tensor, lam: float, alpha: float) -> torch.Tensor:
    k = other.shape[1]
    gram = other.T @ other
    ridge = lam * torch.eye(k, dtype=torch.float32, device=other.device)
    out = torch.zeros((side.num_rows, k), dtype=torch.float32, device=other.device)
    for rows, cols, vals, mask in side.blocks:
        f = other[cols] * mask[..., None]
        weight = alpha * vals.abs() * mask
        a = gram + torch.bmm((f * weight[..., None]).transpose(1, 2), f) + ridge
        rhs = ((1.0 + alpha * vals.abs()) * (vals > 0) * mask)[:, None, :]
        b = torch.bmm(rhs, f).transpose(1, 2)
        out[rows] = torch.cholesky_solve(b, torch.linalg.cholesky(a))[..., 0]
    return out


def train(user_idx, item_idx, values, num_users: int, num_items: int, k: int, lam: float,
          alpha: float, iterations: int, init_seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(X [num_users, k], Y [num_items, k]) after ``iterations`` iterations."""
    with exact_float32():
        users = _Side(user_idx, item_idx, values, num_users, k, device)
        items = _Side(item_idx, user_idx, values, num_items, k, device)
        y = torch.from_numpy(initial_items(num_items, k, init_seed)).to(device)
        x = None
        for _ in range(iterations):
            x = _half_sweep(users, y, lam, alpha)
            y = _half_sweep(items, x, lam, alpha)
        return x.cpu().numpy(), y.cpu().numpy()
