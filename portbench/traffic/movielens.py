"""Ratings at any MovieLens shape, drawn from a seed on the device.

The algorithm of chip_smoke.py's ``movielens_shape()`` (tools/
train_benchmark.py's generator at any size), run with PyTorch on the card
so that a 25M-rating set takes seconds rather than minutes of host numpy:
uniform users; items zipf(1.3) modulo the item count, drawn by the same
rejection method as numpy's ``Generator.zipf``; distinct pairs in random
order, drawing twice as many again until there are enough; a rank-8 taste
plus 0.35 noise mapped to 1-5 stars at the 10/30/60/85% quantiles. The
same distribution as the numpy generator's, not its draws.

``relabelled`` draws one such set from a fixed seed and gives it new user
and item ids and a new order from the run's seed: every run's set has the
same degrees, so the same packing and the same work, in another order.
"""

from __future__ import annotations

import numpy as np
import torch


def _zipf(count: int, a: float, gen: torch.Generator, device) -> torch.Tensor:
    """``count`` draws of Zipf(a) as float64 (exact integers below 2**53),
    by numpy's rejection method (Devroye, Non-Uniform Random Variate
    Generation, 1986, p. 551)."""
    am1, b = a - 1.0, 2.0 ** (a - 1.0)
    out = []
    left = count
    while left:
        n = int(left * 1.2) + 1024
        u = 1.0 - torch.rand(n, generator=gen, device=device, dtype=torch.float64)
        v = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x >= 1) & (x <= 2.0 ** 62) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        x = x[ok][:left]
        out.append(x)
        left -= len(x)
    return torch.cat(out)


def movielens_shape(num_users: int, num_items: int, nnz: int, seed: int, device="cuda"):
    """(user_idx int32, item_idx int32, stars float32) numpy arrays of
    ``nnz`` distinct (user, item) pairs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    r = 8
    xt = torch.randn((num_users, r), generator=gen, device=device, dtype=torch.float64)
    yt = torch.randn((num_items, r), generator=gen, device=device, dtype=torch.float64)
    xt, yt = xt / np.sqrt(r), yt / np.sqrt(r)
    draws = 2 * nnz
    while True:
        pop = torch.fmod(_zipf(draws, 1.3, gen, device), num_items).to(torch.int64)
        u = torch.randint(0, num_users, (draws,), generator=gen, device=device)
        key = torch.unique(u * num_items + pop)
        if len(key) >= nnz:
            break
        draws *= 2
    key = key[torch.randperm(len(key), generator=gen, device=device)[:nnz]]
    u, i = key // num_items, key % num_items
    raw = (xt[u] * yt[i]).sum(dim=1)
    raw += 0.35 * torch.randn(nnz, generator=gen, device=device, dtype=torch.float64)
    ordered = torch.sort(raw).values
    # numpy's default (linear) quantiles of raw at 10, 30, 60 and 85%
    at = torch.tensor([0.1, 0.3, 0.6, 0.85], dtype=torch.float64, device=device) * (nnz - 1)
    lo = torch.floor(at).to(torch.int64)
    hi = torch.clamp(lo + 1, max=nnz - 1)
    qs = ordered[lo] + (at - lo) * (ordered[hi] - ordered[lo])
    stars = 1.0 + torch.bucketize(raw, qs, right=True).to(torch.float32)
    return (u.to(torch.int32).cpu().numpy(), i.to(torch.int32).cpu().numpy(),
            stars.cpu().numpy())


def relabelled(num_users: int, num_items: int, nnz: int, data_seed: int, seed: int,
               device="cuda"):
    """``movielens_shape(..., data_seed)`` with its users, its items and its
    order permuted by ``seed``."""
    u, i, r = movielens_shape(num_users, num_items, nnz, data_seed, device)
    gen = np.random.default_rng(seed)
    users, items, order = (gen.permutation(num_users).astype(np.int32),
                           gen.permutation(num_items).astype(np.int32), gen.permutation(nnz))
    return users[u[order]], items[i[order]], r[order]
