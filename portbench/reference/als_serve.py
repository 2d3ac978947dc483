"""Plain top-N recommendation, the reference for the serving cells: every
item's dot product with the user's factor, the user's known items left out,
the best ``how_many`` kept (Oryx's /recommend with considerKnownItems off),
in float32 with TF32 off."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import exact_float32

SCORE_ELEMS = 1 << 28  # elements of a block's [users, items] scores


def top_n(x_rows: np.ndarray, y: torch.Tensor, known: list[np.ndarray], how_many: int,
          served: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For each user row of ``x_rows`` (float32 [m, k]) against the items
    ``y`` (float32 [n, k], on the reference's device): the best
    ``how_many`` scores with ``known[j]`` left out, best first, and the
    reference's scores of the item rows ``served[j]`` (int64 [m, how_many],
    -1 where nothing was served: NaN there), known or not."""
    n = y.shape[0]
    step = max(1, SCORE_ELEMS // n)
    best, of_served = [], []
    with exact_float32():
        for s0 in range(0, len(x_rows), step):
            q = torch.from_numpy(np.ascontiguousarray(x_rows[s0 : s0 + step])).to(y.device)
            scores = q @ y.T
            rows = torch.from_numpy(served[s0 : s0 + step]).to(y.device)
            got = torch.gather(scores, 1, rows.clamp(min=0))
            of_served.append(torch.where(rows >= 0, got, torch.nan).cpu().numpy())
            for j, items in enumerate(known[s0 : s0 + step]):
                scores[j, torch.from_numpy(items.astype(np.int64)).to(y.device)] = -torch.inf
            best.append(torch.topk(scores, how_many, dim=1).values.cpu().numpy())
    return np.concatenate(best), np.concatenate(of_served)
