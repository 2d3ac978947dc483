"""Random-forest training on one card: histogram-based level-wise growth
(counterpart of ``oryx_tpu/ops/forest.py``).

The replacement for Spark MLlib's RandomForest.trainClassifier/
trainRegressor used by the reference's RDFUpdate (app/oryx-app-mllib/...
/rdf/RDFUpdate.java:143-165). All nodes of one depth grow at once:

- inputs are pre-binned feature matrices ([n, p] small-int bin ids, the
  binning/bin-edge mapping lives in the app tier),
- one level = one pass producing the full [p, nodes, bins, stats]
  histogram tensor, from which cumulative sums over bins give every
  candidate split's left/right statistics, impurity gains are evaluated
  for all (node, feature, bin) candidates at once, and argmax picks each
  node's split,
- per-node feature subsampling (mtry) is a random mask over the gain
  tensor, bootstrap resampling is Poisson(1) example weights,
- trees come out as flat heap arrays (node i's children at 2i+1/2i+2)
  that the app tier converts to portable DecisionTree objects.

Histogram formulations (docs/batch-trainers.md), chosen per level by
``formulation()``:

- **matmul**: one dense contraction ``A.T @ onehot(bins)`` with
  ``A[n, L*S] = onehot(node) ⊗ (w * chan)``, taken when the level's
  FLOP and one-hot footprint fit a budget (shallow levels). It runs in
  full float32 (TF32 off for the product): with TF32, y and y² would
  round to a 10-bit mantissa and the regression stats would move.
- **scalar**: classification folds the class channel into the segment id
  (``seg = (node*B + bin)*C + class``), so the scatter moves one scalar
  weight per (row, feature): one ``index_add_`` per tree over all
  features at once, its segment ids in int32 where they fit.
- **reference**: the per-feature vector segment-sum, kept as the
  equivalence baseline for tests.

All formulations produce the same [p, L, B, S] tensor. For
classification every entry is a sum of integer Poisson weights, exact in
float32 below 2^24, so the card's histograms equal the CPU's bit for bit
whatever order the atomics add in; regression's (w, w*y, w*y²) channels
are not exact and move with the summation order.

On the CPU ``train_forest`` takes a host path: per-(tree, level)
``np.bincount`` histograms over only the **live** nodes of the level
(children of the previous level's splits), with the split selection
running through the same torch functions the device path uses. Both
paths draw the identical random stream on the host, so on a seed they
grow identical forests (but for near ties, below).

Port notes:
- The JAX package runs all of this through XLA (no Pallas kernel); here
  it is PyTorch ops on one card. The ``jax.jit`` / ``static_argnums``
  plumbing (``_grow_level_trees``, the jitted ``_eval_group_hists``)
  existed only for XLA's compile cache and has no counterpart; the
  ``lax.scan`` over trees is a Python loop over the chunk's trees.
- ``mesh`` raises NotYetPortedError: the row-sharded level pass
  (``_grow_level_trees_mesh``) comes with multi-GPU.
- The last bit of ``log``: the card's ``logf`` and the CPU's may differ
  by one ulp, so two candidates with different statistics whose entropy
  gains agree to about 1e-7 may be ordered differently on the card and
  on the CPU (as XLA's and numpy's may, in the JAX package). Exact ties
  are not at risk: equal statistics give equal gains on each device, and
  the lowest ``feature * num_bins + bin`` flat index wins on both
  (``torch.argmax`` returns the first maximum). ``node_top_gains``
  recomputes a node's two best candidates, to tell such a near tie from
  a fault.
- ``train_forest`` syncs once per level, as the reference does: the loop
  reads the level's split features to decide whether to go deeper. The
  other outputs are fetched at the end of each tree chunk.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, ContextManager

import numpy as np
import torch

from oryx_tpu_torch import NotYetPortedError
from oryx_tpu_torch.common import rng as rng_mod
from oryx_tpu_torch.device import resolve

# cap on one tree chunk's per-tree device-resident rows (weights+routing)
_TREE_CHUNK_BUDGET_BYTES = 1 << 30

# dense-matmul histogram budget: FLOPs of the one contraction, and
# elements of the materialized one-hots (the [n, p*B] bin one-hot is the
# big one). Above either bound the scalar/vector segment path takes over.
_MM_FLOP_BUDGET = float(1 << 32)
_MM_ELEM_BUDGET = float(1 << 28)

# wall seconds of the most recent train_forest call, split by phase
# ({"init": s, "iterate": s}: host setup vs the upload, the level loop
# and the read-back). Overwritten per call, never merged.
last_phase_seconds: dict[str, float] = {}


@dataclass
class ForestArrays:
    """Flat heap-layout forest. -1 split_feature = leaf."""

    split_feature: np.ndarray  # [T, max_nodes] int32
    split_bin: np.ndarray  # [T, max_nodes] int32 (negative branch: bin <= split_bin)
    node_stats: np.ndarray  # [T, max_nodes, S] per-node class counts / (w, wy, wyy)
    node_counts: np.ndarray  # [T, max_nodes] weighted example counts
    gains: np.ndarray  # [T, max_nodes] impurity decrease of each split
    num_classes: int | None  # None = regression

    @property
    def num_trees(self) -> int:
        return self.split_feature.shape[0]


def _no_stage(_name: str) -> ContextManager:
    return contextlib.nullcontext()


def _impurity(stats: torch.Tensor, total: torch.Tensor, kind: str) -> torch.Tensor:
    """stats [..., S], total [...] -> impurity [...]."""
    if kind == "variance":
        w, wy, wyy = stats[..., 0], stats[..., 1], stats[..., 2]
        mean = wy / w.clamp(min=1e-12)
        return (wyy / w.clamp(min=1e-12) - mean * mean).clamp(min=0.0)
    p = stats / total[..., None].clamp(min=1e-12)
    if kind == "gini":
        return 1.0 - (p * p).sum(dim=-1)
    # entropy in nats (reference: min-info-gain-nats)
    return -torch.where(p > 0, p * torch.log(p), 0.0).sum(dim=-1)


def formulation(n: int, p: int, s: int, num_level_nodes: int, num_bins: int,
                impurity: str, hist_mode: str) -> str:
    """The histogram formulation one level takes: "matmul", "scalar" or
    "vector" (the reference scan; also regression's segment path)."""
    if hist_mode == "reference":
        return "vector"
    mm_flops = 2.0 * n * num_level_nodes * s * p * num_bins
    mm_elems = float(n) * (p * num_bins + num_level_nodes * s)
    if hist_mode == "matmul" or (
        hist_mode == "auto" and mm_flops <= _MM_FLOP_BUDGET and mm_elems <= _MM_ELEM_BUDGET
    ):
        return "matmul"
    return "vector" if impurity == "variance" else "scalar"


@contextlib.contextmanager
def _full_float32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _level_histograms(
    binned,  # [n, p] int32
    w_act,  # [n] float32 example weights, 0 for inactive rows
    y_cls,  # [n] int32 class ids (zeros for regression)
    chan,  # [n, S] float32 per-example stat basis (onehot(y) / (1, y, y^2))
    pos_c,  # [n] int64 clamped node position within the level
    num_level_nodes: int,
    num_bins: int,
    impurity: str,
    hist_mode: str,
) -> torch.Tensor:
    """All (feature, node, bin, stat) sums for one level: [p, L, B, S]."""
    n, p = binned.shape
    s = chan.shape[1]
    L, B = num_level_nodes, num_bins
    how = formulation(n, p, s, L, B, impurity, hist_mode)
    if how == "matmul":
        # ONE dense contraction: A[n, L*S] carries each row's weighted stat
        # channels at its node's slot, the bin one-hot [n, p*B] carries its
        # bin slot per feature, and A.T @ onehot yields every (node, stat,
        # feature, bin) sum.
        nh = torch.nn.functional.one_hot(pos_c, L).to(torch.float32) * w_act[:, None]
        a = (nh[:, :, None] * chan[:, None, :]).reshape(n, L * s)
        ohb = torch.nn.functional.one_hot(binned.long(), B).to(torch.float32).reshape(n, p * B)
        with _full_float32():
            h = a.T @ ohb
        return h.reshape(L, s, p, B).permute(2, 0, 3, 1)  # [p, L, B, S]
    if how == "scalar":
        # classification: fold the class channel into the segment id so
        # each (row, feature) scatters ONE scalar, not an S-vector; all
        # features in one scatter, feature f's segments at f * L*B*S
        size = L * B * s
        idt = torch.int32 if p * size < 2**31 else torch.int64
        base = (pos_c * (B * s) + y_cls).to(idt)
        offs = torch.arange(p, dtype=idt, device=binned.device) * size
        seg = base[:, None] + binned.to(idt) * s + offs[None, :]
        h = torch.zeros(p * size, dtype=torch.float32, device=binned.device)
        h.index_add_(0, seg.reshape(-1), w_act[:, None].expand(n, p).reshape(-1))
        return h.view(p, L, B, s)
    w_stats = chan * w_act[:, None]  # [n, S]
    out = torch.zeros((p, L * B, s), dtype=torch.float32, device=binned.device)
    base = pos_c * B
    for f in range(p):
        out[f].index_add_(0, base + binned[:, f], w_stats)
    return out.view(p, L, B, s)


def _candidate_gains(
    hists,  # [p, L, B, S] histograms; B may be trimmed below num_bins_total
    node_tot,  # [L, S] per-node totals (shared across feature groups)
    impurity: str,
    min_node_size: float,  # a float32 value
    num_bins_total: int,  # GLOBAL bin count: candidate bin num_bins-1 is
    # "everything left" and never a real split, even when B is trimmed
) -> torch.Tensor:
    """Impurity gain of every (feature, node, bin) candidate: [p, L, B],
    -inf where the candidate is invalid (child below min_node_size, or
    the all-left last bin)."""
    num_bins = hists.shape[2]

    # weighted example count: regression carries it in channel 0; for
    # classification it is the sum of the per-class channels
    def _count(stats):
        if impurity == "variance":
            return stats[..., 0]
        return stats.sum(dim=-1)

    left = torch.cumsum(hists, dim=2)  # [p, L, B, S] stats for bin <= b
    right = node_tot[None, :, None, :] - left
    tot_cnt = _count(node_tot)  # [L]
    l_cnt = _count(left)
    r_cnt = _count(right)

    parent_imp = _impurity(node_tot, tot_cnt, impurity)  # [L]
    l_imp = _impurity(left, l_cnt, impurity)
    r_imp = _impurity(right, r_cnt, impurity)
    tot_safe = tot_cnt.clamp(min=1e-12)
    gain = parent_imp[None, :, None] - (l_cnt * l_imp + r_cnt * r_imp) / tot_safe[None, :, None]

    valid = (l_cnt >= min_node_size) & (r_cnt >= min_node_size)
    # last candidate bin (B-1) sends everything left: never a real split
    bins = torch.arange(num_bins, device=hists.device)
    valid = valid & (bins[None, None, :] < num_bins_total - 1)
    return torch.where(valid, gain, float("-inf"))


def _best_of(g: torch.Tensor):
    """argmax over the (feature, bin) candidate axes: g [p, L, B] ->
    (flat index [L], gain [L]); flat = f_local * B + bin. Ties go to the
    lowest flat index (torch.argmax returns the first maximum)."""
    p, num_level_nodes, num_bins = g.shape
    flat = g.permute(1, 0, 2).reshape(num_level_nodes, p * num_bins)
    best = torch.argmax(flat, dim=1)
    return best, flat.gather(1, best[:, None])[:, 0]


def _masked_gains(hists, node_tot, feat_mask, allowed_mask, impurity, min_node_size,
                  num_bins_total):
    """(masked, all) candidate gains [p, L, B]: the mtry-sampled features,
    and every feature splits may ever use."""
    gain = _candidate_gains(hists, node_tot, impurity, min_node_size, num_bins_total)
    # excluded features (id/ignored/target columns) are out of bounds for
    # the mtry-widening fallback too, not just for the sampled mask
    gain_all = torch.where(allowed_mask[:, None, None] > 0, gain, float("-inf"))
    gain_masked = torch.where(feat_mask.T[:, :, None] > 0, gain_all, float("-inf"))
    return gain_masked, gain_all


def _level_splits_from_hists(
    hists,  # [p, L, B, S] histogram tensor
    feat_mask,  # [L, p] float32 1/0 mtry mask
    allowed_mask,  # [p] float32 1/0: features splits may EVER use
    impurity: str,
    min_node_size: float,  # float32 values
    min_info_gain: float,
    is_last_level: bool,
):
    """Split selection for one level from its histograms: returns
    (split_feature [L], split_bin [L], gain [L], node_tot [L, S])."""
    p, num_level_nodes, num_bins, _s = hists.shape
    node_tot = hists[0].sum(dim=1)  # [L, S] (same for every feature)

    gain_masked, gain_all = _masked_gains(
        hists, node_tot, feat_mask, allowed_mask, impurity, min_node_size, num_bins
    )
    # prefer the mtry-sampled features; when none of them admits a valid
    # split, keep looking among all features (sklearn max_features
    # semantics: the search widens until a valid partition is found)
    best_m, gain_m = _best_of(gain_masked)
    best_a, gain_a = _best_of(gain_all)
    use_masked = gain_m > min_info_gain
    best = torch.where(use_masked, best_m, best_a)
    best_gain = torch.where(use_masked, gain_m, gain_a)
    best_feat = (best // num_bins).to(torch.int32)
    best_bin = (best % num_bins).to(torch.int32)

    do_split = (best_gain > min_info_gain) & torch.isfinite(best_gain)
    if is_last_level:
        do_split = torch.zeros_like(do_split)
    split_feature = torch.where(do_split, best_feat, -1)
    split_bin = torch.where(do_split, best_bin, -1)
    return split_feature, split_bin, torch.where(do_split, best_gain, 0.0), node_tot


def _grow_level_impl(
    binned,  # [n, p] int32
    y_cls,  # [n] int32 class ids (zeros for regression)
    chan,  # [n, S] float32 per-example stat basis (shared by every tree)
    w_ex,  # [n] float32 per-tree example weights
    node_of,  # [n] int32 heap index or -1 (inactive)
    feat_mask,  # [L, p] float32 1/0 mtry mask for this level
    allowed_mask,  # [p] float32 1/0: features splits may EVER use
    level_start: int,  # heap index of first node at this depth (2^d - 1)
    num_level_nodes: int,  # L = 2^d
    num_bins: int,  # B
    impurity: str,
    min_node_size: float,
    min_info_gain: float,
    is_last_level: bool,
    hist_mode: str = "auto",
    stage: Callable[[str], ContextManager] = _no_stage,
):
    """Returns (split_feature [L], split_bin [L], gain [L], node_tot [L,S],
    new_node_of [n]). ``stage(name)`` wraps the "histograms", "splits"
    and "routing" work, for timing."""
    with stage("histograms"):
        pos = node_of - level_start  # position within level; <0 or >=L = inactive
        active = (pos >= 0) & (pos < num_level_nodes)
        pos_c = torch.where(active, pos, 0).long()
        w_act = torch.where(active, w_ex, 0.0)
        hists = _level_histograms(
            binned, w_act, y_cls, chan, pos_c, num_level_nodes, num_bins,
            impurity, hist_mode,
        )
    with stage("splits"):
        split_feature, split_bin, gains, node_tot = _level_splits_from_hists(
            hists, feat_mask, allowed_mask, impurity,
            min_node_size, min_info_gain, is_last_level,
        )
    with stage("routing"):
        # route examples: children heap indices; leaves freeze at -(heap+2)
        node_heap = (pos_c + level_start).to(torch.int32)
        ex_feat = split_feature[pos_c]
        ex_bin = split_bin[pos_c]
        ex_split = (ex_feat >= 0) & active
        col = binned.gather(1, ex_feat.clamp(min=0).long()[:, None])[:, 0]
        child = 2 * node_heap + 1 + (col > ex_bin).to(torch.int32)
        new_node_of = torch.where(
            ex_split, child, torch.where(active, -node_heap - 2, node_of)
        )
    # inactive-but-was-active encode as -(heap+2) so final leaf is recoverable
    return split_feature, split_bin, gains, node_tot, new_node_of


def _grow_level_trees_impl(
    binned,  # [n, p] int32 (shared by every tree)
    y_cls,  # [n] int32 (shared)
    chan,  # [n, S] float32 (shared)
    w_t,  # [T, n] per-tree example weights
    node_t,  # [T, n] per-tree heap index or -1
    mask_t,  # [T, L, p] per-tree mtry masks for this level
    allowed_mask,  # [p] float32, shared by every tree
    level_start: int,
    num_level_nodes: int,
    num_bins: int,
    impurity: str,
    min_node_size: float,
    min_info_gain: float,
    is_last_level: bool,
    hist_mode: str = "auto",
    stage: Callable[[str], ContextManager] = _no_stage,
):
    """Whole-chunk level pass: every tree of the chunk advances one depth,
    one tree's [p, L, B, S] histogram at a time (the reference's lax.scan
    over the tree axis)."""
    outs = [
        _grow_level_impl(
            binned, y_cls, chan, w_t[t], node_t[t], mask_t[t], allowed_mask,
            level_start, num_level_nodes, num_bins, impurity, min_node_size,
            min_info_gain, is_last_level, hist_mode, stage,
        )
        for t in range(w_t.shape[0])
    ]
    # (sf [T,L], sb [T,L], gain [T,L], node_tot [T,L,S], node_of [T,n])
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _eval_group_hists(hists, node_tot, feat_mask, allowed_mask, mins,
                      impurity: str, num_bins_total: int):
    """Candidate scoring for the host path, on the CPU through the same
    torch functions the device path runs, evaluated per feature GROUP:
    features of equal bin width share a trimmed [pg, L, width, S] tensor,
    so a mostly-binary feature set (e.g. one-hot categoricals next to a
    few 32-bin numerics) skips the ~75% of the dense candidate grid that
    is structurally empty. numpy in, numpy out: (best_m, gain_m, best_a,
    gain_a)."""
    gain_masked, gain_all = _masked_gains(
        torch.from_numpy(np.ascontiguousarray(hists)),
        torch.from_numpy(np.ascontiguousarray(node_tot)),
        torch.from_numpy(feat_mask),
        torch.from_numpy(np.ascontiguousarray(allowed_mask)),
        impurity, float(mins[0]), num_bins_total,
    )
    best_m, gain_m = _best_of(gain_masked)
    best_a, gain_a = _best_of(gain_all)
    return best_m.numpy(), gain_m.numpy(), best_a.numpy(), gain_a.numpy()


def _host_level_hists(
    binned_T,  # [p, n] int32 (row-major per feature)
    w,  # [n] float32 weights with inactive rows zeroed is NOT required:
    #   inactive rows are routed to the trash slot below instead
    y_cls,  # [n] int32 (classification) — class folded into the bin id
    ybase,  # (y, y*y) float arrays for regression, else None
    compact,  # [n] int64 live-node slot per row; == trash for dead rows
    num_slots: int,  # live slots incl. pow2 padding (trash slot excluded)
    num_bins: int,
    s: int,
) -> np.ndarray:
    """np.bincount histograms [p, num_slots, B, S] for one (tree, level).

    One weighted bincount per (feature, channel): exact for
    classification (integer Poisson weights accumulate exactly in
    float64)."""
    p = binned_T.shape[0]
    b = num_bins
    size = (num_slots + 1) * b  # +1 = trash slot for dead/frozen rows
    if ybase is None:
        base = compact * (b * s) + y_cls
        out = np.empty((p, num_slots + 1, b, s), np.float32)
        for f in range(p):
            seg = base + binned_T[f] * s
            out[f] = np.bincount(seg, weights=w, minlength=size * s).reshape(
                num_slots + 1, b, s
            )
    else:
        base = compact * b
        out = np.empty((p, num_slots + 1, b, s), np.float32)
        chans = (w, w * ybase[0], w * ybase[1])
        for f in range(p):
            seg = base + binned_T[f]
            for c in range(3):
                out[f, :, :, c] = np.bincount(
                    seg, weights=chans[c], minlength=size
                ).reshape(num_slots + 1, b)
    return out[:, :num_slots]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class _Draws:
    """The trainer's random stream, drawn on the host from one
    ``np.random.default_rng(seed)`` in a fixed order: each chunk's Poisson
    bootstrap weights, then one mtry mask per dispatched level. The tree
    chunk size and the chunk-wide early exit decide how many masks are
    drawn, so both paths (and ``node_top_gains``' replay) keep them."""

    def __init__(self, gen, num_trees: int, n: int, p: int, allowed: np.ndarray, mtry: int):
        self.gen, self.num_trees, self.n, self.p = gen, num_trees, n, p
        self.allowed, self.mtry = allowed, mtry

    def chunk_weights(self, t0: int, t1: int) -> np.ndarray:
        # drawn per chunk (in order, so the sequence matches an up-front
        # [num_trees, n] draw) to keep peak weight memory chunk-bounded
        if self.num_trees > 1:
            return self.gen.poisson(1.0, (t1 - t0, self.n)).astype(np.float32)
        return np.ones((1, self.n), np.float32)

    def level_masks(self, t0: int, t1: int, num_level: int) -> np.ndarray:
        # per-node mtry masks, vectorized: one uniform key per allowed
        # column, smallest-m keys win — a uniform random m-subset per node
        pa = len(self.allowed)
        m = min(self.mtry, pa)
        mask_t = np.zeros((t1 - t0, num_level, self.p), dtype=np.float32)
        if m >= pa:
            mask_t[:, :, self.allowed] = 1.0
        else:
            keys = self.gen.random((t1 - t0, num_level, pa), dtype=np.float32)
            pick = np.argpartition(keys, m, axis=2)[:, :, :m]
            np.put_along_axis(
                mask_t.reshape((t1 - t0) * num_level, self.p),
                self.allowed[pick].reshape((t1 - t0) * num_level, m),
                1.0,
                axis=1,
            )
        return mask_t


@dataclass
class _Setup:
    binned: np.ndarray  # [n, p] int32
    y_cls: np.ndarray  # [n] int32
    chan_base: np.ndarray  # [n, S] float32
    imp_kind: str
    allowed_vec: np.ndarray  # [p] float32
    draws: _Draws
    tc: int  # trees per chunk


def _setup(binned, targets, num_classes, num_trees, impurity, mtry, seed,
           exclude_features) -> _Setup:
    binned = np.asarray(binned, dtype=np.int32)
    n, p = binned.shape
    allowed = np.asarray(
        sorted(set(range(p)) - (exclude_features or set())), dtype=np.int64
    )
    if len(allowed) == 0:
        raise ValueError("no usable features")
    allowed_vec = np.zeros(p, dtype=np.float32)
    allowed_vec[allowed] = 1.0
    if num_classes is None:
        y = np.asarray(targets, dtype=np.float32)
        chan_base = np.stack([np.ones(n, np.float32), y, y * y], axis=1)
        y_cls = np.zeros(n, dtype=np.int32)
        imp_kind = "variance"
    else:
        y_cls = np.asarray(targets, dtype=np.int32)
        chan_base = np.eye(num_classes, dtype=np.float32)[y_cls]
        imp_kind = impurity
    pa = len(allowed)
    if mtry is None:
        mtry = max(1, int(np.sqrt(pa)) if num_classes is not None else max(1, pa // 3))
    gen = np.random.default_rng(rng_mod.next_seed() if seed is None else seed)
    # Trees batch into chunks whose per-tree [tc, n] weight/routing tensors
    # stay under a fixed budget. One chunk covers every packaged config.
    tc = max(1, min(num_trees, int(_TREE_CHUNK_BUDGET_BYTES) // max(1, n * 8)))
    return _Setup(binned, y_cls, chan_base, imp_kind, allowed_vec,
                  _Draws(gen, num_trees, n, p, allowed, mtry), tc)


def train_forest(
    binned: np.ndarray,
    targets: np.ndarray,
    num_bins: int,
    num_classes: int | None,
    num_trees: int = 20,
    max_depth: int = 8,
    min_node_size: float = 1.0,
    min_info_gain: float = 0.0,
    impurity: str = "entropy",
    mtry: int | None = None,
    seed: int | None = None,
    exclude_features: set[int] | None = None,
    mesh=None,
    hist_mode: str = "auto",
    host_hist: bool | None = None,
    device=None,
    stage: Callable[[str], ContextManager] | None = None,
) -> ForestArrays:
    """Train ``num_trees`` trees over pre-binned features on ``device``
    (default: the card). Columns in ``exclude_features`` (e.g. the
    target's predictor slot) are never sampled for splitting.

    ``hist_mode`` picks the device histogram formulation: "auto" (dense
    one-hot matmul when the level fits the FLOP budget, else the scalar/
    vector segment path), "matmul", "scalar", or "reference" (the
    per-feature vector scan, kept for equivalence tests).
    ``host_hist`` forces the host np.bincount path on or off; by default
    it is on when the device is the CPU. Both paths consume the identical
    random stream and run split selection through the same torch
    functions. ``stage(name)`` wraps each tree-level's "histograms",
    "splits" and "routing" work on the device path, for timing. ``mesh``
    is not ported (NotYetPortedError)."""
    t_init = time.perf_counter()
    if mesh is not None:
        raise NotYetPortedError(
            "random-forest training over a device mesh is not yet ported to oryx_tpu_torch"
        )
    dev = resolve(device)
    st = _setup(binned, targets, num_classes, num_trees, impurity, mtry, seed,
                exclude_features)
    n, p = st.binned.shape
    s_chan = st.chan_base.shape[1]
    max_nodes = 2 ** (max_depth + 1) - 1
    t_feat = np.full((num_trees, max_nodes), -1, dtype=np.int32)
    t_bin = np.full((num_trees, max_nodes), -1, dtype=np.int32)
    t_stats = np.zeros((num_trees, max_nodes, s_chan), dtype=np.float64)
    t_counts = np.zeros((num_trees, max_nodes), dtype=np.float64)
    t_gains = np.zeros((num_trees, max_nodes), dtype=np.float64)
    out = ForestArrays(t_feat, t_bin, t_stats, t_counts, t_gains, num_classes)
    if host_hist is None:
        host_hist = dev.type == "cpu"

    t_iter = time.perf_counter()
    if host_hist:
        _train_host_chunks(
            st.binned, st.y_cls, st.chan_base, num_classes, st.allowed_vec, num_bins,
            st.imp_kind, min_node_size, min_info_gain, max_depth, num_trees, st.tc,
            st.draws.chunk_weights, st.draws.level_masks,
            t_feat, t_bin, t_stats, t_counts, t_gains,
        )
    else:
        _train_device_chunks(st, dev, num_bins, min_node_size, min_info_gain, max_depth,
                             num_trees, hist_mode, stage or _no_stage, out)
    last_phase_seconds.clear()
    last_phase_seconds.update(init=t_iter - t_init, iterate=time.perf_counter() - t_iter)
    return out


def _train_device_chunks(st: _Setup, dev, num_bins, min_node_size, min_info_gain,
                         max_depth, num_trees, hist_mode, stage, out: ForestArrays):
    """The device level loop: the chunk's whole forest advances one depth
    per pass, the level's splits are read back (the one sync per level)
    and the loop exits as soon as no node anywhere can still split: an
    all-leaf level is never dispatched."""
    binned_dev = torch.from_numpy(st.binned).to(dev)  # uploaded once, reused every level
    y_dev = torch.from_numpy(st.y_cls).to(dev)
    chan_dev = torch.from_numpy(st.chan_base).to(dev)
    allowed_dev = torch.from_numpy(st.allowed_vec).to(dev)
    mins = float(np.float32(min_node_size)), float(np.float32(min_info_gain))
    for t0 in range(0, num_trees, st.tc):
        t1 = min(t0 + st.tc, num_trees)
        w_c = st.draws.chunk_weights(t0, t1)
        w_dev = torch.from_numpy(w_c).to(dev)
        node_dev = torch.where(w_dev > 0, 0, -1).to(torch.int32)  # [tc, n]
        level_out = []
        for depth in range(max_depth + 1):
            level_start = 2**depth - 1
            num_level = 2**depth
            mask_t = torch.from_numpy(st.draws.level_masks(t0, t1, num_level)).to(dev)
            sf, sb, gains, node_tot, node_dev = _grow_level_trees_impl(
                binned_dev, y_dev, chan_dev, w_dev, node_dev, mask_t, allowed_dev,
                level_start, num_level, num_bins, st.imp_kind, mins[0], mins[1],
                depth == max_depth, hist_mode, stage,
            )
            level_out.append((level_start, num_level, sf, sb, gains, node_tot))
            # exact level-wise early exit: no split at this level means
            # every deeper level is all-leaf — don't dispatch it
            if not bool((sf >= 0).any()):
                break
        for level_start, num_level, sf, sb, gains, node_tot in level_out:
            sl = slice(level_start, level_start + num_level)
            node_tot = node_tot.cpu().numpy()  # [tc, L, S]
            out.split_feature[t0:t1, sl] = sf.cpu().numpy()
            out.split_bin[t0:t1, sl] = sb.cpu().numpy()
            out.node_stats[t0:t1, sl] = node_tot
            out.node_counts[t0:t1, sl] = (
                node_tot[..., 0] if out.num_classes is None else node_tot.sum(axis=2)
            )
            out.gains[t0:t1, sl] = gains.cpu().numpy()


def _train_host_chunks(
    binned, y_cls, chan_base, num_classes, allowed_vec, num_bins,
    imp_kind, min_node_size, min_info_gain, max_depth, num_trees, tc,
    chunk_weights, level_masks,
    t_feat, t_bin, t_stats, t_counts, t_gains,
):
    """Host level loop (the CPU): np.bincount histograms restricted to each
    tree's LIVE nodes — the children of the previous level's splits — with
    split selection through the same torch functions as the device path.
    Mirrors the device path's RNG consumption exactly (same weight/mask
    draw schedule, same chunk-wide level-loop exit), so both paths grow
    identical forests on a seed."""
    n, p = binned.shape
    s = chan_base.shape[1]
    if num_classes is None:
        ybase = (chan_base[:, 1].astype(np.float64), chan_base[:, 2].astype(np.float64))
        y64 = None
    else:
        ybase = None
        y64 = y_cls.astype(np.int64)
    mins = (np.float32(min_node_size), np.float32(min_info_gain))

    # group features by occupied bin width (rounded up to a power of two):
    # binary/one-hot columns score over a 2-bin candidate axis instead of
    # the full num_bins one
    nb_f = binned.max(axis=0).astype(np.int64) + 1
    pow2 = 2 ** np.ceil(np.log2(np.maximum(nb_f, 2))).astype(np.int64)
    widths = np.minimum(pow2, num_bins)
    groups = []  # (width, feats ascending, [pg, n] binned.T slice)
    for width in sorted(set(widths.tolist())):
        feats = np.nonzero(widths == width)[0]
        groups.append((int(width), feats, np.ascontiguousarray(binned[:, feats].T)))
    # node totals come from feature 0's histogram (first slot of its group:
    # feats are ascending, so feature 0 is slot 0 when present)
    g0 = next(i for i, (wd, _, _) in enumerate(groups) if wd == widths[0])

    for t0 in range(0, num_trees, tc):
        t1 = min(t0 + tc, num_trees)
        w_c = chunk_weights(t0, t1)
        node_c = np.where(w_c > 0, 0, -1).astype(np.int32)  # [tc, n]
        w64 = w_c.astype(np.float64)
        # per-tree live-node heap positions for the CURRENT level
        alive = [np.array([0], dtype=np.int64) for _ in range(t1 - t0)]
        for depth in range(max_depth + 1):
            level_start = 2**depth - 1
            num_level = 2**depth
            mask_t = level_masks(t0, t1, num_level)
            any_split = False
            for ti in range(t1 - t0):
                alive_pos = alive[ti]
                la = len(alive_pos)
                if la == 0:
                    continue
                lp = _pow2_at_least(la)  # pad slots, as the reference's jit shapes
                inv = np.full(num_level, lp, dtype=np.int64)
                inv[alive_pos] = np.arange(la)
                pos = node_c[ti].astype(np.int64) - level_start
                in_level = (pos >= 0) & (pos < num_level)
                compact = np.where(in_level, inv[np.where(in_level, pos, 0)], lp)
                group_hists = [
                    _host_level_hists(bt, w64[ti], y64, ybase, compact, lp, wd, s)
                    for wd, _, bt in groups
                ]
                node_tot = group_hists[g0][0].sum(axis=1)  # [lp, S]
                # score each group's trimmed candidate grid on the shared
                # gain functions, then merge: max gain wins, ties go to the
                # lowest (feature * num_bins + bin) flat index — exactly
                # the device path's single flat argmax
                cand = []  # (gain_m, flat_m, gain_a, flat_a) per group
                for (wd, feats, _), gh in zip(groups, group_hists):
                    fm = np.zeros((lp, len(feats)), np.float32)
                    fm[:la] = mask_t[ti, alive_pos][:, feats]
                    bm, gm, ba, ga = _eval_group_hists(
                        gh, node_tot, fm, allowed_vec[feats], mins,
                        imp_kind, num_bins,
                    )
                    flat_m = feats[bm // wd] * num_bins + bm % wd
                    flat_a = feats[ba // wd] * num_bins + ba % wd
                    cand.append((gm, flat_m, ga, flat_a))

                def _merge(gs, flats):
                    g = np.stack(gs)  # [G, lp]
                    f = np.stack(flats)
                    top = g.max(axis=0)
                    return top, np.where(g == top, f, np.iinfo(np.int64).max).min(axis=0)

                gain_m, flat_m = _merge([c[0] for c in cand], [c[1] for c in cand])
                gain_a, flat_a = _merge([c[2] for c in cand], [c[3] for c in cand])
                use_masked = gain_m > mins[1]
                best_gain = np.where(use_masked, gain_m, gain_a)
                best_flat = np.where(use_masked, flat_m, flat_a)
                do_split = (best_gain > mins[1]) & np.isfinite(best_gain)
                if depth == max_depth:  # the device path's is_last_level
                    do_split[:] = False
                sf = np.where(do_split, best_flat // num_bins, -1).astype(np.int32)
                sb = np.where(do_split, best_flat % num_bins, -1).astype(np.int32)
                gains = np.where(do_split, best_gain, 0.0)
                heap = level_start + alive_pos
                t_feat[t0 + ti, heap] = sf[:la]
                t_bin[t0 + ti, heap] = sb[:la]
                t_stats[t0 + ti, heap] = node_tot[:la]
                t_counts[t0 + ti, heap] = (
                    node_tot[:la, 0] if num_classes is None else node_tot[:la].sum(axis=1)
                )
                t_gains[t0 + ti, heap] = gains[:la]
                # route rows: split rows descend, the rest freeze
                full_sf = np.full(num_level, -1, np.int32)
                full_sf[alive_pos] = sf[:la]
                full_sb = np.full(num_level, -1, np.int32)
                full_sb[alive_pos] = sb[:la]
                pos_c = np.where(in_level, pos, 0)
                ex_feat = full_sf[pos_c]
                ex_bin = full_sb[pos_c]
                ex_split = (ex_feat >= 0) & in_level
                node_heap = (pos_c + level_start).astype(np.int32)
                goes_pos = binned[np.arange(n), np.maximum(ex_feat, 0)] > ex_bin
                child = 2 * node_heap + 1 + goes_pos.astype(np.int32)
                node_c[ti] = np.where(
                    ex_split, child, np.where(in_level, -node_heap - 2, node_c[ti])
                )
                split_heap = heap[sf[:la] >= 0]
                if len(split_heap):
                    any_split = True
                    alive[ti] = np.sort(
                        np.concatenate([2 * split_heap + 1, 2 * split_heap + 2])
                    ) - (2 ** (depth + 1) - 1)
                else:
                    alive[ti] = np.empty(0, dtype=np.int64)
            if not any_split:
                break


def feature_importances(forest: ForestArrays, num_features: int) -> np.ndarray:
    """Total weighted impurity decrease per feature, normalized to max 1
    (DecisionForest feature-importance semantics)."""
    imp = np.zeros(num_features)
    feat = forest.split_feature
    weight = forest.node_counts * forest.gains
    for t in range(forest.num_trees):
        mask = feat[t] >= 0
        np.add.at(imp, feat[t][mask], weight[t][mask])
    m = imp.max()
    return imp / m if m > 0 else imp


def predict_forest_binned(forest: ForestArrays, binned: np.ndarray, device=None) -> np.ndarray:
    """Vectorized inference over the flat heap arrays on ``device``
    (default: the card): returns [n, C] summed class counts or [n, 2]
    (sum, count) pooled. Every tree's rows descend together; the trees'
    leaf stats are added in tree order in float32, as the reference's
    scan adds them, so the sums are the same on the card and the CPU."""
    dev = resolve(device)
    x = torch.from_numpy(np.ascontiguousarray(binned, dtype=np.int32)).to(dev)
    sf = torch.from_numpy(forest.split_feature).to(dev)
    sb = torch.from_numpy(forest.split_bin).to(dev)
    stats = torch.from_numpy(np.asarray(forest.node_stats, dtype=np.float32)).to(dev)
    max_depth = int(np.log2(forest.split_feature.shape[1] + 1)) - 1
    n = x.shape[0]
    node = torch.zeros((sf.shape[0], n), dtype=torch.int64, device=dev)  # [T, n]
    for _ in range(max_depth + 1):
        f = sf.gather(1, node)
        b = sb.gather(1, node)
        col = x.gather(1, f.clamp(min=0).long().T).T  # [T, n]
        child = 2 * node + 1 + (col > b).long()
        node = torch.where(f >= 0, child, node)
    acc = torch.zeros((n, stats.shape[2]), dtype=torch.float32, device=dev)
    for ti in range(sf.shape[0]):
        acc = acc + stats[ti][node[ti]]
    return acc.cpu().numpy()


def node_top_gains(
    binned: np.ndarray,
    targets: np.ndarray,
    forest: ForestArrays,
    tree: int,
    heap: int,
    num_bins: int,
    num_trees: int,
    max_depth: int,
    min_node_size: float = 1.0,
    min_info_gain: float = 0.0,
    impurity: str = "entropy",
    mtry: int | None = None,
    seed: int | None = None,
    exclude_features: set[int] | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """The candidates at node ``heap`` of tree ``tree`` as ``train_forest``
    saw them, best first: (gains [k] float32, flat indices [k]) of the
    candidate set the split was chosen from (the node's mtry mask, or all
    allowed features when the mask admits no split worth taking), -inf
    ones dropped. Takes the arguments the forest was trained with; the
    random stream is replayed on the host, its chunk-wide early exits
    read off ``forest``, and the node's rows routed down ``forest``'s own
    splits, so the ancestors must be as trained. For telling a near tie
    (two best gains within float32 rounding) from a fault."""
    dev = resolve(device)
    st = _setup(binned, targets, forest.num_classes, num_trees, impurity, mtry, seed,
                exclude_features)
    n, p = st.binned.shape
    depth = int(np.log2(heap + 1))
    level_start = 2**depth - 1
    t0 = (tree // st.tc) * st.tc
    for c0 in range(0, t0 + 1, st.tc):
        c1 = min(c0 + st.tc, num_trees)
        w_c = st.draws.chunk_weights(c0, c1)
        # the chunk dispatched one level past its deepest split, at most
        # max_depth + 1 levels
        split_nodes = np.nonzero((forest.split_feature[c0:c1] >= 0).any(axis=0))[0]
        deepest = int(np.log2(split_nodes.max() + 1)) if len(split_nodes) else -1
        levels = min(deepest + 2, max_depth + 1)
        for d in range(levels if c0 < t0 else depth + 1):
            mask = st.draws.level_masks(c0, c1, 2**d)
    w = w_c[tree - t0]
    # rows of the node: routed down the tree's own splits
    node = np.zeros(n, np.int64)
    for _ in range(depth):
        f = forest.split_feature[tree][node]
        b = forest.split_bin[tree][node]
        goes = st.binned[np.arange(n), np.maximum(f, 0)] > b
        node = np.where(f >= 0, 2 * node + 1 + goes, node)
    w_node = np.where((node == heap) & (w > 0), w, 0.0).astype(np.float32)
    hists = _level_histograms(
        torch.from_numpy(st.binned).to(dev), torch.from_numpy(w_node).to(dev),
        torch.from_numpy(st.y_cls).to(dev), torch.from_numpy(st.chan_base).to(dev),
        torch.zeros(n, dtype=torch.int64, device=dev), 1, num_bins, st.imp_kind,
        "reference",
    )
    fm = torch.from_numpy(mask[tree - t0, heap - level_start][None, :]).to(dev)
    gain_m, gain_a = _masked_gains(
        hists, hists[0].sum(dim=1), fm, torch.from_numpy(st.allowed_vec).to(dev),
        st.imp_kind, float(np.float32(min_node_size)), num_bins,
    )
    _, best_m = _best_of(gain_m)
    g = gain_m if float(best_m[0]) > float(np.float32(min_info_gain)) else gain_a
    flat = g.permute(1, 0, 2).reshape(-1).cpu().numpy()
    order = np.lexsort((np.arange(len(flat)), -flat))
    order = order[np.isfinite(flat[order])]
    return flat[order], order
