"""Helpers the metric readers share (not a metric: its name starts with _)."""

from __future__ import annotations


def solve_kernel(name: str) -> bool:
    """A kernel of the batched Cholesky factorisation (with its zeroing of
    the upper triangle and its pointer set-up) and triangular solves."""
    low = name.lower()
    return any(key in low for key in ("potr", "trsm", "trsv", "chol", "magma", "cusolver",
                                      "syrk", "herk", "lapack", "triu_tril", "sset_pointer"))


def scan_kernel(name: str) -> bool:
    """A kernel of the top-N scan (its query split included) or its merge."""
    return name.startswith(("topn_tc_kernel", "split_queries_kernel", "topn_merge"))


def idle_share(art: dict, kind: str):
    trace = art.get("trace")
    if art.get("kind") != kind or trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
