"""The yardstick's arithmetic against hand-worked small shapes."""

from __future__ import annotations

import pytest

from portbench import roofline


def test_kernel_bound_counts_bytes_and_operations():
    # 4 features x 10 float32 items = 160 B, aux 40 B, 2 queries 32 B, 16 B out
    ms, by = roofline.kernel_bound("float32", 2, 4, 10, 16)
    assert by == "bytes"
    assert ms == pytest.approx(248 / 3.35e12 * 1e3)
    # a wide batch over few items is bound by its 2*b*kf*n operations
    ms, by = roofline.kernel_bound("int8", 4096, 256, 100_000, 0)
    assert by == "operations"
    assert ms == pytest.approx(2 * 4096 * 256 * 100_000 / 989e12 * 1e3)


def test_ops_bound_takes_the_larger():
    assert roofline.ops_bound(3.35e9, 0) == pytest.approx((1.0, "bytes"))
    ms, by = roofline.ops_bound(0, 989e12 / 6)
    assert by == "operations" and ms == pytest.approx(1e3)


@pytest.mark.parametrize("args, want", [
    # nnz 3, 2 rows solved, 2 users, 2 items, k 2
    ((3, 2, 2, 2, 2), (3 * 2 * (8 + 8) + 2 * (4 + 16 + 8), 2 * 3 * 2 * 6 + 2 * 2 * 4 * 4)),
])
def test_als_gram_cost(args, want):
    assert roofline.als_gram_cost(*args) == want


def test_als_solve_cost():
    assert roofline.als_solve_cost(2, 3) == (2 * (36 + 24), 2 * 2 * 27 / 3)


def test_als_model_flops():
    # users' half: 2*4*9 + 2*(9 + 36) + 2*3*9; items' half: 2*4*9 + 3*(9 + 36) + 2*2*9
    assert roofline.als_model_flops(4, 2, 3, 2, 3, 3) == 216 + 243


def test_recommend_flops():
    assert roofline.recommend_flops(5, 3) == 30
