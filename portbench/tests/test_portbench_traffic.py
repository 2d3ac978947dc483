"""The frozen generators give the program's own draws for a seed."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.traffic.movielens import movielens_shape, relabelled
from portbench.traffic.skew import PowerLawUsers


@pytest.mark.parametrize("seed", [17, 2**31 + 7])
def test_movielens_shape_draws_chip_smokes_distribution(seed):
    import chip_smoke

    got = movielens_shape(3000, 400, 60_000, seed, "cpu")
    again = movielens_shape(3000, 400, 60_000, seed, "cpu")
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    u, i, r = got
    assert u.dtype == i.dtype == np.int32 and r.dtype == np.float32
    assert len(np.unique(u.astype(np.int64) * 400 + i)) == 60_000
    assert u.min() >= 0 and u.max() < 3000 and i.min() >= 0 and i.max() < 400
    wu, wi, wr = chip_smoke.movielens_shape(3000, 400, 60_000, seed)
    # the stars' shares are the quantiles' 10/20/30/25/15%
    np.testing.assert_allclose(np.bincount(r.astype(int), minlength=6)[1:] / 60_000,
                               np.bincount(wr.astype(int), minlength=6)[1:] / 60_000, atol=1e-3)
    # items by popularity: zipf(1.3) modulo 400 over distinct pairs
    ours = np.sort(np.bincount(i, minlength=400))[::-1]
    theirs = np.sort(np.bincount(wi, minlength=400))[::-1]
    np.testing.assert_allclose(ours[:10], theirs[:10], rtol=0.1)
    assert abs(ours.sum() - theirs.sum()) == 0


def test_relabelled_sets_have_the_same_degrees_in_another_order():
    base = movielens_shape(500, 80, 4000, 25, "cpu")
    a, b = relabelled(500, 80, 4000, 25, 1, "cpu"), relabelled(500, 80, 4000, 25, 2, "cpu")
    for got in (a, b):
        for side, n in ((0, 500), (1, 80)):
            np.testing.assert_array_equal(np.sort(np.bincount(got[side], minlength=n)),
                                          np.sort(np.bincount(base[side], minlength=n)))
        np.testing.assert_array_equal(np.sort(got[2]), np.sort(base[2]))
    assert not np.array_equal(a[0], b[0])
    for x, y in zip(a, relabelled(500, 80, 4000, 25, 1, "cpu")):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [dict(), dict(exponent=1.3, hot_count=4, hot_weight=0.3)])
def test_power_law_users_is_the_ports(kw):
    from oryx_tpu_torch.loadgen.skew import PowerLawUsers as Ports

    for seed in (0, 2**31 + 99):
        ours, theirs = PowerLawUsers(10_000, seed=seed, **kw), Ports(10_000, seed=seed, **kw)
        np.testing.assert_array_equal(ours.sample(5000), theirs.sample(5000))


def test_power_law_users_repeat_for_a_seed():
    a, b = PowerLawUsers(1000, seed=5).sample(100), PowerLawUsers(1000, seed=5).sample(100)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, PowerLawUsers(1000, seed=6).sample(100))


def test_closed_loop_callers_draw_their_own_users_again_for_a_seed():
    from portbench.traffic.closed_loop import Caller

    spec = {"users": 1000, "skew": {"exponent": 1.1, "hot_count": 0, "hot_weight": 0.0},
            "seed": 2**31 + 3, "host": "127.0.0.1", "port": 1, "path": "/", "timeout_s": 1.0}

    def draws(phase):
        return [Caller(spec, 1.0, phase, c, []).users.sample(200) for c in range(3)]

    first, again = draws(1), draws(1)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[0], first[1])
    assert not np.array_equal(first[0], draws(0)[0])
