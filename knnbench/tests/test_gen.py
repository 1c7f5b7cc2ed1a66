"""Inputs from the seed."""

from __future__ import annotations

import numpy as np
import pytest

from knnbench import gen

CFG = {"train_rows": 300, "dim": 16, "value_min": 0, "value_max": 255,
       "value_scale": 255, "classes": 10}
MIX = {"queries_per_call": 8, "pool_queries": 30}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_same_seed_same_arrays(seed):
    a = gen.make_inputs(CFG, MIX, seed, "cpu")
    b = gen.make_inputs(CFG, MIX, seed, "cpu")
    for key in ("train_x", "train_y", "pool"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["train_x"].dtype == np.float32 and a["train_y"].dtype == np.int32
    assert a["train_x"].shape == (300, 16) and a["pool"].shape == (24, 16)
    assert a["train_x"].min() >= 0 and a["train_x"].max() <= 1
    steps = a["train_x"].astype(np.float64) * 255
    np.testing.assert_allclose(steps, np.round(steps), atol=1e-4)
    assert len(np.unique(steps.round())) > 200
    assert set(np.unique(a["train_y"])) <= set(range(10))


def test_another_seed_other_arrays():
    a = gen.make_inputs(CFG, MIX, 2**31 + 1, "cpu")
    b = gen.make_inputs(CFG, MIX, 2**31 + 2, "cpu")
    for key in ("train_x", "train_y", "pool"):
        assert not np.array_equal(a[key], b[key])


def test_calls_rotate_through_the_pool():
    rows = [gen.call_rows(MIX, i) for i in range(7)]
    assert [r.start for r in rows] == [0, 8, 16, 0, 8, 16, 0]
    assert all(rows[i] != rows[i + 1] for i in range(6))


def test_the_check_sample_is_the_seeds():
    a = gen.check_sample(2**31 + 5, 1000, 64)
    np.testing.assert_array_equal(a, gen.check_sample(2**31 + 5, 1000, 64))
    assert not np.array_equal(a, gen.check_sample(2**31 + 6, 1000, 64))
    assert len(np.unique(a)) == 64 and a.max() < 1000
    assert len(gen.check_sample(1, 10, 64)) == 10
