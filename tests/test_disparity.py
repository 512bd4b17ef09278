"""Disparity reducers vs. oracles, including the reference's error-contract
and distinct-values test patterns (tests/test_winners_take_all.py:26-48)."""

import numpy as np
import pytest

from stereomatch_tpu.ops.disparity import (dynamic_programming,
                                           dynamic_programming_with_paths,
                                           winner_takes_all)

from .oracles import dynamic_programming_oracle, wta_oracle


def test_wta_distinct_values():
    """Bit-exact on an all-distinct volume, as the reference tests GPU WTA
    (tests/test_winners_take_all.py:31-33)."""
    vol = np.arange(20 * 20 * 16, dtype=np.float32).reshape(20, 20, 16)
    rng = np.random.default_rng(0)
    vol = rng.permutation(vol.ravel()).reshape(20, 20, 16)
    np.testing.assert_array_equal(np.asarray(winner_takes_all(vol)),
                                  wta_oracle(vol))


def test_wta_tie_breaks_to_lower_disparity():
    """CPU-kernel tie semantics (winners_take_all.cu:29-37): strict < keeps
    the earliest minimum."""
    vol = np.ones((3, 3, 8), np.float32)
    vol[1, 1, 3] = vol[1, 1, 5] = 0.0
    got = np.asarray(winner_takes_all(vol))
    assert got[1, 1] == 3
    assert got[0, 0] == 0


def test_wta_no_power_of_two_constraint():
    """The CUDA tree reduction required pow-2 D
    (stereomatch/disparity_reduce.py:40-43); jnp.argmin does not."""
    vol = np.random.default_rng(1).random((5, 7, 13)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(winner_takes_all(vol)),
                                  wta_oracle(vol))


def test_wta_on_ssd_volume(ssd_cost_small):
    got = np.asarray(winner_takes_all(ssd_cost_small.volume))
    np.testing.assert_array_equal(got, wta_oracle(ssd_cost_small.volume))
    assert got.dtype == np.int32


def test_dp_matches_oracle_random():
    rng = np.random.default_rng(2)
    vol = rng.random((9, 14, 8)).astype(np.float32)
    got = np.asarray(dynamic_programming(vol))
    np.testing.assert_array_equal(got, dynamic_programming_oracle(vol))


def test_dp_matches_oracle_distinct():
    vol = np.arange(6 * 11 * 4, dtype=np.float32).reshape(6, 11, 4)
    vol = np.random.default_rng(3).permutation(vol.ravel()).reshape(6, 11, 4)
    got = np.asarray(dynamic_programming(vol))
    np.testing.assert_array_equal(got, dynamic_programming_oracle(vol))


def test_dp_on_ssd_volume(ssd_cost_small):
    """Bit-exact DP trace on a realistic SSD volume (with +inf cells)."""
    vol = ssd_cost_small.volume
    got = np.asarray(dynamic_programming(vol))
    np.testing.assert_array_equal(got, dynamic_programming_oracle(vol))
    assert got.dtype == np.int32


def test_dp_exposes_path_volume(ssd_cost_small):
    """The *_with_paths variant mirrors the reference's preallocated
    path_volume / row_final_costs surface (disparity_reduce.py:77-84)."""
    vol = ssd_cost_small.volume.astype(np.float32)
    disparity, path_volume, final_costs = dynamic_programming_with_paths(vol)
    assert path_volume.shape == vol.shape
    assert path_volume.dtype == np.int8
    assert final_costs.shape == (vol.shape[0], vol.shape[2])
    np.testing.assert_array_equal(np.asarray(disparity),
                                  np.asarray(dynamic_programming(vol)))
    # Column-0 pointers are the defined no-predecessor value.
    np.testing.assert_array_equal(np.asarray(path_volume[:, 0, :]), 0)
