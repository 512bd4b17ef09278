"""The XLA DP reducer (ops/disparity.py) vs the scanline oracle.

The trace is integer-exact, so the two must agree bit-for-bit, including
argmin tie-breaks (torch::argmin semantics, dynamic_programming.cu:207)
and band-edge clipping.
"""

import numpy as np
import pytest

from stereomatch_tpu.ops.cost import ssd_cost_volume
from stereomatch_tpu.ops.disparity import dynamic_programming

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair
from .oracles import dynamic_programming_oracle

D = STM_MAX_DISPARITY


@pytest.mark.parametrize("seed", [5, 11, 23])
def test_dp_matches_oracle(seed):
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=seed)
    vol = np.asarray(ssd_cost_volume(left, right, max_disparity=D,
                                     kernel_size=3))
    np.testing.assert_array_equal(np.asarray(dynamic_programming(vol)),
                                  dynamic_programming_oracle(vol))


def test_dp_distinct_values():
    """All-distinct volume so any tie-break divergence changes the result."""
    rng = np.random.default_rng(0)
    height, width = 16, 24
    vol = rng.permutation(height * width * D).reshape(
        height, width, D).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(dynamic_programming(vol)),
                                  dynamic_programming_oracle(vol))


def test_dp_constant_volume():
    """Uniform costs: every step ties; pointers must all resolve the same
    way as the oracle's."""
    vol = np.ones((12, 20, D), np.float32)
    np.testing.assert_array_equal(np.asarray(dynamic_programming(vol)),
                                  dynamic_programming_oracle(vol))
