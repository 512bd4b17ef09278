"""Shape-robustness sweep for the SGM kernel's algorithm and the DP reducer.

Awkward geometries — odd heights, prime widths, disparity counts below,
at and above the kernel's 32-lane warp width — pin parity of the SGM
kernel's numpy model (tests/sgm_kernel_model.py) with the XLA scans, and
of the XLA DP reducer with the per-scanline oracle.
"""

import numpy as np
import pytest

from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
from stereomatch_tpu.ops.disparity import dynamic_programming, winner_takes_all

from . import sgm_kernel_model as model
from .oracles import dynamic_programming_oracle

SHAPES = [
    (7, 11, 4),      # tiny, odd H, D below one value per lane
    (16, 23, 8),     # prime W
    (9, 16, 16),     # odd H
    (12, 20, 32),    # D = one warp of lanes
    (8, 10, 100),    # D not a multiple of the warp width
]


@pytest.fixture(scope="module")
def volumes():
    rng = np.random.default_rng(42)
    out = {}
    for shape in SHAPES:
        h, w, d = shape
        out[shape] = (rng.random((h, w, d)).astype(np.float32),
                      rng.random((h, w)).astype(np.float32))
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_sgm_kernel_model_shape_sweep(volumes, shape):
    vol, img = volumes[shape]
    ref = np.asarray(semiglobal_aggregate(vol, img))
    out = model.aggregate(vol, img)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        np.asarray(winner_takes_all(out)),
        np.asarray(winner_takes_all(ref)))


@pytest.mark.parametrize("shape", SHAPES)
def test_dp_shape_sweep(volumes, shape):
    vol, _ = volumes[shape]
    np.testing.assert_array_equal(np.asarray(dynamic_programming(vol)),
                                  dynamic_programming_oracle(vol))
