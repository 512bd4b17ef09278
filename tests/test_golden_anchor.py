"""Cross-round regression anchor: a checked-in golden disparity.

The reference anchors behavior on fixed Middlebury outputs it never
commits; this build commits one: the full SSD+SGM -> WTA/DP disparities
of a fixed synthetic scene (tests/data/golden_sgm_disparity.npz,
generated by the XLA formulations, which are oracle-anchored by
test_differential_soak).  Any semantic drift in cost construction, the
SGM recurrence, tie-breaking, or the DP trace shows up here as a
bit-level diff — across rounds, refactors, and jax upgrades.

The Hopper SGM kernel must land on the *same* disparities: its numpy
model (tests/sgm_kernel_model.py) here, the kernel itself on the card
(tests/test_gpu_hardware.py).
"""

from pathlib import Path

import numpy as np

from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
from stereomatch_tpu.ops.cost import ssd_cost_volume
from stereomatch_tpu.ops.disparity import dynamic_programming, winner_takes_all

from . import sgm_kernel_model as model
from .conftest import synthetic_stereo_pair

GOLDEN = Path(__file__).parent / "data" / "golden_sgm_disparity.npz"


def _scene_and_aggregation(g):
    left, right, gt = synthetic_stereo_pair(int(g["height"]), int(g["width"]),
                                            int(g["max_disparity"]),
                                            seed=int(g["seed"]))
    vol = ssd_cost_volume(left, right,
                          max_disparity=int(g["max_disparity"]),
                          kernel_size=int(g["kernel_size"]))
    return left, gt, vol


def test_golden_disparity_xla():
    g = np.load(GOLDEN)
    left, gt, vol = _scene_and_aggregation(g)
    agg = semiglobal_aggregate(vol, left, penalty1=float(g["penalty1"]),
                               penalty2=float(g["penalty2"]))
    wta = np.asarray(winner_takes_all(agg))
    np.testing.assert_array_equal(wta, g["wta"])
    np.testing.assert_array_equal(np.asarray(dynamic_programming(agg)),
                                  g["dp"])
    # The anchor itself must stay a *good* disparity map, not just a stable
    # one — guards against committing a golden file from a broken build.
    d = int(g["max_disparity"])
    bad = np.mean((np.abs(wta - gt) > 1)[:, d:])
    assert bad <= float(g["bad_pixel_vs_gt"]) + 1e-9
    assert bad < 0.06


def test_golden_disparity_census():
    """The census+SGM family's cross-round anchor (codes, Hamming,
    aggregation, and tie-breaks all pinned at the bit level)."""
    from stereomatch_tpu.ops.cost import census_hamming_cost_volume
    g = np.load(GOLDEN)
    left, right, gt = synthetic_stereo_pair(int(g["height"]),
                                            int(g["width"]),
                                            int(g["max_disparity"]),
                                            seed=int(g["seed"]))
    vol = census_hamming_cost_volume(left, right,
                                     max_disparity=int(g["max_disparity"]))
    agg = semiglobal_aggregate(vol, left, penalty1=float(g["penalty1"]),
                               penalty2=float(g["penalty2"]))
    wta = np.asarray(winner_takes_all(agg))
    np.testing.assert_array_equal(wta, g["census_wta"])
    d = int(g["max_disparity"])
    bad = np.mean((np.abs(wta - gt) > 1)[:, d:])
    assert bad <= float(g["census_bad_pixel_vs_gt"]) + 1e-9


def test_golden_disparity_kernel_model():
    g = np.load(GOLDEN)
    left, _, vol = _scene_and_aggregation(g)
    agg = model.aggregate(np.asarray(vol), left, float(g["penalty1"]),
                          float(g["penalty2"]))
    np.testing.assert_array_equal(np.asarray(winner_takes_all(agg)),
                                  g["wta"])
    np.testing.assert_array_equal(np.asarray(dynamic_programming(agg)),
                                  g["dp"])
