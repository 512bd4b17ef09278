"""Production-geometry golden anchor: teddy-scale disparities.

tests/data/golden_teddy_disparity.npz pins the full 450x375 / D=128
geometry — the shape every headline benchmark runs at and the reference's
full-resolution fixture scale (/root/reference/tests/conftest.py:58-78) —
where golden_sgm_disparity.npz pins only a 96x128 toy.  Execution paths
that must land on the committed disparities at the bit level:

1. the XLA scan formulations (the semantic oracles; also the generator —
   tools/make_golden_teddy.py);
2. the Hopper SGM kernel's algorithm, through its numpy model
   (tests/sgm_kernel_model.py; the kernel itself is checked against the
   same file on the card, tests/test_gpu_hardware.py);
3. a 448-wide crop, with its own committed array;
4. the bfloat16 storage path (volume + aggregation in bf16, f32
   recurrences);
5. the sharded exact mode on a 5-way row-tile CPU mesh (375 = 5 x 75),
   cross-rank SGM carry hand-off included.

These are cross-round regression pins: any drift in cost construction,
the SGM recurrence/normalization, tie-breaking, or the sharded hand-off
shows up as a bit-level diff here.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
from stereomatch_tpu.ops.cost import ssd_cost_volume
from stereomatch_tpu.ops.disparity import (dynamic_programming,
                                           winner_takes_all)

from . import sgm_kernel_model as model
from .conftest import synthetic_stereo_pair

GOLDEN = Path(__file__).parent / "data" / "golden_teddy_disparity.npz"


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def scene(golden):
    g = golden
    return synthetic_stereo_pair(int(g["height"]), int(g["width"]),
                                 int(g["max_disparity"]),
                                 seed=int(g["seed"]))


def _volume(golden, left, right, dtype=jnp.float32):
    return ssd_cost_volume(left, right,
                           max_disparity=int(golden["max_disparity"]),
                           kernel_size=int(golden["kernel_size"]),
                           cost_dtype=dtype)


def _aggregate_xla(golden, vol, left):
    return semiglobal_aggregate(vol, left,
                                penalty1=float(golden["penalty1"]),
                                penalty2=float(golden["penalty2"]))


def test_golden_teddy_xla(golden, scene):
    left, right, gt = scene
    agg = _aggregate_xla(golden, _volume(golden, left, right), left)
    wta = np.asarray(winner_takes_all(agg))
    np.testing.assert_array_equal(wta, golden["wta"])
    np.testing.assert_array_equal(np.asarray(dynamic_programming(agg)),
                                  golden["dp"])
    # The anchor must stay a *good* disparity map, not just a stable one.
    d = int(golden["max_disparity"])
    bad = np.mean((np.abs(wta - gt) > 1)[:, d:])
    assert bad <= float(golden["bad_pixel_vs_gt"]) + 1e-9
    assert bad < 0.06


def test_golden_teddy_kernel_model(golden, scene):
    """The SGM kernel's algorithm at production geometry: bit-equal SGM
    volume to the oracle and the exact committed WTA/DP disparities."""
    left, right, _ = scene
    vol = np.asarray(_volume(golden, left, right))
    agg = model.aggregate(vol, left, float(golden["penalty1"]),
                          float(golden["penalty2"]))
    np.testing.assert_array_equal(
        agg, np.asarray(_aggregate_xla(golden, vol, left)))
    np.testing.assert_array_equal(np.asarray(winner_takes_all(agg)),
                                  golden["wta"])
    np.testing.assert_array_equal(np.asarray(dynamic_programming(agg)),
                                  golden["dp"])


def test_golden_teddy_448_wide(golden):
    """The 448-wide crop of the scene lands on its committed WTA."""
    g = golden
    w = int(g["wgrid_width"])
    left, right, _ = synthetic_stereo_pair(int(g["height"]), int(g["width"]),
                                           int(g["max_disparity"]),
                                           seed=int(g["seed"]))
    left, right = left[:, :w], right[:, :w]
    agg = _aggregate_xla(g, _volume(g, left, right), left)
    np.testing.assert_array_equal(np.asarray(winner_takes_all(agg)),
                                  g["wta_448"])


def test_golden_teddy_bf16(golden, scene):
    """bf16 storage path: the XLA scan's committed pin, within a fraction
    of a percent of the f32 disparities.  (The kernel narrows once, after
    the f32 accumulation of all eight traversals, like the XLA scan.)"""
    left, right, _ = scene
    vol16 = _volume(golden, left, right, dtype=jnp.bfloat16)
    agg_x = _aggregate_xla(golden, vol16, left)
    wta_x = np.asarray(winner_takes_all(agg_x))
    np.testing.assert_array_equal(wta_x, golden["wta_bf16"])
    assert np.mean(wta_x != golden["wta"]) < 0.005


def test_golden_teddy_sharded_exact(golden, scene):
    """Sharded exact mode on a 5-way row-tile mesh (375 = 5 x 75): the
    cross-rank carry hand-off must reproduce the committed single-chip
    disparities bit-exactly."""
    from stereomatch_tpu.parallel import ShardedPipeline, make_mesh

    devices = jax.devices()
    if len(devices) < 5:
        pytest.skip("needs >= 5 virtual devices")
    left, right, _ = scene
    mesh = make_mesh(devices[:5], n_tile=5)
    pipe = ShardedPipeline(mesh, int(golden["max_disparity"]),
                           kernel_size=int(golden["kernel_size"]),
                           aggregation="sgm", reducer="wta",
                           sgm_mode="exact",
                           penalty1=float(golden["penalty1"]),
                           penalty2=float(golden["penalty2"]))
    out = np.asarray(pipe.estimate(left, right))   # 2-D in -> 2-D out
    np.testing.assert_array_equal(out, golden["wta"])
