"""bfloat16 cost-volume path: dtype propagation and accuracy bounds.

bfloat16 halves the memory traffic of every volume-sized read/write — the
dominant cost at production geometry — while all recurrences still run
float32 (the SGM kernel, ops/sgm_cuda.cu, widens on load and accumulates
in f32; the XLA scans widen up front).
The price is bfloat16 rounding of the stored costs; these tests pin that
the price stays small at the disparity level, where results are consumed.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from stereomatch_tpu.cost import SSD
from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
from stereomatch_tpu.ops.cost import ssd_cost_volume
from stereomatch_tpu.ops.disparity import winner_takes_all

from . import sgm_kernel_model as model
from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair

D = STM_MAX_DISPARITY


@pytest.fixture(scope="module")
def scene():
    left, right, gt = synthetic_stereo_pair(48, 64, D, seed=21)
    return left, right, gt


def test_bf16_cost_volume_dtype_and_infinity(scene):
    left, right, _ = scene
    vol = ssd_cost_volume(left, right, max_disparity=D, kernel_size=3,
                          cost_dtype=jnp.bfloat16)
    assert vol.dtype == jnp.bfloat16
    v = np.asarray(vol, np.float32)
    assert np.isinf(v[0, 0, 1:]).all()       # d > col stays +inf
    f32 = np.asarray(ssd_cost_volume(left, right, max_disparity=D,
                                     kernel_size=3))
    finite = np.isfinite(f32)
    assert np.array_equal(finite, np.isfinite(v))
    # bf16 has an 8-bit mantissa: values round to within 2^-8 relative.
    np.testing.assert_allclose(v[finite], f32[finite], rtol=2 ** -8,
                               atol=1e-6)


def test_bf16_sgm_kernel_model_stays_close(scene):
    """The SGM kernel's algorithm (numpy model) on a bf16 volume: it
    widens the stored costs exactly, so disparities stay within a few
    percent of the f32 volume's."""
    left, right, _ = scene
    vol16 = ssd_cost_volume(left, right, max_disparity=D, kernel_size=3,
                            cost_dtype=jnp.bfloat16)
    agg16 = model.aggregate(np.asarray(vol16, np.float32), left)
    vol32 = ssd_cost_volume(left, right, max_disparity=D, kernel_size=3)
    agg32 = model.aggregate(np.asarray(vol32), left)
    d16 = np.asarray(winner_takes_all(
        jnp.asarray(agg16).astype(jnp.bfloat16)))
    d32 = np.asarray(winner_takes_all(agg32))
    assert np.mean(d16 != d32) < 0.05


def test_bf16_pipeline_accuracy_vs_ground_truth(scene):
    """The end metric: bf16 bad-pixel rate within 1 point of float32's."""
    left, right, gt = scene

    def bad_pixel(cost_dtype):
        vol = ssd_cost_volume(left, right, max_disparity=D, kernel_size=3,
                              cost_dtype=cost_dtype)
        agg = semiglobal_aggregate(vol, left)
        disp = np.asarray(winner_takes_all(agg))
        return np.mean((np.abs(disp - gt) > 1)[:, D:])

    b32 = bad_pixel(jnp.float32)
    b16 = bad_pixel(jnp.bfloat16)
    assert b16 <= b32 + 0.01


def test_bf16_xla_aggregation_roundtrip(scene):
    left, right, _ = scene
    vol = ssd_cost_volume(left, right, max_disparity=D, kernel_size=3,
                          cost_dtype=jnp.bfloat16)
    agg = semiglobal_aggregate(vol, left)
    assert agg.dtype == jnp.bfloat16


def test_bf16_reaches_api_layer(scene):
    left, right, _ = scene
    vol = SSD(D, kernel_size=3, cost_volume_dtype=jnp.bfloat16)(left, right)
    assert vol.dtype == jnp.bfloat16


@pytest.mark.parametrize("sgm_mode", ["exact", "overlap"])
def test_bf16_sharded_pipeline(scene, sgm_mode):
    """bf16 volumes through the row-sharded mesh pipeline: disparities
    must closely track the single-chip bf16 path (the sharded program
    widens the volume before its sweeps, so the claim is tolerance, not
    bits)."""
    import jax
    from stereomatch_tpu.parallel import ShardedPipeline, make_mesh

    left, right, _ = scene
    assert len(jax.devices()) >= 8
    vol = ssd_cost_volume(left, right, max_disparity=D, kernel_size=3,
                          cost_dtype=jnp.bfloat16)
    ref = np.asarray(winner_takes_all(semiglobal_aggregate(vol, left)))

    mesh = make_mesh(jax.devices()[:8], n_batch=2)
    pipe = ShardedPipeline(mesh, D, kernel_size=3,
                           cost_dtype=jnp.bfloat16, aggregation="sgm",
                           reducer="wta", sgm_mode=sgm_mode,
                           overlap=left.shape[0], backend="xla")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    assert np.mean(out[0] != ref) < 0.02
