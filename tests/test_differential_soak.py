"""Seeded differential soak: oracle -> XLA -> kernel model across random
configs.

The chain numpy-oracle == XLA formulation == SGM kernel model is the
load-bearing correctness argument of this build (it substitutes for the
reference's real-teddy fixtures, which need network): random geometries,
window sizes and SGM penalties at toy scale against the per-pixel oracles;
the full reference dtype matrix (uint8/int16 inputs x int32/float32 cost,
src/type_dispatch.hpp:38-110) on the cost+reduce chain; and a
production-shape (teddy-class) XLA == kernel model run, where the naive
oracles are too slow but the XLA formulations are already oracle-anchored
at toy scale.  (The kernel model is tests/sgm_kernel_model.py: the Hopper
SGM kernel's algorithm in numpy; the kernel itself meets the XLA scans on
the card in tests/test_gpu_hardware.py.)

A 40-trial unseeded version of the float chain ran clean during
development; the seeded set guards the same surface in CI time.
"""

import numpy as np
import pytest

from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
from stereomatch_tpu.ops.cost import birchfield_cost_volume, ssd_cost_volume
from stereomatch_tpu.ops.disparity import dynamic_programming, winner_takes_all

from . import sgm_kernel_model as model
from .oracles import (birchfield_oracle, dynamic_programming_oracle,
                      sgm_oracle, ssd_oracle, wta_oracle)

SOAK_SEEDS = [3, 11, 17, 23, 29, 37, 43, 53, 61, 71, 79, 83, 89, 97,
              101, 107]


@pytest.mark.parametrize("seed", SOAK_SEEDS)
def test_differential_chain(seed):
    rng = np.random.default_rng(seed)
    height = int(rng.integers(6, 24))
    width = int(rng.integers(10, 32))
    max_disp = int(rng.integers(2, min(width, 16)))
    k = int(rng.integers(1, 4))
    p1 = float(rng.uniform(0.01, 0.5))
    p2 = float(rng.uniform(p1, 1.5))
    left = rng.random((height, width)).astype(np.float32)
    right = rng.random((height, width)).astype(np.float32)

    vol = np.asarray(ssd_cost_volume(left, right, max_disparity=max_disp,
                                     kernel_size=k))
    ref_vol = ssd_oracle(left, right, max_disp, k)
    mask = np.isfinite(ref_vol)
    assert np.array_equal(mask, np.isfinite(vol))
    np.testing.assert_allclose(vol[mask], ref_vol[mask], rtol=1e-4,
                               atol=1e-4)

    agg_o = sgm_oracle(ref_vol.astype(np.float32), left, p1, p2)
    agg_x = np.asarray(semiglobal_aggregate(vol, left, penalty1=p1,
                                            penalty2=p2))
    agg_k = model.aggregate(vol, left, p1, p2)
    np.testing.assert_array_equal(wta_oracle(agg_o),
                                  np.asarray(winner_takes_all(agg_x)))
    np.testing.assert_array_equal(agg_k, agg_x)

    np.testing.assert_array_equal(dynamic_programming_oracle(agg_o),
                                  np.asarray(dynamic_programming(agg_x)))

    bvol = np.asarray(birchfield_cost_volume(left, right,
                                             max_disparity=max_disp))
    boracle = birchfield_oracle(left, right, max_disp, 4)
    bmask = np.isfinite(boracle)
    np.testing.assert_allclose(bvol[bmask], boracle[bmask], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("image_dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("cost_dtype", ["int32", "float32"])
@pytest.mark.parametrize("seed", [5, 19, 47, 73])
def test_integer_chain(image_dtype, cost_dtype, seed):
    """The reference dtype matrix (uint8/int16 input x int32/f32 cost,
    src/type_dispatch.hpp:38-110) on SSD -> WTA/DP.

    Integer cost volumes accumulate exactly (int32 vs the oracle's f32 —
    values stay below 2**24 at these magnitudes), and invalid cells carry
    iinfo(int32).max, the NumericLimits<int32>::infinity() analogue
    (include/stereomatch/numeric.hpp:12-50).  SGM is float-only by
    construction: its adaptive P2 divides penalties by intensity gradients
    (semiglobal.cpp:137-138).
    """
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    height = int(rng.integers(8, 20))
    width = int(rng.integers(12, 28))
    max_disp = int(rng.integers(2, 12))
    k = int(rng.integers(1, 4))
    left = rng.integers(0, 250, (height, width)).astype(image_dtype)
    right = rng.integers(0, 250, (height, width)).astype(image_dtype)

    cd = jnp.int32 if cost_dtype == "int32" else jnp.float32
    vol = np.asarray(ssd_cost_volume(left, right, max_disparity=max_disp,
                                     kernel_size=k, cost_dtype=cd))
    assert vol.dtype == np.dtype(cost_dtype)
    ref_vol = ssd_oracle(left, right, max_disp, k)
    mask = np.isfinite(ref_vol)
    if cost_dtype == "int32":
        assert (vol[~mask] == np.iinfo(np.int32).max).all()
        np.testing.assert_array_equal(vol[mask],
                                      ref_vol[mask].astype(np.int64))
    else:
        assert np.array_equal(mask, np.isfinite(vol))
        np.testing.assert_array_equal(vol[mask], ref_vol[mask])

    np.testing.assert_array_equal(wta_oracle(np.where(mask, ref_vol, np.inf)),
                                  np.asarray(winner_takes_all(vol)))
    np.testing.assert_array_equal(
        dynamic_programming_oracle(np.where(mask, ref_vol, np.inf)),
        np.asarray(dynamic_programming(vol.astype(np.float32))))


def test_teddy_class_xla_kernel_model_parity():
    """Production-shape (128x160, D=64) XLA == kernel model differential
    run: bit-equal aggregation (hence identical WTA argmins), and the DP
    trace over it is oracle-anchored at toy scale above."""
    rng = np.random.default_rng(1234)
    height, width, max_disp = 128, 160, 64
    left = rng.random((height, width), np.float32)
    right = rng.random((height, width), np.float32)

    vol = np.asarray(ssd_cost_volume(left, right, max_disparity=max_disp,
                                     kernel_size=5))
    agg_x = np.asarray(semiglobal_aggregate(vol, left))
    agg_k = model.aggregate(vol, left)
    np.testing.assert_array_equal(agg_k, agg_x)
    np.testing.assert_array_equal(np.asarray(winner_takes_all(agg_x)),
                                  np.asarray(winner_takes_all(agg_k)))


def test_teddy_class_integer_cost_wta():
    """uint8 input -> int32 cost at production shape: WTA over the integer
    volume must bit-match WTA over the float64-exact recomputation."""
    rng = np.random.default_rng(4321)
    height, width, max_disp = 128, 160, 64
    left = rng.integers(0, 250, (height, width)).astype(np.uint8)
    right = rng.integers(0, 250, (height, width)).astype(np.uint8)
    import jax.numpy as jnp
    vol_i = np.asarray(ssd_cost_volume(left, right, max_disparity=max_disp,
                                       kernel_size=7, cost_dtype=jnp.int32))
    vol_f = np.asarray(ssd_cost_volume(left, right, max_disparity=max_disp,
                                       kernel_size=7,
                                       cost_dtype=jnp.float32))
    # int32 accumulation is exact; f32 path may round above 2**24 — argmins
    # still agree because window sums at uint8 magnitudes stay below that.
    assert vol_i[vol_i != np.iinfo(np.int32).max].max() < 2 ** 24
    np.testing.assert_array_equal(np.asarray(winner_takes_all(vol_i)),
                                  np.asarray(winner_takes_all(vol_f)))


@pytest.mark.parametrize("seed", SOAK_SEEDS[::2])
def test_cvf_differential(seed):
    """Guided cost-volume filtering vs its direct windowed oracle across
    random geometries, radii, and edge regularizers, on a volume carrying
    the +inf invalid wedge (the masked-statistics path)."""
    from stereomatch_tpu.ops.cvf import guided_filter_aggregate
    from .oracles import guided_filter_oracle

    rng = np.random.default_rng(seed)
    height = int(rng.integers(6, 24))
    width = int(rng.integers(10, 32))
    max_disp = int(rng.integers(2, min(width, 16)))
    k = int(rng.integers(1, 4))
    radius = int(rng.integers(1, 5))
    eps = float(rng.uniform(1e-5, 1e-2))
    left = rng.random((height, width)).astype(np.float32)
    right = rng.random((height, width)).astype(np.float32)

    vol = np.asarray(ssd_cost_volume(left, right, max_disparity=max_disp,
                                     kernel_size=k))
    out = np.asarray(guided_filter_aggregate(vol, left, radius=radius,
                                             eps=eps))
    ref = guided_filter_oracle(vol, left, radius, eps)
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    mask = np.isfinite(ref)
    np.testing.assert_allclose(out[mask], ref[mask], rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("seed", range(8))
def test_cvf_wedge_differential(seed):
    """Wedge-structured CVF (the prefix-plane fast path create_pipeline
    takes) vs the direct windowed oracle across random geometries, radii
    and wedge offsets — same masked means, different association."""
    from stereomatch_tpu.ops.cvf import guided_filter_aggregate
    from .oracles import guided_filter_oracle

    rng = np.random.default_rng(1000 + seed)
    height = int(rng.integers(10, 40))
    width = int(rng.integers(14, 48))
    max_disp = int(rng.integers(2, min(width, 20)))
    radius = int(rng.integers(1, 6))
    off = int(rng.integers(0, 3))
    vol = rng.random((height, width, max_disp)).astype(np.float32)
    x, d = np.meshgrid(np.arange(width), np.arange(max_disp),
                       indexing="ij")
    vol[:, x < d + off] = np.inf
    guide = rng.random((height, width)).astype(np.float32)

    got = np.asarray(guided_filter_aggregate(vol, guide, radius=radius,
                                             wedge_offset=off))
    ref = guided_filter_oracle(vol, guide, radius, 1e-4)
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=5e-4, atol=5e-5)
