"""Hardware tier: the Hopper SGM kernel and the main path on the card.

Run on a machine with an NVIDIA Hopper GPU:

    python -m pytest -m gpu tests/test_gpu_hardware.py -q

(``chip_smoke.py`` runs it as its first phase).  Every test skips, with a
reason, where the kernel cannot run — the decision is taken in a fixture,
so every test worker collects the same tests.  Checks:

* the kernel against the XLA scans (ops/aggregation.py) at teddy f32 and
  HD bf16, and its carry contract (the sharded paths' per-tile sweep);
* the golden anchors (tests/data/golden_*.npz) through the kernel;
* the sharded exact and overlap paths on a one-card mesh;
* float32 contractions that the H100 would otherwise run in TF32.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu

DATA = Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def card():
    from stereomatch_tpu.utils.backend import kernel_supported
    if not kernel_supported():
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.x); "
                    f"default device: {jax.devices()[0].device_kind}")
    return jax.devices()[0]


def _scene(h, w, d, seed):
    from stereomatch_tpu.io.synthetic import stereo_pair
    left, right, gt = stereo_pair(h, w, d, seed=seed)
    return jnp.asarray(left), jnp.asarray(right), gt


def test_kernel_matches_xla_teddy_f32(card):
    from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
    from stereomatch_tpu.ops.cost import ssd_cost_volume
    from stereomatch_tpu.ops.sgm_cuda import semiglobal_aggregate_cuda
    left, right, _ = _scene(375, 450, 128, 3)
    vol = ssd_cost_volume(left, right, max_disparity=128, kernel_size=7)
    ref = np.asarray(semiglobal_aggregate(vol, left))
    out = np.asarray(semiglobal_aggregate_cuda(vol, left))
    finite = np.isfinite(ref)
    assert np.array_equal(finite, np.isfinite(out))
    np.testing.assert_allclose(out[finite], ref[finite], rtol=2e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(out.argmin(-1), ref.argmin(-1))


def test_kernel_matches_xla_hd_bf16(card):
    from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
    from stereomatch_tpu.ops.cost import census_hamming_cost_volume
    from stereomatch_tpu.ops.disparity import winner_takes_all
    from stereomatch_tpu.ops.sgm_cuda import semiglobal_aggregate_cuda
    left, right, _ = _scene(1024, 1280, 256, 5)
    vol = census_hamming_cost_volume(left, right, max_disparity=256,
                                     cost_dtype=jnp.bfloat16)
    ref = semiglobal_aggregate(vol, left)
    out = semiglobal_aggregate_cuda(vol, left)
    assert out.dtype == jnp.bfloat16
    agree = np.mean(np.asarray(winner_takes_all(out))
                    == np.asarray(winner_takes_all(ref)))
    assert agree >= 0.995, agree


def test_kernel_distinct_value_wta_identical(card):
    from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
    from stereomatch_tpu.ops.disparity import winner_takes_all
    from stereomatch_tpu.ops.sgm_cuda import semiglobal_aggregate_cuda
    rng = np.random.default_rng(0)
    vol = jnp.asarray(rng.permutation(96 * 128 * 64).reshape(96, 128, 64)
                      .astype(np.float32) / 1024.0)
    img = jnp.asarray(rng.random((96, 128), np.float32))
    np.testing.assert_array_equal(
        np.asarray(winner_takes_all(semiglobal_aggregate_cuda(vol, img))),
        np.asarray(winner_takes_all(semiglobal_aggregate(vol, img))))


@pytest.mark.parametrize("shift", [0, 1, -1])
def test_kernel_carry_contract(card, shift):
    from stereomatch_tpu.ops import aggregation, sgm_cuda
    rng = np.random.default_rng(shift + 5)
    vol = jnp.asarray(rng.random((64, 96, 128), np.float32))
    img = jnp.asarray(rng.random((64, 96), np.float32))
    carry = (jnp.asarray(rng.random((96, 128), np.float32)),
             jnp.asarray(rng.random((96,), np.float32)))
    for seed in (True, False):
        (fa, ia), ca = jax.jit(lambda v, i, c: aggregation.sgm_scan_with_carry(
            v, i, 0.1, 0.2, shift, init_carry=c, seed_first=seed))(
                vol, img, carry)
        (fb, ib), cb = jax.jit(lambda v, i, c: sgm_cuda.sgm_scan_with_carry(
            v, i, 0.1, 0.2, shift, init_carry=c, seed_first=seed))(
                vol, img, carry)
        np.testing.assert_array_equal(np.asarray(cb), np.asarray(ca))
        np.testing.assert_array_equal(np.asarray(fb), np.asarray(fa))
        np.testing.assert_array_equal(np.asarray(ib), np.asarray(ia))


@pytest.mark.parametrize("name", ["golden_sgm_disparity",
                                  "golden_teddy_disparity"])
def test_golden_anchor_through_kernel(card, name):
    from stereomatch_tpu.ops.cost import ssd_cost_volume
    from stereomatch_tpu.ops.disparity import (dynamic_programming,
                                               winner_takes_all)
    from stereomatch_tpu.ops.sgm_cuda import semiglobal_aggregate_cuda
    g = np.load(DATA / f"{name}.npz")
    left, right, _ = _scene(int(g["height"]), int(g["width"]),
                            int(g["max_disparity"]), int(g["seed"]))
    vol = ssd_cost_volume(left, right, max_disparity=int(g["max_disparity"]),
                          kernel_size=int(g["kernel_size"]))
    agg = semiglobal_aggregate_cuda(vol, left, penalty1=float(g["penalty1"]),
                                    penalty2=float(g["penalty2"]))
    np.testing.assert_array_equal(np.asarray(winner_takes_all(agg)),
                                  g["wta"])
    np.testing.assert_array_equal(np.asarray(dynamic_programming(agg)),
                                  g["dp"])


@pytest.mark.parametrize("mode", ["exact", "overlap"])
def test_sharded_one_card_matches_pipeline(card, mode):
    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.parallel import ShardedPipeline, make_mesh
    left, right, _ = _scene(120, 160, 32, 9)
    ref = np.asarray(create_pipeline("ssd", "wta", "sgm", max_disparity=32)
                     .estimate(left, right))
    pipe = ShardedPipeline(make_mesh([card]), 32, sgm_mode=mode)
    np.testing.assert_array_equal(np.asarray(pipe.estimate(left, right)),
                                  ref)


def test_f32_contractions_keep_full_precision(card):
    """TF32 keeps ~10 mantissa bits: a homography applied to pixel
    coordinates near 1e3 would move samples by ~1 px.  The warp must
    match a float64 host computation to float32 accuracy."""
    from stereomatch_tpu.io.calibration import warp_perspective
    rng = np.random.default_rng(1)
    h, w = 300, 1000
    img = rng.random((h, w), np.float32)
    hmat = np.array([[1.0007, 0.0031, -3.3], [0.0012, 0.9991, 1.7],
                     [1.3e-6, -2.1e-6, 1.0]])
    out = np.asarray(warp_perspective(jnp.asarray(img), jnp.asarray(
        hmat, jnp.float32), inverse=True))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    src = np.stack([xs, ys, np.ones_like(xs)], -1) @ hmat.T
    sx, sy = src[..., 0] / src[..., 2], src[..., 1] / src[..., 2]
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    inside = (x0 >= 1) & (x0 < w - 2) & (y0 >= 1) & (y0 < h - 2)
    fx, fy = sx - x0, sy - y0
    xc, yc = np.clip(x0, 0, w - 2), np.clip(y0, 0, h - 2)
    ref = ((1 - fy) * ((1 - fx) * img[yc, xc] + fx * img[yc, xc + 1])
           + fy * ((1 - fx) * img[yc + 1, xc] + fx * img[yc + 1, xc + 1]))
    np.testing.assert_allclose(out[inside], ref[inside], atol=2e-3)
