"""SSD/SAD cost volumes vs the NumPy window oracles over a geometry sweep.

The XLA separable-box formulation (ops/cost.py) is the only cost path;
here it meets the direct per-pixel window oracle (tests/oracles.py):
  * within float32 summation-order error on float images;
  * bit-exactly on the integer chain (uint8/int16 -> int32 cost: integer
    addition is associative, so summation order is invisible);
  * with identical +inf / int-max placement (the d > col validity rule,
    src/ssd.cu:58-60).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from stereomatch_tpu.cost import SAD, SSD
from stereomatch_tpu.ops.cost import sad_cost_volume, ssd_cost_volume

from .oracles import sad_oracle, ssd_oracle

INT_MAX = np.iinfo(np.int32).max

# Geometry sweep: tall/wide/tiny, k from degenerate 1 to the default 7,
# heights that are prime, divisible by 8, and < k.
SHAPES = [
    (16, 24, 8, 3),
    (46, 56, 16, 7),     # teddy-like aspect at 1/8 scale
    (9, 33, 8, 1),
    (5, 12, 16, 7),      # H < k: every window clips
    (1, 10, 4, 2),       # single row
    (24, 32, 32, 5),
    (13, 17, 8, 4),      # prime H and W
    (40, 30, 8, 7),      # W < 2k at the left-validity boundary
]


def _ids(s):
    return f"{s[0]}x{s[1]}d{s[2]}k{s[3]}"


def _compare_float(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-5, atol=1e-5)


def _compare_int(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    fin = np.isfinite(ref)
    assert (out[~fin] == INT_MAX).all()
    np.testing.assert_array_equal(out[fin], ref[fin].astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_ssd_float_matches_oracle(shape):
    h, w, d, k = shape
    rng = np.random.default_rng(h * 100 + w)
    left = rng.random((h, w), np.float32)
    right = rng.random((h, w), np.float32)
    _compare_float(ssd_cost_volume(left, right, max_disparity=d,
                                   kernel_size=k),
                   ssd_oracle(left, right, d, k))


@pytest.mark.parametrize("shape", SHAPES[:4], ids=_ids)
def test_sad_float_matches_oracle(shape):
    h, w, d, k = shape
    rng = np.random.default_rng(h + w)
    left = rng.random((h, w), np.float32)
    right = rng.random((h, w), np.float32)
    _compare_float(sad_cost_volume(left, right, max_disparity=d,
                                   kernel_size=k),
                   sad_oracle(left, right, d, k))


@pytest.mark.parametrize("in_dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("absolute", [False, True], ids=["ssd", "sad"])
def test_integer_chain_bit_exact(in_dtype, absolute):
    """uint8/int16 images -> int32 cost (the reference's type_dispatch.hpp
    matrix, src/type_dispatch.hpp:38-110)."""
    rng = np.random.default_rng(3)
    h, w, d, k = 21, 33, 16, 5
    lo, hi = (0, 255) if in_dtype == np.uint8 else (-300, 300)
    left = rng.integers(lo, hi, (h, w)).astype(in_dtype)
    right = rng.integers(lo, hi, (h, w)).astype(in_dtype)
    fn, oracle = ((sad_cost_volume, sad_oracle) if absolute
                  else (ssd_cost_volume, ssd_oracle))
    _compare_int(fn(left, right, max_disparity=d, kernel_size=k,
                    cost_dtype=jnp.int32),
                 oracle(left, right, d, k))


def test_bf16_storage():
    """bf16 output: f32 compute narrowed once — within one bf16 ulp of the
    oracle."""
    rng = np.random.default_rng(7)
    h, w, d, k = 32, 48, 16, 7
    left = rng.random((h, w), np.float32)
    right = rng.random((h, w), np.float32)
    out = np.asarray(ssd_cost_volume(left, right, max_disparity=d,
                                     kernel_size=k, cost_dtype=jnp.bfloat16
                                     ).astype(jnp.float32))
    ref = ssd_oracle(left, right, d, k)
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    rel = np.abs(out[fin] - ref[fin]) / np.maximum(np.abs(ref[fin]), 1e-30)
    assert rel.max() <= 1 / 128, rel.max()   # one bf16 ulp


def test_validity_identical_to_oracle_on_integer_ramp():
    """Distinct-value integer volume: the int-max cells and every finite
    cell agree exactly, so downstream argmin tie-breaks cannot diverge
    (the reference's distinct-value test design,
    tests/test_winners_take_all.py:31-33)."""
    h, w, d, k = 12, 40, 8, 3
    left = (np.arange(h * w).reshape(h, w) % 251).astype(np.uint8)
    right = ((np.arange(h * w).reshape(h, w) * 7) % 251).astype(np.uint8)
    _compare_int(ssd_cost_volume(left, right, max_disparity=d,
                                 kernel_size=k, cost_dtype=jnp.int32),
                 ssd_oracle(left, right, d, k))


@pytest.mark.parametrize("cls,fn", [(SSD, ssd_cost_volume),
                                    (SAD, sad_cost_volume)],
                         ids=["ssd", "sad"])
def test_api_classes_match_functional(cls, fn):
    rng = np.random.default_rng(11)
    left = rng.random((18, 26), np.float32)
    right = rng.random((18, 26), np.float32)
    np.testing.assert_array_equal(
        np.asarray(cls(8, kernel_size=3)(left, right)),
        np.asarray(fn(left, right, max_disparity=8, kernel_size=3)))


def test_sad_disparity_offset_blocks_concatenate():
    """Cost blocks at increasing offsets tile the full-D volume exactly
    (what the disparity-sharded pipeline relies on)."""
    rng = np.random.default_rng(5)
    left = rng.random((16, 40), np.float32)
    right = rng.random((16, 40), np.float32)
    full = np.asarray(sad_cost_volume(left, right, max_disparity=16,
                                      kernel_size=3))
    blocks = [np.asarray(sad_cost_volume(left, right, max_disparity=4,
                                         kernel_size=3, disparity_offset=o))
              for o in (0, 4, 8, 12)]
    np.testing.assert_array_equal(np.concatenate(blocks, axis=2), full)


def test_identical_images_cost_zero_at_zero_disparity():
    rng = np.random.default_rng(9)
    img = rng.random((20, 30), np.float32)
    vol = np.asarray(ssd_cost_volume(img, img, max_disparity=6,
                                     kernel_size=4))
    np.testing.assert_array_equal(vol[:, :, 0], 0.0)
    assert (vol[:, 6:, 1:] > 0).all()
