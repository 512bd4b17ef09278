"""Wedge-structured guided cost-volume filtering (ops/cvf.py) vs the oracle.

``create_pipeline`` passes ``wedge_offset=0`` for every registry cost, so
the prefix-plane fast path (_filter_body_wedge) is the CVF that runs.  It
must match the direct windowed oracle (tests/oracles.py, float64) across
geometries, radii, offsets and storage dtypes — same masked means,
different summation association, so allclose rather than bit-equal.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from stereomatch_tpu.ops.cvf import guided_filter_aggregate
from stereomatch_tpu.ops.disparity import winner_takes_all

from .oracles import guided_filter_oracle


def _wedge_volume(rng, h, w, d, off=0):
    vol = rng.random((h, w, d), np.float32)
    x, dd = np.meshgrid(np.arange(w), np.arange(d), indexing="ij")
    vol[:, x < dd + off] = np.inf
    return vol


def _check(vol, g, r, off, rtol=5e-4, atol=5e-5):
    got = np.asarray(guided_filter_aggregate(vol, g, radius=r,
                                             wedge_offset=off))
    ref = guided_filter_oracle(vol, g, r, 1e-4)
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=rtol, atol=atol)


@pytest.mark.parametrize("h,w,d,r,off", [
    (20, 30, 12, 3, 0),
    (17, 25, 8, 2, 3),      # nonzero disparity offset
    (33, 41, 16, 8, 0),     # radius > image-fraction
    (12, 40, 16, 1, 0),     # minimum radius
    (24, 26, 5, 4, 0),      # ragged width / non-pow2 D
])
def test_wedge_matches_oracle(h, w, d, r, off):
    rng = np.random.default_rng(h + w)
    _check(_wedge_volume(rng, h, w, d, off), rng.random((h, w), np.float32),
           r, off)


@pytest.mark.parametrize("off", [0, 1, 2])
def test_wedge_offsets_match_oracle(off):
    rng = np.random.default_rng(27 + off)
    h, w, d, r = 27, 31, 8, 4
    _check(_wedge_volume(rng, h, w, d, off), rng.random((h, w), np.float32),
           r, off)


@pytest.mark.parametrize("h,w,d,r,off", [
    (30, 72, 12, 3, 0),
    (26, 70, 8, 4, 2),
    (22, 64, 16, 8, 0),
])
def test_wide_wedge_matches_oracle(h, w, d, r, off):
    rng = np.random.default_rng(h * w)
    _check(_wedge_volume(rng, h, w, d, off), rng.random((h, w), np.float32),
           r, off)


def test_bf16_storage_roundtrip():
    rng = np.random.default_rng(4)
    vol = _wedge_volume(rng, 18, 28, 8)
    g = rng.random((18, 28), np.float32)
    out16 = guided_filter_aggregate(jnp.asarray(vol, jnp.bfloat16), g,
                                    radius=2, wedge_offset=0)
    assert out16.dtype == jnp.bfloat16
    out32 = np.asarray(guided_filter_aggregate(vol, g, radius=2,
                                               wedge_offset=0))
    m = np.isfinite(out32)
    np.testing.assert_allclose(np.asarray(out16, np.float32)[m], out32[m],
                               rtol=0.02, atol=0.01)


def test_wedge_matches_general_masked_path():
    """The wedge fast path and the general masked filter compute the same
    masked means (association-level agreement)."""
    rng = np.random.default_rng(17)
    vol = _wedge_volume(rng, 26, 34, 8, off=1)
    g = rng.random((26, 34), np.float32)
    fast = np.asarray(guided_filter_aggregate(vol, g, radius=3,
                                              wedge_offset=1))
    general = np.asarray(guided_filter_aggregate(vol, g, radius=3))
    np.testing.assert_array_equal(np.isinf(fast), np.isinf(general))
    m = np.isfinite(general)
    np.testing.assert_allclose(fast[m], general[m], rtol=2e-5, atol=2e-6)


def test_parameter_validation():
    rng = np.random.default_rng(0)
    vol = _wedge_volume(rng, 8, 12, 4)
    g = rng.random((8, 12), np.float32)
    with pytest.raises(ValueError, match="radius"):
        guided_filter_aggregate(vol, g, radius=-1, wedge_offset=0)
    with pytest.raises(ValueError, match="eps"):
        guided_filter_aggregate(vol, g, radius=2, eps=0.0, wedge_offset=0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        guided_filter_aggregate(vol, g, radius=2, wedge_offset=0,
                                assume_finite=True)


def test_wta_agreement_on_distinct_volume():
    """Integer-robust contract: identical WTA picks on a volume whose
    aggregated costs don't near-tie."""
    rng = np.random.default_rng(9)
    vol = _wedge_volume(rng, 30, 44, 16)
    g = rng.random((30, 44), np.float32)
    got = np.asarray(winner_takes_all(
        guided_filter_aggregate(vol, g, radius=4, wedge_offset=0)))
    ref = guided_filter_oracle(vol, g, 4, 1e-4).argmin(-1)
    assert (got == ref).mean() > 0.995


def test_negative_offset_rejected():
    rng = np.random.default_rng(1)
    vol = _wedge_volume(rng, 8, 12, 4)
    g = rng.random((8, 12), np.float32)
    with pytest.raises(ValueError, match="wedge_offset"):
        guided_filter_aggregate(vol, g, radius=2, wedge_offset=-1)


def test_radius_zero_is_pixelwise_model():
    """r = 0: one-pixel windows — every valid cell's linear model
    reproduces the cell (var 0 => a = 0, b = p)."""
    rng = np.random.default_rng(2)
    vol = _wedge_volume(rng, 10, 14, 6)
    g = rng.random((10, 14), np.float32)
    _check(vol, g, 0, 0)
    out = np.asarray(guided_filter_aggregate(vol, g, radius=0,
                                             wedge_offset=0))
    m = np.isfinite(vol)
    np.testing.assert_allclose(out[m], vol[m], rtol=1e-6, atol=1e-6)
