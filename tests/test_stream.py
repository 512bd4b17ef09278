"""Streaming/batched video estimation tests (CPU, synthetic Y4M)."""

import numpy as np
import pytest

from stereomatch_tpu import native
from stereomatch_tpu.io.capture import Y4MCapture
from stereomatch_tpu.stream import StreamingEstimator

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair

D = STM_MAX_DISPARITY


@pytest.fixture(scope="module")
def y4m_stream(tmp_path_factory):
    if not native.available():
        pytest.skip("native toolchain unavailable")
    left, right, gt = synthetic_stereo_pair(32, 48, D, seed=3)
    sbs = np.concatenate([(left * 255).astype(np.uint8),
                          (right * 255).astype(np.uint8)], axis=1)
    path = tmp_path_factory.mktemp("stream") / "v.y4m"
    native.write_y4m(path, np.stack([sbs] * 10))
    return path, left, right, gt


def _run(path, batch, max_frames=None, **kwargs):
    est = StreamingEstimator(D, batch=batch, kernel_size=3, **kwargs)
    cap = Y4MCapture(path, prefetch=2)
    outs = list(est.run(cap, max_frames=max_frames))
    cap.close()
    return est, outs


def test_stream_counts_and_consistency(y4m_stream):
    path, left, right, _ = y4m_stream
    est, outs = _run(path, batch=4, aggregation="sgm", reducer="wta")
    assert len(outs) == 10
    assert est.stats.frames == 10
    assert est.stats.batches == 3          # 4 + 4 + padded 2
    for gray, disp in outs:
        assert disp.shape == gray.shape == (32, 48)
        np.testing.assert_array_equal(disp, outs[0][1])


def test_estimate_batch_uint8_equals_float32():
    """uint8 frame stacks upload narrow and widen on device — results
    must bit-match float32 uploads of the same integer values."""
    est = StreamingEstimator(D, batch=2, kernel_size=3,
                             aggregation="sgm", reducer="wta")
    left, right, _ = synthetic_stereo_pair(24, 32, D, seed=9)
    l8 = (left * 255).astype(np.uint8)
    r8 = (right * 255).astype(np.uint8)
    a = np.asarray(est.estimate_batch(np.stack([l8] * 2),
                                      np.stack([r8] * 2)))
    b = np.asarray(est.estimate_batch(
        np.stack([l8.astype(np.float32)] * 2),
        np.stack([r8.astype(np.float32)] * 2)))
    np.testing.assert_array_equal(a, b)


def test_stream_matches_single_frame_pipeline(y4m_stream):
    """Batched streaming output equals the unbatched jitted pipeline on the
    same (uint8-quantized) frames."""
    path, *_ = y4m_stream
    _, outs = _run(path, batch=4, aggregation="sgm", reducer="wta",
                   max_frames=1)
    from stereomatch_tpu.aggregation import Semiglobal
    from stereomatch_tpu.cost import SSD
    from stereomatch_tpu.disparity_reduce import WinnerTakesAll
    gray, disp = outs[0]
    cap = Y4MCapture(path)
    ok, img = cap.read_next()
    cap.close()
    assert ok
    vol = SSD(D, kernel_size=3)(np.float32(img.left), np.float32(img.right))
    ref = np.asarray(WinnerTakesAll()(Semiglobal()(vol,
                                                   np.float32(img.left))))
    np.testing.assert_array_equal(disp, ref)


def test_stream_uneven_tail(y4m_stream):
    path, *_ = y4m_stream
    est, outs = _run(path, batch=4, aggregation=None, reducer="wta",
                     max_frames=6)
    assert len(outs) == 6
    assert est.stats.frames == 6


def test_stream_dp_reducer(y4m_stream):
    path, *_ = y4m_stream
    _, outs = _run(path, batch=2, aggregation=None,
                   reducer="dynamic_programming", max_frames=2)
    assert len(outs) == 2


@pytest.mark.parametrize("lr_mode", ["volume", "mirror"])
def test_stream_lr_check_matches_pipeline(lr_mode):
    """Streaming LR occlusion handling equals Pipeline.estimate_refined
    with the same lr_mode, bit-for-bit."""
    from stereomatch_tpu.aggregation import Semiglobal
    from stereomatch_tpu.cost import SSD
    from stereomatch_tpu.disparity_reduce import WinnerTakesAll
    from stereomatch_tpu.pipeline import Pipeline
    est = StreamingEstimator(D, batch=2, kernel_size=3,
                             aggregation="sgm", reducer="wta",
                             backend="xla", lr_check=True, lr_mode=lr_mode)
    left, right, _ = synthetic_stereo_pair(24, 32, D, seed=9)
    out = np.asarray(est.estimate_batch(np.stack([left] * 2),
                                        np.stack([right] * 2)))
    pipe = Pipeline(SSD(D, kernel_size=3), WinnerTakesAll(),
                    Semiglobal(backend="xla"))
    ref = np.asarray(pipe.estimate_refined(left, right, subpixel=False,
                                           median=False, lr_check=True,
                                           lr_mode=lr_mode))
    np.testing.assert_array_equal(out[0], ref)
    np.testing.assert_array_equal(out[1], ref)


def test_stream_fgs_matches_pipeline():
    """Streaming FGS (with volume-LR confidence) matches
    Pipeline.estimate_refined's chain (tight tolerance: XLA fuses the
    elementwise system-building differently inside the lax.map program,
    float-associativity noise only)."""
    from stereomatch_tpu.aggregation import Semiglobal
    from stereomatch_tpu.cost import SSD
    from stereomatch_tpu.disparity_reduce import WinnerTakesAll
    from stereomatch_tpu.pipeline import Pipeline
    est = StreamingEstimator(D, batch=2, kernel_size=3,
                             aggregation="sgm", reducer="wta",
                             backend="xla", lr_check=True, lr_mode="volume",
                             fgs_lambda=64.0, fgs_sigma=0.05)
    left, right, _ = synthetic_stereo_pair(24, 32, D, seed=9)
    out = np.asarray(est.estimate_batch(np.stack([left] * 2),
                                        np.stack([right] * 2)))
    pipe = Pipeline(SSD(D, kernel_size=3), WinnerTakesAll(),
                    Semiglobal(backend="xla"))
    ref = np.asarray(pipe.estimate_refined(
        left, right, subpixel=False, median=False, lr_check=True,
        lr_mode="volume", fgs_lambda=64.0, fgs_sigma=0.05))
    np.testing.assert_allclose(out[0], ref, atol=1e-3)
    np.testing.assert_array_equal(out[0], out[1])


def test_stream_depth_and_narrowed_fetch(y4m_stream):
    """run() narrows int32 disparities to uint8 for the fetch (4x fewer
    device->host bytes) and widens back on the host; deeper in-flight
    windows yield identical frames in order."""
    path, left, right, _ = y4m_stream
    _, ref = _run(path, batch=4, aggregation="sgm", reducer="wta")
    for depth in (1, 3):
        est, outs = _run(path, batch=4, depth=depth,
                         aggregation="sgm", reducer="wta")
        assert len(outs) == len(ref)
        for (g0, d0), (g1, d1) in zip(ref, outs):
            assert d1.dtype == np.int32            # contract unchanged
            np.testing.assert_array_equal(d0, d1)
        split = est.stats.stage_ms_per_frame()
        assert set(split) == {"decode", "dispatch", "fetch", "other",
                              "total"}
        assert split["total"] > 0


def test_stream_narrow_helper_dtypes():
    import jax.numpy as jnp
    est = StreamingEstimator(D, batch=1, kernel_size=3)
    out = est._narrow_for_fetch(jnp.zeros((2, 4, 4), jnp.int32))
    assert out.dtype == jnp.uint8                 # D = 16 <= 256
    big = StreamingEstimator(512, batch=1, kernel_size=3)
    out = big._narrow_for_fetch(jnp.zeros((2, 4, 4), jnp.int32))
    assert out.dtype == jnp.uint16
    f32 = est._narrow_for_fetch(jnp.zeros((2, 4, 4), jnp.float32))
    assert f32.dtype == jnp.float32               # refined passthrough


def test_stream_depth_validation():
    import pytest
    with pytest.raises(ValueError, match="depth"):
        StreamingEstimator(D, batch=2, depth=0)
