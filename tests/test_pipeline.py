"""Full pipeline matrix, mirroring the reference's test_pipeline sweep
(tests/test_pipeline.py:15-37): cost x reduce x (none | sgm)."""

import numpy as np
import pytest

import stereomatch_tpu
from stereomatch_tpu.aggregation import Semiglobal
from stereomatch_tpu.cli_common import create_pipeline
from stereomatch_tpu.cost import SSD, Birchfield, SSDTexture
from stereomatch_tpu.disparity_reduce import DynamicProgramming, WinnerTakesAll
from stereomatch_tpu.pipeline import Pipeline


COSTS = [SSD, SSDTexture, Birchfield]
REDUCERS = [WinnerTakesAll, DynamicProgramming]
AGGREGATIONS = [None, Semiglobal]


@pytest.mark.parametrize("cost_cls", COSTS)
@pytest.mark.parametrize("reduce_cls", REDUCERS)
@pytest.mark.parametrize("aggr_cls", AGGREGATIONS)
def test_pipeline_matrix(stereo_pair_small, cost_cls, reduce_cls, aggr_cls):
    left, right = stereo_pair_small
    pipeline = Pipeline(cost_cls(pytest.STM_MAX_DISPARITY),
                        reduce_cls(),
                        aggregation=aggr_cls() if aggr_cls else None)
    disparity = np.asarray(pipeline.estimate(left, right))
    assert disparity.shape == left.shape
    assert disparity.dtype == np.int32
    assert disparity.min() >= 0
    assert disparity.max() < pytest.STM_MAX_DISPARITY


def test_pipeline_recovers_ground_truth(stereo_pair_medium):
    """End-to-end quality: SSD+SGM+WTA recovers the synthetic scene within
    a small bad-pixel ratio, and SGM does not hurt vs. raw WTA."""
    from stereomatch_tpu.metrics import bad_pixel_ratio
    left, right, gt = stereo_pair_medium
    ssd = SSD(pytest.STM_MAX_DISPARITY, kernel_size=3)
    raw = Pipeline(ssd, WinnerTakesAll())
    sgm = Pipeline(ssd, WinnerTakesAll(), aggregation=Semiglobal())

    d_raw = np.asarray(raw.estimate(left, right))
    d_sgm = np.asarray(sgm.estimate(left, right))

    # Ignore the left band where disparities are clamped by d <= x validity.
    sl = np.s_[:, pytest.STM_MAX_DISPARITY:]
    bad_raw = float(bad_pixel_ratio(d_raw[sl], gt[sl], threshold=1.0))
    bad_sgm = float(bad_pixel_ratio(d_sgm[sl], gt[sl], threshold=1.0))
    assert bad_raw < 0.15
    assert bad_sgm <= bad_raw + 0.02


def test_pipeline_texture_cost_auto_wraps(stereo_pair_small):
    """SSDTexture pipelines accept plain arrays (reference pipeline.py:55-56)
    and agree with the tensor path exactly."""
    left, right = stereo_pair_small
    tex_pipeline = Pipeline(SSDTexture(pytest.STM_MAX_DISPARITY),
                            WinnerTakesAll())
    ssd_pipeline = Pipeline(SSD(pytest.STM_MAX_DISPARITY), WinnerTakesAll())
    np.testing.assert_array_equal(
        np.asarray(tex_pipeline.estimate(left, right)),
        np.asarray(ssd_pipeline.estimate(left, right)))


def test_pipeline_compiled_whole_program(stereo_pair_small):
    """Whole-pipeline jit returns the same disparities as stagewise calls."""
    left, right = stereo_pair_small
    pipeline = Pipeline(SSD(pytest.STM_MAX_DISPARITY), WinnerTakesAll(),
                        aggregation=Semiglobal())
    fn = pipeline.compiled(donate=False)
    np.testing.assert_array_equal(np.asarray(fn(left, right)),
                                  np.asarray(pipeline.estimate(left, right)))


def test_create_pipeline_registry():
    p = create_pipeline("ssd", "wta", "sgm", max_disparity=8)
    assert isinstance(p.cost, SSD)
    assert isinstance(p.disparity_reduce, WinnerTakesAll)
    assert isinstance(p.aggregation, Semiglobal)
    p2 = create_pipeline("birchfield", "dyn", None)
    assert isinstance(p2.cost, Birchfield)
    assert p2.aggregation is None


def test_create_pipeline_plumbs_penalties_and_backend():
    """SGM penalties and the SGM backend must reach the stage objects
    from the factory (the DP reducer has one implementation)."""
    p = create_pipeline("ssd", "dyn", "sgm", max_disparity=8,
                        penalty1=0.4, penalty2=0.9, backend="xla")
    assert p.aggregation.penalty1 == 0.4
    assert p.aggregation.penalty2 == 0.9
    assert p.aggregation.backend == "xla"
    assert not hasattr(p.disparity_reduce, "backend")


def test_create_pipeline_volume_dtype(stereo_pair_small):
    import jax.numpy as jnp
    left, right = stereo_pair_small
    p = create_pipeline("ssd", "wta", "sgm", max_disparity=8,
                        volume_dtype="bfloat16")
    assert p.cost.cost_volume_dtype == jnp.bfloat16
    disp = np.asarray(p.estimate(left, right))
    assert disp.dtype == np.int32
    with pytest.raises(ValueError):
        create_pipeline("ssd", "wta", "sgm", volume_dtype="int32")
    p_int = create_pipeline("ssd", "wta", None, max_disparity=8,
                            volume_dtype="int32")
    assert np.asarray(p_int.estimate(left, right)).dtype == np.int32


def test_max_disparity_is_mutable(stereo_pair_small):
    """The eval workflow mutates cost.max_disparity per scene
    (workflows/evaluation/workflow.py:34)."""
    left, right = stereo_pair_small
    pipeline = create_pipeline("ssd", "wta", None, max_disparity=8)
    d8 = np.asarray(pipeline.estimate(left, right))
    pipeline.cost.max_disparity = 16
    d16 = np.asarray(pipeline.estimate(left, right))
    assert d8.max() < 8
    assert d16.max() < 16
    assert pipeline._cost_volume.shape[2] == 16


def test_package_exports():
    assert stereomatch_tpu.Pipeline is Pipeline
    assert hasattr(stereomatch_tpu, "metrics")
    assert hasattr(stereomatch_tpu, "io")


def test_pipeline_is_deterministic(stereo_pair_small):
    """Two runs produce bit-identical disparities.

    The reference tolerates a benign GPU accumulation race by kernel-launch
    ordering (SURVEY.md §5 'race detection'); here determinism comes from
    functional purity, so it is asserted outright.
    """
    import numpy as np
    from stereomatch_tpu.aggregation import Semiglobal
    from stereomatch_tpu.cost import SSD
    from stereomatch_tpu.disparity_reduce import WinnerTakesAll
    from stereomatch_tpu.pipeline import Pipeline

    left, right = stereo_pair_small
    pipe = Pipeline(SSD(16, kernel_size=3), WinnerTakesAll(),
                    aggregation=Semiglobal())
    a = np.asarray(pipe.estimate(left, right))
    b = np.asarray(pipe.estimate(left, right))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(Pipeline(SSD(16, kernel_size=3), WinnerTakesAll(),
                            aggregation=Semiglobal()).estimate(left, right))
    np.testing.assert_array_equal(a, c)


def test_torch_tensor_inputs():
    """Migration parity: the reference's users hold torch tensors
    (stereomatch/pipeline.py operates on them); every entry point here
    accepts them via the NumPy protocol — no conversion code needed when
    switching."""
    torch = pytest.importorskip("torch")
    from stereomatch_tpu.cli_common import create_pipeline
    gen = torch.Generator().manual_seed(0)
    left = torch.rand(24, 32, generator=gen)
    right = torch.rand(24, 32, generator=gen)
    pipe = create_pipeline("ssd", "wta", "sgm", max_disparity=8)
    out = np.asarray(pipe.estimate(left, right))
    ref = np.asarray(pipe.estimate(left.numpy(), right.numpy()))
    np.testing.assert_array_equal(out, ref)


def test_unknown_aggregation_method_raises():
    """A mistyped aggregation token must fail loudly, not silently run
    with no aggregation under the mistyped label (stm-eval feeds user
    config strings straight through)."""
    with pytest.raises(ValueError, match="unknown aggregation method"):
        create_pipeline("ssd", "wta", "cfv", max_disparity=8)
