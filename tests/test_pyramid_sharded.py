"""Row-sharded coarse-to-fine pyramid vs the single-chip pyramid.

Same oracle pattern as tests/test_parallel.py: the single-chip
PyramidPipeline is the trusted implementation; the mesh program must
bit-match it.  Every pyramid stage is exactly reconstructible under row
sharding (census halos, exact SGM hand-off, row-local band scan,
edge-replicated median halos — see parallel/pyramid_sharded.py), so
``sgm_mode="exact"`` asserts full equality, and overlap mode is exact
whenever the warm-up covers all predecessors.
"""

import numpy as np
import pytest

import jax

from stereomatch_tpu.parallel import make_mesh, make_pyramid_sharded_estimate
from stereomatch_tpu.pyramid import PyramidPipeline

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair

D = STM_MAX_DISPARITY


@pytest.fixture(scope="module")
def pair():
    left, right, _ = synthetic_stereo_pair(32, 48, D, seed=3)
    return left, right


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "tests need the 8-device CPU mesh"
    return make_mesh(jax.devices()[:8], n_batch=2)


def _run(fn, left, right):
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], out[1])
    return out[0]


@pytest.mark.parametrize("levels", [1, 2])
def test_exact_mode_matches_single_chip(pair, mesh, levels):
    left, right = pair
    ref = np.asarray(PyramidPipeline(D, levels=levels,
                                     backend="xla").estimate(left, right))
    fn = make_pyramid_sharded_estimate(mesh, max_disparity=D, levels=levels,
                                       backend="xla")
    np.testing.assert_array_equal(_run(fn, left, right), ref)


def test_cuda_branch_matches_single_chip(pair, mesh, monkeypatch):
    """The coarse SGM's kernel branch (backend="cuda"), run on the CPU
    through the kernel's sweep contract on the XLA scan."""
    from .sgm_kernel_model import substitute_kernel
    substitute_kernel(monkeypatch)
    left, right = pair
    ref = np.asarray(PyramidPipeline(D, levels=1,
                                     backend="xla").estimate(left, right))
    fn = make_pyramid_sharded_estimate(mesh, max_disparity=D, levels=1,
                                       backend="cuda")
    np.testing.assert_array_equal(_run(fn, left, right), ref)


def test_overlap_covering_all_predecessors_is_exact(pair, mesh):
    left, right = pair
    ref = np.asarray(PyramidPipeline(D, levels=1,
                                     backend="xla").estimate(left, right))
    fn = make_pyramid_sharded_estimate(mesh, max_disparity=D, levels=1,
                                       backend="xla", sgm_mode="overlap",
                                       overlap=left.shape[0])
    np.testing.assert_array_equal(_run(fn, left, right), ref)


def test_small_overlap_stays_close(pair, mesh):
    left, right = pair
    ref = np.asarray(PyramidPipeline(D, levels=1,
                                     backend="xla").estimate(left, right))
    fn = make_pyramid_sharded_estimate(mesh, max_disparity=D, levels=1,
                                       backend="xla", sgm_mode="overlap",
                                       overlap=2)
    out = _run(fn, left, right)
    assert (out != ref).mean() < 0.05


def test_validation():
    mesh = make_mesh(jax.devices()[:8], n_batch=2)
    with pytest.raises(ValueError):
        make_pyramid_sharded_estimate(mesh, max_disparity=D, levels=0)
    with pytest.raises(ValueError):
        make_pyramid_sharded_estimate(mesh, max_disparity=18, levels=2)


def test_subpixel_matches_single_chip_refined(pair, mesh):
    left, right = pair
    ref = np.asarray(PyramidPipeline(D, levels=1, backend="xla")
                     .estimate_refined(left, right))
    fn = make_pyramid_sharded_estimate(mesh, max_disparity=D, levels=1,
                                       backend="xla", subpixel=True)
    out = _run(fn, left, right)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_median_off_matches_single_chip(pair, mesh):
    left, right = pair
    ref = np.asarray(PyramidPipeline(D, levels=1, median=False,
                                     backend="xla").estimate(left, right))
    fn = make_pyramid_sharded_estimate(mesh, max_disparity=D, levels=1,
                                       backend="xla", median=False)
    np.testing.assert_array_equal(_run(fn, left, right), ref)
