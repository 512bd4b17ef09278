"""Test configuration.

Tests run on the XLA:CPU backend with 8 virtual devices so that sharding
tests exercise a real mesh without accelerator hardware.  The one
exception is the hardware tier (``pytest -m gpu``,
tests/test_gpu_hardware.py), which runs on the machine's GPU and skips
where there is none.  The device-count flag must be set before jax
initializes its backends, hence the top-of-file placement; it affects
only the host platform.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
from pathlib import Path  # noqa: E402
import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The reference pins these in pytest_configure (tests/conftest.py:81-86).
STM_MAX_DISPARITY = 16
TEST_OUTPUT_PATH = Path(__file__).parent / "test-result"


def synthetic_stereo_pair(height: int, width: int, max_disparity: int,
                          seed: int = 7):
    """Flat-warp scene with exact ground truth (see io.synthetic).

    The reference test suite uses the Middlebury 2003 *teddy* pair
    (tests/conftest.py:15-31), which cannot be fetched offline; this scene
    plays the same role and additionally provides exact ground truth for
    bad-pixel metrics (the reference has none checked in).
    """
    from stereomatch_tpu.io.synthetic import stereo_pair
    return stereo_pair(height, width, max_disparity, seed)


def synthetic_stereo_pair_occluded(height: int, width: int,
                                   max_disparity: int, seed: int = 7,
                                   n_boxes: int = 3):
    """Occlusion-aware scene with an exact occlusion mask (io.synthetic)."""
    from stereomatch_tpu.io.synthetic import stereo_pair_occluded
    return stereo_pair_occluded(height, width, max_disparity, seed, n_boxes)


@dataclasses.dataclass
class CostFixture:
    """Mirrors the reference's CostFixture (tests/conftest.py:34-50)."""
    volume: np.ndarray
    left_image: np.ndarray


@pytest.fixture(scope="session")
def stereo_pair_small():
    """Small pair for exact oracle comparisons (oracles are O(HWDk^2))."""
    left, right, gt = synthetic_stereo_pair(21, 33, STM_MAX_DISPARITY)
    return left, right


@pytest.fixture(scope="session")
def stereo_pair_medium():
    """Teddy-shaped (scaled-down) pair for integration/metric tests."""
    return synthetic_stereo_pair(64, 128, STM_MAX_DISPARITY)


@pytest.fixture(scope="session")
def ssd_cost_small(stereo_pair_small):
    """SSD cost volume fixture for aggregation/reduce tests, like the
    reference's ssd_cost fixture (tests/conftest.py:53-78)."""
    from stereomatch_tpu.ops.cost import ssd_cost_volume
    left, right = stereo_pair_small
    vol = np.asarray(ssd_cost_volume(left, right,
                                     max_disparity=STM_MAX_DISPARITY))
    return CostFixture(volume=vol, left_image=left)


def pytest_configure(config):
    # The selection, not the machine, picks the platform: the hardware
    # tier runs on the default (accelerator) backend, everything else on
    # the CPU — so every worker collects and runs the same tests.
    if config.option.markexpr.strip() != "gpu":
        jax.config.update("jax_platforms", "cpu")
    pytest.STM_TEST_OUTPUT_PATH = TEST_OUTPUT_PATH
    pytest.STM_MAX_DISPARITY = STM_MAX_DISPARITY
    TEST_OUTPUT_PATH.mkdir(exist_ok=True, parents=True)
