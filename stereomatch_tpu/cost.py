"""Cost-function API — class surface mirroring the reference
(stereomatch/cost.py:13-101), backed by the jitted kernels in
``stereomatch_tpu.ops.cost``.

API notes vs. the reference:
  * ``cost_volume=`` reuse arguments are accepted for source compatibility
    but ignored: the reference reuses output buffers to avoid cudaMalloc
    churn (stereomatch/_common.py:15-53); under jit, XLA owns buffers and
    the pipeline uses donation instead (see pipeline.Pipeline).
  * ``max_disparity`` is a mutable attribute, as the reference's evaluation
    workflow requires (workflows/evaluation/workflow.py:34 mutates it
    per scene).
  * ``Birchfield`` honours ``kernel_size`` (the reference has a typo'd
    ``kerne_size`` attribute and hardcodes 4, stereomatch/cost.py:90,98-99 —
    defect, not replicated; the default remains 4).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .ops.cost import (birchfield_cost_volume, census_hamming_cost_volume,
                       sad_cost_volume, ssd_cost_volume,
                       ssd_texture_cost_volume, zncc_cost_volume)
from .texture import TextureImage
from .utils import validation


class SSD:
    """Sum-of-squared-differences cost (reference: stereomatch/cost.py:13-48).

    Attributes:
        max_disparity: number of disparity hypotheses (the D axis).
        kernel_size: SSD window half-extent k; the window is [i-k, i+k).
        cost_volume_dtype: output dtype (float32 or int32).
    """

    def __init__(self, max_disparity: int, kernel_size: int = 7,
                 cost_volume_dtype=jnp.float32):
        validation.check_positive("max_disparity", max_disparity)
        validation.check_positive("kernel_size", kernel_size)
        self.max_disparity = max_disparity
        self.kernel_size = kernel_size
        self.cost_volume_dtype = cost_volume_dtype

    def __call__(self, left_image, right_image,
                 cost_volume: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        left_image = jnp.asarray(left_image)
        right_image = jnp.asarray(right_image)
        validation.check_stereo_pair(left_image, right_image)
        return ssd_cost_volume(left_image, right_image,
                               max_disparity=self.max_disparity,
                               kernel_size=self.kernel_size,
                               cost_dtype=self.cost_volume_dtype)


class SSDTexture:
    """SSD over sampled textures (reference: stereomatch/cost.py:51-77).

    Operates on :class:`~stereomatch_tpu.texture.TextureImage` inputs; the
    pipeline auto-wraps plain arrays (pipeline.py:22-33 in the reference).
    """

    def __init__(self, max_disparity: int, kernel_size: int = 7):
        validation.check_positive("max_disparity", max_disparity)
        self.max_disparity = max_disparity
        self.kernel_size = kernel_size

    def __call__(self, left_image: TextureImage, right_image: TextureImage,
                 cost_volume: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        return ssd_texture_cost_volume(left_image, right_image,
                                       max_disparity=self.max_disparity,
                                       kernel_size=self.kernel_size)


class SAD:
    """Sum-of-absolute-differences cost.

    Beyond the reference's cost surface (same window semantics as its SSD,
    src/ssd.cu, with an L1 summand): more robust to outlier pixels, and
    overflow-safe on integer inputs.

    Attributes:
        max_disparity: number of disparity hypotheses (the D axis).
        kernel_size: window half-extent k; the window is [i-k, i+k).
        cost_volume_dtype: output dtype (float32 / bfloat16 / int32).
    """

    def __init__(self, max_disparity: int, kernel_size: int = 7,
                 cost_volume_dtype=jnp.float32):
        validation.check_positive("max_disparity", max_disparity)
        validation.check_positive("kernel_size", kernel_size)
        self.max_disparity = max_disparity
        self.kernel_size = kernel_size
        self.cost_volume_dtype = cost_volume_dtype

    def __call__(self, left_image, right_image,
                 cost_volume: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        left_image = jnp.asarray(left_image)
        right_image = jnp.asarray(right_image)
        validation.check_stereo_pair(left_image, right_image)
        return sad_cost_volume(left_image, right_image,
                               max_disparity=self.max_disparity,
                               kernel_size=self.kernel_size,
                               cost_dtype=self.cost_volume_dtype)


class NCC:
    """Zero-mean normalized cross-correlation cost (cost = 1 - zncc).

    Beyond the reference's cost surface: invariant to affine (gain + bias)
    radiometric mismatch between the cameras over each window, where SSD
    and SAD degrade under any mismatch and census is lossless only for
    monotonic transforms.  Window/validity semantics match the SSD kernel
    (clipped [i-k, i+k) windows, +inf where d > c).

    Attributes:
        max_disparity: number of disparity hypotheses (the D axis).
        kernel_size: window half-extent k; the window is [i-k, i+k).
        cost_volume_dtype: output dtype (float32 or bfloat16; the
            normalization always computes float32).
    """

    def __init__(self, max_disparity: int, kernel_size: int = 7,
                 cost_volume_dtype=jnp.float32):
        validation.check_positive("max_disparity", max_disparity)
        validation.check_positive("kernel_size", kernel_size)
        self.max_disparity = max_disparity
        self.kernel_size = kernel_size
        self.cost_volume_dtype = cost_volume_dtype

    def __call__(self, left_image, right_image,
                 cost_volume: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        left_image = jnp.asarray(left_image)
        right_image = jnp.asarray(right_image)
        validation.check_stereo_pair(left_image, right_image)
        return zncc_cost_volume(left_image, right_image,
                                max_disparity=self.max_disparity,
                                kernel_size=self.kernel_size,
                                cost_dtype=self.cost_volume_dtype)


class Census:
    """Census-transform + Hamming-distance cost (Zabih–Woodfill).

    Beyond the reference's cost surface: census codes are invariant to any
    monotonic per-image intensity transform (exposure/gamma mismatch),
    where SSD and Birchfield both degrade.  Pairs naturally with SGM.

    Attributes:
        max_disparity: number of disparity hypotheses.
        window_size: census window (odd; 5x5 -> one 24-bit code word, larger windows pack several int32 words).
        kernel_size: optional clipped box-sum window over the Hamming
            costs (1 = pixelwise, the usual choice before SGM).
        cost_volume_dtype: output dtype (float32 / bfloat16 / int32).
    """

    def __init__(self, max_disparity: int, window_size: int = 5,
                 kernel_size: int = 1, cost_volume_dtype=jnp.float32):
        validation.check_positive("max_disparity", max_disparity)
        validation.check_positive("window_size", window_size)
        validation.check_positive("kernel_size", kernel_size)
        self.max_disparity = max_disparity
        self.window_size = window_size
        self.kernel_size = kernel_size
        self.cost_volume_dtype = cost_volume_dtype

    def __call__(self, left_image, right_image,
                 cost_volume: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        left_image = jnp.asarray(left_image)
        right_image = jnp.asarray(right_image)
        validation.check_stereo_pair(left_image, right_image)
        return census_hamming_cost_volume(
            left_image, right_image, max_disparity=self.max_disparity,
            window_size=self.window_size, kernel_size=self.kernel_size,
            cost_dtype=self.cost_volume_dtype)


class Birchfield:
    """Birchfield–Tomasi sampling-insensitive cost
    (reference: stereomatch/cost.py:80-101)."""

    def __init__(self, max_disparity: int, kernel_size: int = 4):
        validation.check_positive("max_disparity", max_disparity)
        validation.check_positive("kernel_size", kernel_size)
        self.max_disparity = max_disparity
        self.kernel_size = kernel_size

    def __call__(self, left_image, right_image,
                 cost_volume: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        left_image = jnp.asarray(left_image)
        right_image = jnp.asarray(right_image)
        validation.check_stereo_pair(left_image, right_image)
        return birchfield_cost_volume(left_image, right_image,
                                      max_disparity=self.max_disparity,
                                      kernel_size=self.kernel_size)
