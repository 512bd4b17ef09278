"""Stereo-matching pipeline composition.

Mirrors the reference's ``Pipeline`` (stereomatch/pipeline.py:36-94) with a
compiled-program execution model:

* The reference runs cost / aggregation / reduce as three separate native
  calls, each ending in ``cudaDeviceSynchronize`` (kernel.hpp:50,59), and
  dodges reallocation by caching output buffers across frames
  (pipeline.py:65-67).  Here ``estimate`` traces the whole
  cost -> (aggregation) -> reduce composition into ONE jitted XLA program:
  dispatch is async, stages fuse where profitable, and intermediates never
  leave device memory.  Buffer reuse across frames is what XLA's allocator does
  natively for a compiled program — no caching idiom needed.

* The reference re-uploads the left image to the GPU for aggregation
  (pipeline.py:84-87, marked TODO).  Under jit the image is already
  device-resident; nothing to fix.

* ``SSDTexture`` costs get plain-array inputs auto-wrapped in
  :class:`~stereomatch_tpu.texture.TextureImage`, like the reference's
  ``_TexCostFunctionWrapper`` (pipeline.py:22-33,55-56).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .cost import SSDTexture
from .texture import TextureImage
from .utils import profiling, validation


class _TexCostFunctionWrapper:
    """Wraps an SSDTexture cost so the pipeline can feed it plain arrays."""

    def __init__(self, cost_function: SSDTexture):
        self.cost_function = cost_function

    @property
    def max_disparity(self) -> int:
        return self.cost_function.max_disparity

    @max_disparity.setter
    def max_disparity(self, value: int) -> None:
        self.cost_function.max_disparity = value

    def __call__(self, left_image, right_image, cost_volume=None):
        return self.cost_function(
            TextureImage.from_array(left_image),
            TextureImage.from_array(right_image),
            cost_volume=cost_volume)


class Pipeline:
    """Composable stereo pipeline: cost -> optional aggregation -> reduce.

    Drop-in analogue of the reference Pipeline (stereomatch/pipeline.py:36-94).
    """

    def __init__(self, cost: Callable,
                 disparity_reduce: Callable,
                 aggregation: Optional[Callable] = None):
        """
        Args:
            cost: callable (left, right) -> [H, W, D] cost volume.
            disparity_reduce: callable (volume) -> [H, W] int32 disparity.
            aggregation: optional callable (volume, left_image) -> volume.
        """
        if isinstance(cost, SSDTexture):
            self.cost = _TexCostFunctionWrapper(cost)
        else:
            self.cost = cost
        self.disparity_reduce = disparity_reduce
        self.aggregation = aggregation

        # Diagnostic captures of the last run's intermediates, matching the
        # reference's reusable-buffer attributes (pipeline.py:65-67).
        self._cost_volume = None
        self._aggregation_volume = None
        self._disparity_image = None

    def _run(self, left_image, right_image):
        # Stage spans show up in jax.profiler captures
        # (utils/profiling.trace); the reference has no tracing at all.
        with profiling.annotate("stm/cost"):
            cost_volume = self.cost(left_image, right_image)
        if self.aggregation is not None:
            with profiling.annotate("stm/aggregation"):
                aggregation_volume = self.aggregation(cost_volume, left_image)
        else:
            aggregation_volume = cost_volume
        with profiling.annotate("stm/disparity_reduce"):
            disparity = self.disparity_reduce(aggregation_volume)
        return cost_volume, aggregation_volume, disparity

    def estimate(self, left_image, right_image) -> jnp.ndarray:
        """Run the pipeline; returns an int32 [H, W] disparity image."""
        left_image = jnp.asarray(left_image)
        right_image = jnp.asarray(right_image)
        validation.check_stereo_pair(left_image, right_image)
        (self._cost_volume, self._aggregation_volume,
         self._disparity_image) = self._run(left_image, right_image)
        return self._disparity_image

    def estimate_refined(self, left_image, right_image, *,
                         subpixel: bool = True, median: bool = True,
                         lr_check: bool = False,
                         lr_mode: str = "mirror",
                         max_diff: int = 1,
                         weighted_median: bool = False,
                         wmf_sigma: float = 10.0,
                         wmf_window: int = 5,
                         fgs_lambda: Optional[float] = None,
                         fgs_sigma: float = 8.0,
                         min_confidence: Optional[float] = None
                         ) -> jnp.ndarray:
        """Estimate + post-processing (beyond the reference's surface).

        Optional stages, in order: left-right consistency check with
        background occlusion fill (``lr_check``), guide-weighted median
        (``weighted_median`` — edge-preserving, weighted by left-image
        affinity with ``wmf_sigma`` in guide intensity units, e.g. ~10
        for 8-bit-range images), 3x3 median (``median``), parabolic
        sub-pixel interpolation on the aggregated volume (``subpixel``
        — output becomes float32), fast-global-smoother filtering
        (``fgs_lambda`` — the WLS disparity post-filter, confidence-
        weighted by the LR mask when ``lr_check`` is on, output
        float32; ``fgs_sigma`` in guide intensity units), and
        confidence gating (``min_confidence`` — pixels whose PKRN
        confidence falls below the threshold are marked unknown with the
        Middlebury 0 convention, which downstream consumers — metrics'
        valid mask, reconstruction's validity rule — already honor).
        See ops/refine.py.

        ``lr_mode`` selects how the right disparity for the check is
        obtained: ``"mirror"`` runs the full pipeline a second time on
        mirrored images (true right-image matching); ``"volume"``
        re-indexes the left aggregated volume (C_R[y,x,d] = C_L[y,x+d,d]
        — the SGBM trick, ~free but approximate where aggregation is
        asymmetric).  See ops.refine.right_volume_from_left.
        """
        from .ops import refine

        if lr_mode not in ("mirror", "volume"):
            raise ValueError(f"unknown lr_mode: {lr_mode!r}")
        disp_r = None
        if lr_check and lr_mode == "mirror":
            disp_r = refine.right_disparity(
                lambda l, r: self._run(l, r)[2],
                jnp.asarray(left_image), jnp.asarray(right_image))
        disp = self.estimate(left_image, right_image)
        if lr_check:
            if disp_r is None:
                disp_r = refine.right_disparity_from_volume(
                    self._aggregation_volume)
            mask = refine.left_right_consistency(
                disp, disp_r, max_diff,
                max_disparity=self._aggregation_volume.shape[2])
            disp = refine.fill_inconsistent(disp, mask)
        if weighted_median:
            disp = refine.weighted_median_filter(
                disp, jnp.asarray(left_image), window=wmf_window,
                sigma=wmf_sigma,
                n_bins=self._aggregation_volume.shape[2])
        if median:
            disp = refine.median_filter_3x3(disp)
        if subpixel:
            idx = jnp.clip(jnp.round(disp), 0,
                           self._aggregation_volume.shape[2] - 1)
            disp = refine.subpixel_refine(self._aggregation_volume,
                                          idx.astype(jnp.int32))
        if fgs_lambda is not None:
            conf = mask.astype(jnp.float32) if lr_check else None
            disp = refine.fgs_smooth(
                disp.astype(jnp.float32), jnp.asarray(left_image),
                lam=fgs_lambda, sigma_color=fgs_sigma, confidence=conf)
        if min_confidence is not None:
            keep = self.last_confidence() >= min_confidence
            disp = jnp.where(keep, disp, jnp.zeros((), disp.dtype))
        return disp

    def last_confidence(self) -> jnp.ndarray:
        """PKRN matching confidence [H, W] in [0, 1] for the most recent
        ``estimate`` call (computed from its aggregated volume; see
        ops.refine.confidence_pkrn)."""
        from .ops.refine import confidence_pkrn
        if self._aggregation_volume is None:
            raise RuntimeError("run estimate() before last_confidence()")
        return confidence_pkrn(self._aggregation_volume)

    def estimate_fn(self) -> Callable:
        """The pipeline as a pure function for jit / sharding composition.

        ``Pipeline.estimate`` already executes jitted stage kernels; this
        returns ``(left, right) -> disparity`` suitable for wrapping in an
        outer ``jax.jit`` (whole-pipeline fusion, donation) or ``shard_map``.
        """
        def fn(left_image, right_image):
            return self._run(left_image, right_image)[2]
        return fn

    def compiled(self, donate: bool = True) -> Callable:
        """Whole-pipeline jit: one XLA program for cost+aggregation+reduce.

        With ``donate=True`` the input image buffers are donated, giving the
        steady-state zero-allocation behaviour the reference approximates
        with its reuse-buffer idiom (pipeline.py:65-67, _common.py:15-53).
        """
        donate_argnums = (0, 1) if donate else ()
        return jax.jit(self.estimate_fn(), donate_argnums=donate_argnums)
