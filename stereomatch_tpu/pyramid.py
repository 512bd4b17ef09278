"""Coarse-to-fine pyramid estimation: full SGM at reduced resolution,
per-pixel disparity-band refinement at full resolution.

Beyond the reference's capability surface (it always searches the full
disparity range at full resolution).  The dominant cost of the engine is
the [H, W, D] volume: halving each image axis AND the disparity range
divides volume work by 8 per level, so the full census+SGM+WTA pipeline
runs on a volume 8^levels times smaller, and each finer level only
re-scores a narrow band of candidates around the upsampled prediction —
O(H * W * band) pixelwise census/Hamming work with no [H, W, D] volume
materialized at full resolution at all.

The band stage is census-based on purpose: Hamming matching is
*pixelwise*, so per-pixel dynamic band offsets need no windowed sums
across neighbors (which would break the separable box-filter trick the
windowed costs rely on) — a [H, W, 2r+1] band of xor/popcount work.

Accuracy trade-off: structures thinner than 2^levels pixels can vanish
at the coarse level and a band of +-r cannot recover a miss larger than
r; tests pin the synthetic-scene regression (tests/test_pyramid.py) and
``stm-eval --configs`` quantifies it on real data.

Because the band scan iterates the FULL disparity axis with masking
(the gather-free formulation), a wider band is accuracy for free — the
round-3 sweep (benchmarks/pyramid_sweep.py) moved the defaults to
band_radius=24 + band_kernel_size=5 (windowed Hamming), taking the
pyramid1 bad-pixel rate from 2.28% to 1.09% on the occlusion-aware
suite (flat census+SGM: 0.56%); stronger coarse penalties
(penalty1=0.2, penalty2=0.4) reach 0.89% / 0.71% at levels 1 / 2 —
recommended when the pyramid is the primary mode rather than a preview.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .ops.cost import census_hamming_cost_volume, census_transform
from .ops.disparity import winner_takes_all
from .utils import validation
from .utils.backend import resolve_backend, semiglobal_fn


def downsample2(image: jnp.ndarray) -> jnp.ndarray:
    """2x2 mean pooling (both axes must be even)."""
    h, w = image.shape
    pooled = image.astype(jnp.float32).reshape(h // 2, 2, w // 2, 2)
    return pooled.mean(axis=(1, 3))


def upsample2_nearest(disparity: jnp.ndarray) -> jnp.ndarray:
    """Nearest 2x upsampling of a disparity map, values doubled
    (one coarse pixel = two fine pixels; one coarse disparity = two)."""
    up = jnp.repeat(jnp.repeat(disparity, 2, axis=0), 2, axis=1)
    return up * 2


def band_refine_census(left: jnp.ndarray, right: jnp.ndarray,
                       predicted: jnp.ndarray, *,
                       band_radius: int,
                       max_disparity: int,
                       window_size: int = 5,
                       band_kernel_size: int = 1,
                       row_valid=None,
                       subpixel: bool = False,
                       return_best_cost: bool = False) -> jnp.ndarray:
    """Re-score disparities in [predicted - r, predicted + r] per pixel.

    Census/Hamming over the band only: codes are computed once per image,
    candidates gathered from the right code map at x - d (clamped), and
    invalid candidates (d < 0, d > x, d >= max_disparity) masked out.
    The band is anchored at ``predicted - r`` and clipped to stay inside
    [0, max_disparity), so every pixel scores the full 2r+1 candidates
    even at the range ends.  Ties break toward the lowest disparity,
    matching winner_takes_all.

    With ``subpixel`` the scan additionally carries the winner's
    neighbour costs c(d*-1)/c(d*+1) (two extra selects per plane — no
    volume, no gather) and the output becomes float32: the parabolic
    vertex ``d* + (cm - cp) / (2 (cm - 2 c0 + cp))`` clamped to ±0.5,
    falling back to the integer winner at band borders and degenerate
    fits — the same rule as ops/refine.py::subpixel_refine, evaluated
    in-scan instead of by gathering from a cost volume.

    With ``return_best_cost`` also returns the winning Hamming distance
    per pixel (int32; all-invalid pixels get window_size**2, the worst
    possible value) — the anchor-drift signal :class:`~stereomatch_tpu.
    temporal.TemporalPipeline` uses to decide when a keyframe is due.

    Gather-free formulation: instead of a per-pixel dynamic gather, the
    scan runs over the FULL disparity axis as D static-shape dynamic
    slices of the right code map, masking each plane to the band —
    O(H*W*D) elementwise work (xor/popcount/compare per plane), nothing
    but the two code maps and the output touching device memory, and no
    [H, W, D] volume materialized.
    """
    height, width = left.shape
    r = band_radius
    n_band = 2 * r + 1

    code_l = census_transform(left, window_size)             # [H, W] int32
    code_r = census_transform(right, window_size)

    base = jnp.clip(predicted.astype(jnp.int32) - r, 0,
                    max(max_disparity - n_band, 0))          # [H, W]
    x = lax.broadcasted_iota(jnp.int32, (height, width), 1)
    # padded[y, x + D - d] == code_r[y, x - d]
    padded_r = jnp.pad(code_r, ((0, 0), (max_disparity, 0)))
    big = jnp.int32(1 << 20)

    k2 = band_kernel_size // 2

    def plane(d, carry):
        best_cost, best_d, prev_cost, c_minus, c_plus = carry
        shifted = lax.dynamic_slice(
            padded_r, (0, max_disparity - d), (height, width))
        ham = lax.population_count(code_l ^ shifted)
        if k2:
            # Windowed Hamming (band_kernel_size > 1): box-sum each
            # plane so the band WTA gets the neighborhood support the
            # flat census cost's kernel_size provides — plane-local
            # work, still no [H, W, D] volume.  Same-disparity windows
            # only (the band varies per pixel); columns left of the
            # d <= x validity edge contribute the worst Hamming value,
            # biasing that fringe conservatively.
            worst = jnp.int32(window_size * window_size)
            filt = jnp.where(x >= d, ham, worst)
            if row_valid is not None:
                # Sharded callers hand rows padded past the TRUE image
                # edge (ppermute zero fill): those must contribute the
                # single-chip box's zero padding, not the worst-cost
                # fringe fill.  Interior tile-halo rows are real image
                # rows and stay live.
                filt = jnp.where(row_valid[:, None], filt, 0)
            filt = lax.reduce_window(
                filt, jnp.int32(0), lax.add,
                window_dimensions=(2 * k2 + 1, 1), window_strides=(1, 1),
                padding=((k2, k2), (0, 0)))
            filt = lax.reduce_window(
                filt, jnp.int32(0), lax.add,
                window_dimensions=(1, 2 * k2 + 1), window_strides=(1, 1),
                padding=((0, 0), (k2, k2)))
            ham = filt
        valid = (d >= base) & (d < base + n_band) & (d <= x)
        cost = jnp.where(valid, ham, big)
        better = cost < best_cost                 # ties keep the lower d
        if subpixel:
            # Winner's neighbours ride along: c(d*-1) is the previous
            # plane at the update step; c(d*+1) is the next plane (the
            # step after an update and only if no newer winner took it).
            c_minus = jnp.where(better, prev_cost, c_minus)
            c_plus = jnp.where(better, big,
                               jnp.where(jnp.equal(d, best_d + 1),
                                         cost, c_plus))
        return (jnp.where(better, cost, best_cost),
                jnp.where(better, d, best_d), cost, c_minus, c_plus)

    # Derive the carry seeds from code_l (not fresh constants) so they
    # inherit its shard_map varying type — the fori_loop carry must keep
    # a stable type when this runs inside a mesh program (pyramid_sharded).
    full = jnp.full_like(code_l, big)
    init = (full, jnp.zeros_like(code_l), full, full, full)
    best_cost, best_d, _, c_minus, c_plus = lax.fori_loop(
        0, max_disparity, plane, init)

    # All-invalid pixels (x < base for the whole band) fall back to the
    # largest valid disparity at that column (d = x), as close to the
    # prediction as the image geometry allows.
    any_valid = best_cost < big
    out = jnp.where(any_valid, best_d, x)
    if subpixel:
        cm = c_minus.astype(jnp.float32)
        c0 = best_cost.astype(jnp.float32)
        cp = c_plus.astype(jnp.float32)
        denom = cm - 2.0 * c0 + cp
        offset = jnp.where(jnp.abs(denom) > 1e-12,
                           (cm - cp) / (2.0 * denom), 0.0)
        offset = jnp.clip(offset, -0.5, 0.5)
        interior = (c_minus < big) & (c_plus < big)   # band-border fallback
        out = jnp.where(any_valid & interior,
                        out + offset, out).astype(jnp.float32)
    if not return_best_cost:
        return out
    worst = jnp.int32(window_size * window_size)
    return out, jnp.where(any_valid, jnp.minimum(best_cost, worst), worst)


class PyramidPipeline:
    """Coarse-to-fine census pipeline: SGM at 1/2^levels resolution and
    disparity range, then census band refinement up to full resolution.

    Drop-in ``estimate(left, right) -> [H, W] int32`` like
    :class:`~stereomatch_tpu.pipeline.Pipeline`.  Images whose sides are
    not divisible by 2**levels are edge-padded (bottom/right) before the
    pyramid and cropped after, so any geometry works — including the
    odd-height Middlebury frames.

    Args:
      max_disparity: full-resolution disparity range (divisible by
        2**levels).
      levels: number of halvings before the full pipeline runs.
      band_radius: half-width of the per-pixel refinement band at each
        finer level.
      window_size: census window at every level.
      penalty1/penalty2: SGM penalties at the coarse level (applied to
        the coarse Hamming costs).
      backend: 'auto' | 'cuda' | 'xla' for the coarse SGM.
    """

    def __init__(self, max_disparity: int, *, levels: int = 1,
                 band_radius: int = 24, window_size: int = 5,
                 band_kernel_size: int = 5,
                 penalty1: float = 0.1, penalty2: float = 0.2,
                 cost_dtype=jnp.float32,
                 median: bool = True,
                 backend: str = "auto"):
        if levels < 1:
            raise ValueError("levels must be >= 1")
        if max_disparity % (2 ** levels):
            raise ValueError(f"max_disparity {max_disparity} not divisible "
                             f"by 2**levels = {2 ** levels}")
        self.max_disparity = max_disparity
        self.levels = levels
        self.band_radius = band_radius
        self.window_size = window_size
        self.band_kernel_size = band_kernel_size
        self.penalty1 = penalty1
        self.penalty2 = penalty2
        self.cost_dtype = cost_dtype
        self.median = median
        self.backend = resolve_backend(backend)
        self._fn = jax.jit(lambda l, r: self._estimate(l, r, False))
        self._fn_subpixel = jax.jit(lambda l, r: self._estimate(l, r, True))

    def _estimate(self, left, right, subpixel=False):
        height, width = left.shape
        scale = 2 ** self.levels
        pad_h = (-height) % scale
        pad_w = (-width) % scale
        left = left.astype(jnp.float32)
        right = right.astype(jnp.float32)
        if pad_h or pad_w:
            left = jnp.pad(left, ((0, pad_h), (0, pad_w)), mode="edge")
            right = jnp.pad(right, ((0, pad_h), (0, pad_w)), mode="edge")

        pyr = [(left, right)]
        for _ in range(self.levels):
            l, r = pyr[-1]
            pyr.append((downsample2(l), downsample2(r)))

        coarse_l, coarse_r = pyr[-1]
        d_coarse = self.max_disparity // (2 ** self.levels)
        vol = census_hamming_cost_volume(
            coarse_l, coarse_r, max_disparity=d_coarse,
            window_size=self.window_size, cost_dtype=self.cost_dtype)
        agg = semiglobal_fn(self.backend)(vol, coarse_l,
                                          penalty1=self.penalty1,
                                          penalty2=self.penalty2)
        disp = winner_takes_all(agg)

        for level in range(self.levels - 1, -1, -1):
            fine_l, fine_r = pyr[level]
            d_level = self.max_disparity // (2 ** level)
            disp = band_refine_census(
                fine_l, fine_r, upsample2_nearest(disp),
                band_radius=self.band_radius, max_disparity=d_level,
                window_size=self.window_size,
                band_kernel_size=self.band_kernel_size,
                subpixel=subpixel and level == 0)
            if self.median:
                # The pixelwise band WTA has no smoothing term; a 3x3
                # median kills its speckle before it propagates to the
                # next level's band anchors (measured: ~40% of the
                # pyramid's accuracy gap closed per level).
                from .ops.refine import median_filter_3x3
                disp = median_filter_3x3(disp)
        return disp[:height, :width]

    def estimate(self, left_image, right_image) -> jnp.ndarray:
        left_image = jnp.asarray(left_image)
        right_image = jnp.asarray(right_image)
        validation.check_stereo_pair(left_image, right_image)
        return self._fn(left_image, right_image)

    def estimate_refined(self, left_image, right_image, *,
                         subpixel: bool = True,
                         median: bool = True) -> jnp.ndarray:
        """Estimate with parabolic sub-pixel output (float32).

        The sub-pixel vertex is computed *inside* the final band scan
        from the winner's carried neighbour costs (no cost volume
        exists to gather from), then median-filtered; matching
        `Pipeline.estimate_refined`'s flag surface, ``median`` is a
        no-op here when the pipeline was built with ``median=True``
        (every level is already filtered).
        """
        del median                    # levels are median-filtered already
        left_image = jnp.asarray(left_image)
        right_image = jnp.asarray(right_image)
        validation.check_stereo_pair(left_image, right_image)
        fn = self._fn_subpixel if subpixel else self._fn
        return fn(left_image, right_image)
