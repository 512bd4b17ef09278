"""Row-sharded coarse-to-fine pyramid over a (batch, tile) mesh.

Mesh counterpart of :class:`stereomatch_tpu.pyramid.PyramidPipeline` —
no reference analogue at either level (SURVEY.md §2: the reference is
single-GPU and always full-range/full-resolution).

Every pyramid stage maps onto the row-sharding machinery the main
pipeline already uses (parallel/sharded.py):

* 2x2 mean pooling and nearest upsampling never split a row pair when
  the per-tile height is divisible by 2**levels — purely local.
* The coarse census volume reuses ``_local_census`` (±window//2 image
  row halos; ppermute's zero fill at ring ends IS the census
  out-of-image convention).
* The coarse SGM reuses the sharded sweeps — exact carry hand-off or
  overlap warm-up, on the XLA scans or the Hopper kernel.
* The band refinement is row-local along W/D by construction (that is
  why it exists — see pyramid.py), needing only census-window image
  halos; anchor values in halo rows are irrelevant because halo outputs
  are discarded.
* The inter-level 3x3 median pulls one disparity row from each
  neighbor; ring ends replicate the local edge row, matching the
  single-chip ``mode="edge"`` padding — so ``sgm_mode="exact"`` is
  bit-exact against the single-chip pyramid (tests/test_parallel.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.disparity import winner_takes_all
from ..pyramid import band_refine_census, downsample2, upsample2_nearest
from ..utils.backend import resolve_backend
from . import halo
from .mesh import BATCH_AXIS, TILE_AXIS
from .sharded import (_local_census, _median3x3_rows, _speckle_rows,
                      sharded_semiglobal)


def _band_sharded(left, right, predicted, *, band_radius, max_disparity,
                  window_size, axis_name, band_kernel_size=1,
                  subpixel=False, return_best_cost=False):
    """Band refinement under row sharding: census needs ±window//2 image
    rows, and the windowed-Hamming option (band_kernel_size > 1) another
    ±k//2 rows of ham planes on top; the scan itself is row-local.
    Halo-row outputs (computed from zero-filled anchors) are cropped
    away.  Rows past the TRUE image edge (ppermute zero fill at ring
    ends) are flagged via ``row_valid`` so the box pass treats them as
    the single-chip zero padding — interior tile-halo rows carry real
    exchanged data and stay live.
    """
    h = window_size // 2 + band_kernel_size // 2
    hl = left.shape[1]
    lpad = halo.pad_with_halos(left, h, h, axis=1, axis_name=axis_name)
    rpad = halo.pad_with_halos(right, h, h, axis=1, axis_name=axis_name)
    ppad = jnp.pad(predicted, ((0, 0), (h, h), (0, 0)))
    if band_kernel_size > 1:
        idx = lax.axis_index(axis_name)
        n_tiles = lax.axis_size(axis_name)
        rows = jnp.arange(hl + 2 * h) + idx * hl - h
        row_valid = (rows >= 0) & (rows < n_tiles * hl)
    else:
        row_valid = None

    def one(lp, rp, pp):
        out = band_refine_census(lp, rp, pp, band_radius=band_radius,
                                 max_disparity=max_disparity,
                                 window_size=window_size,
                                 band_kernel_size=band_kernel_size,
                                 row_valid=row_valid, subpixel=subpixel,
                                 return_best_cost=return_best_cost)
        if return_best_cost:
            disp, best = out
            return disp[h:disp.shape[0] - h], best[h:best.shape[0] - h]
        return out[h:out.shape[0] - h]

    return jax.vmap(one)(lpad, rpad, ppad)


def make_pyramid_sharded_estimate(mesh, *, max_disparity: int,
                                  levels: int = 1,
                                  band_radius: int = 24,
                                  window_size: int = 5,
                                  band_kernel_size: int = 5,
                                  cost_dtype=jnp.float32,
                                  penalty1: float = 0.1,
                                  penalty2: float = 0.2,
                                  sgm_mode: str = "exact",
                                  overlap: int = 64,
                                  backend: str = "auto",
                                  subpixel: bool = False,
                                  median: bool = True,
                                  speckle: bool = False,
                                  speckle_fill: str = "zero"):
    """Compile the coarse-to-fine pyramid over a (batch, tile) mesh.

    Returns a jitted ``fn(left, right) -> disparity`` over batched
    stacks [B, H, W] with B divisible by the batch axis and H by
    ``tile_axis * 2**levels`` (pooling must not split a row pair at a
    tile boundary).  One XLA program end to end.

    ``subpixel``/``median`` mirror the single-chip pipeline's
    ``estimate_refined``/``median`` surface: parabolic sub-pixel output
    (float32) from the final band scan, and the inter-level 3x3 median.
    """
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if max_disparity % (2 ** levels):
        raise ValueError(f"max_disparity {max_disparity} not divisible "
                         f"by 2**levels = {2 ** levels}")
    n_tiles = mesh.shape[TILE_AXIS]
    backend = resolve_backend(backend)
    d_coarse = max_disparity // (2 ** levels)

    def local_fn(left, right):                     # [B_loc, Hl, W]
        left = left.astype(jnp.float32)
        right = right.astype(jnp.float32)
        pyr = [(left, right)]
        for _ in range(levels):
            l, r = pyr[-1]
            pyr.append((jax.vmap(downsample2)(l), jax.vmap(downsample2)(r)))

        coarse_l, coarse_r = pyr[-1]
        vol = _local_census(coarse_l, coarse_r, max_disparity=d_coarse,
                            window_size=window_size, cost_dtype=cost_dtype)
        agg = sharded_semiglobal(vol, coarse_l, penalty1=penalty1,
                                 penalty2=penalty2, axis_name=TILE_AXIS,
                                 n_tiles=n_tiles, mode=sgm_mode,
                                 overlap=overlap, backend=backend)
        disp = jax.vmap(winner_takes_all.__wrapped__)(agg)

        for level in range(levels - 1, -1, -1):
            fine_l, fine_r = pyr[level]
            d_level = max_disparity // (2 ** level)
            disp = _band_sharded(fine_l, fine_r,
                                 jax.vmap(upsample2_nearest)(disp),
                                 band_radius=band_radius,
                                 max_disparity=d_level,
                                 window_size=window_size,
                                 band_kernel_size=band_kernel_size,
                                 axis_name=TILE_AXIS,
                                 subpixel=subpixel and level == 0)
            if median:
                disp = _median3x3_rows(disp, axis_name=TILE_AXIS,
                                       n_tiles=n_tiles)
        if speckle:
            disp = _speckle_rows(disp, max_diff=1.0, window=9,
                                 min_frac=0.25, fill=speckle_fill,
                                 axis_name=TILE_AXIS, n_tiles=n_tiles)
        return disp

    spec = P(BATCH_AXIS, TILE_AXIS, None)
    mapped = shard_map(local_fn, mesh=mesh, in_specs=(spec, spec),
                       out_specs=spec)
    sharding = NamedSharding(mesh, spec)
    return jax.jit(mapped, in_shardings=(sharding, sharding),
                   out_shardings=sharding)
