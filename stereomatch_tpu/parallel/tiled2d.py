"""Full 2-D image tiling: (batch, tile, tile_w) mesh execution.

Completes the image-tile partitioning picture (SURVEY.md §7's
(tiles_h, tiles_w) axes): rows shard over ``tile`` and columns over
``tile_w``, so a pod slice can hold images whose [H, W, D] volume dwarfs
one chip.

The key simplification: instead of per-direction scan splitting (the 1-D
machinery in ``sharded.py``), every tile extends itself by ``overlap``
pixels on ALL four sides — two ppermute rounds: row halos along ``tile``,
then column halos of the row-extended block along ``tile_w``, which carries
the corners automatically — and runs the plain single-chip 8-direction
aggregation on the extended tile, cropping the center afterwards.  Every
one of the eight traversals finds its upstream warm-up region in the halo
(horizontal sweeps in the side columns, vertical in the top/bottom rows,
diagonals in the corners).  ppermute's zero fill at true image edges is
the SGM recurrence identity (prev == 0 -> band == 0 -> L = C), so tiles
bordering the image are exact on that side; interior accuracy converges
geometrically in ``overlap`` exactly as in the 1-D overlap mode.

Cost construction gathers the (small) image rows to full width along
``tile_w`` and keeps the existing row-halo logic along ``tile``; the
[H, W, D] volume itself — the object that actually needs sharding — is
never materialized beyond each tile's extended block.

The WTA reducer is pointwise-local.  The DP reducer's backward trace is
global along W (information flows from the last column to the first), so
it has no warm-up form; it runs EXACTLY instead, as a sequential carry
hand-off over ``tile_w``: the forward accumulator [H_loc, D] passes left
to right, the rightmost tile takes the scanline argmin, and the decided
disparity column [H_loc] passes back right to left through the
back-pointer chunks.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import halo
from ..ops.cvf import guided_filter_aggregate
from ..ops.cost import (birchfield_cost_volume, census_hamming_cost_volume,
                        sad_cost_from_padded, ssd_cost_from_padded,
                        zncc_cost_from_padded)
from ..ops.disparity import (dp_backward_chunk, dp_forward_chunk,
                             winner_takes_all)
from ..utils.backend import resolve_backend, semiglobal_fn
from .mesh import BATCH_AXIS, TILE_AXIS

TILE_W_AXIS = "tile_w"


def make_mesh_2d(devices=None, n_batch: int = 1, n_tile: int = 2,
                 n_tile_w: int = 2) -> Mesh:
    """(batch, tile, tile_w) mesh."""
    import numpy as np
    if devices is None:
        devices = jax.devices()
    need = n_batch * n_tile * n_tile_w
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.asarray(devices[:need]).reshape(n_batch, n_tile, n_tile_w)
    return Mesh(grid, (BATCH_AXIS, TILE_AXIS, TILE_W_AXIS))


def _extend(x, ov: int, axis: int, axis_name: str, n: int):
    """Concatenate ov-wide neighbor halos on both sides along ``axis``.

    Zero fill at ring ends (ppermute semantics) — the warm-up identity.
    """
    if ov == 0 or n == 1:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (ov, ov)
        return jnp.pad(x, pad)
    before = lax.ppermute(
        lax.slice_in_dim(x, x.shape[axis] - ov, x.shape[axis], axis=axis),
        axis_name, [(i, i + 1) for i in range(n - 1)])
    after = lax.ppermute(
        lax.slice_in_dim(x, 0, ov, axis=axis),
        axis_name, [(i + 1, i) for i in range(n - 1)])
    return jnp.concatenate([before, x, after], axis=axis)


def _dp_tiled_w(vol, n_tile_w: int):
    """Exact scanline DP with the W axis split over ``tile_w``.

    vol: local [B, Hl, Wl, D] (already aggregated).  Sequential pipeline:
    forward accumulator hand-off left->right, argmin on the rightmost
    tile, back-pointer trace hand-off right->left.
    """
    batch, h_loc, w_loc, max_disp = vol.shape
    vol = vol.astype(jnp.float32)
    rank = lax.axis_index(TILE_W_AXIS)
    fwd_perm = [(i, i + 1) for i in range(n_tile_w - 1)]
    bwd_perm = [(i, i - 1) for i in range(1, n_tile_w)]

    # Forward: a zero accumulator is the seeded start (acc_col0 = cost +
    # min(0,...) = cost); only the pointer column needs the seed override.
    fwd = jax.vmap(lambda v, acc: dp_forward_chunk(v, acc))

    def fstage(s, state):
        acc_in, ptrs, final = state
        seed_acc = jnp.where(rank == 0, jnp.zeros_like(acc_in), acc_in)
        p, f = fwd(vol, seed_acc)
        p = jnp.where((rank == 0)[None],
                      jnp.concatenate([jnp.zeros_like(p[:, :, :1]),
                                       p[:, :, 1:]], axis=2), p)
        mine = rank == s
        ptrs = jnp.where(mine, p, ptrs)
        final = jnp.where(mine, f, final)
        acc = jnp.where(mine, f, acc_in)
        if n_tile_w > 1:
            acc = lax.ppermute(acc, TILE_W_AXIS, fwd_perm)
        return acc, ptrs, final

    init = (jnp.zeros((batch, h_loc, max_disp), jnp.float32),
            jnp.zeros((batch, h_loc, w_loc, max_disp), jnp.int8),
            jnp.zeros((batch, h_loc, max_disp), jnp.float32))
    _, ptrs, final = lax.fori_loop(0, n_tile_w, fstage, init)

    # Backward.  Rightmost tile first: scanline argmin + emit-current walk.
    end = jnp.argmin(final, axis=-1).astype(jnp.int32)       # [B, Hl]
    bwd_emit = jax.vmap(
        lambda p, c: dp_backward_chunk(p, c, emit_current=True))
    bwd_cont = jax.vmap(
        lambda p, c: dp_backward_chunk(p, c, emit_current=False))

    d_last, c_last = bwd_emit(ptrs, end)
    is_last = rank == n_tile_w - 1
    out = jnp.where(is_last[None], d_last, jnp.zeros_like(d_last))
    cur = jnp.where(is_last, c_last, jnp.zeros_like(c_last))
    if n_tile_w > 1:
        cur = lax.ppermute(cur, TILE_W_AXIS, bwd_perm)

        def bstage(s, state):
            cur, out = state
            d_c, c_c = bwd_cont(ptrs, cur)
            mine = rank == n_tile_w - 1 - s
            out = jnp.where(mine, d_c, out)
            cur = jnp.where(mine, c_c, cur)
            cur = lax.ppermute(cur, TILE_W_AXIS, bwd_perm)
            return cur, out

        _, out = lax.fori_loop(1, n_tile_w, bstage, (cur, out))
    return out


def _lr_check_tiled_w(agg, disp, n_tile_w: int, *, max_diff: int):
    """Left-right occlusion handling with the W axis split over tile_w.

    The mirror-image LR mode is W-global (the flip crosses every tile),
    but the volume mode (ops/refine.py::right_volume_from_left) is not:

    * right disparity — C_R[y,x,d] = C_L[y,x+d,d] reaches D-1 columns
      past the tile, one (D-1)-wide volume halo from the right neighbors
      (multi-hop when D-1 exceeds the tile width), +inf-poisoned beyond
      the true image;
    * the consistency test reads dR[y, x - dL] — a (D-1)-wide halo of
      the right disparity map from the left neighbors, poisoned with a
      never-agreeing value beyond the image;
    * the background fill's prefix scans run locally, then a [B, Hl]
      last-valid carry chains across ranks (n_tile_w - 1 ppermute
      rounds, NaN re-seeded at ring ends) — selections only, so the
      stitched result is bit-identical to the single-chip scan.
    """
    from ..ops import refine

    batch, h_loc, w_loc, max_disp = agg.shape
    d_halo = max_disp - 1

    # Right disparity from the re-indexed volume.
    if d_halo:
        ext = jnp.concatenate(
            [agg, halo.pull_from_next_multi(agg, d_halo, 2, TILE_W_AXIS)],
            axis=2)
        oob = halo.out_of_image_mask(TILE_W_AXIS, n_tile_w, w_loc,
                                     0, d_halo)
        ext = jnp.where(oob[None, None, :, None],
                        jnp.asarray(jnp.inf, ext.dtype), ext)
    else:
        ext = agg
    disp_r = jnp.argmin(refine.right_volume_from_padded(ext, width=w_loc),
                        axis=-1).astype(jnp.int32)

    # Consistency: dR[y, x - dL] needs dR columns left of the tile.
    if d_halo:
        padded_r = jnp.concatenate(
            [halo.pull_from_prev_multi(disp_r, d_halo, 2, TILE_W_AXIS),
             disp_r], axis=2)
        oob_l = halo.out_of_image_mask(TILE_W_AXIS, n_tile_w, w_loc,
                                       d_halo, 0)
        padded_r = jnp.where(oob_l[None, None, :],
                             -jnp.int32(1 << 20), padded_r)
    else:
        padded_r = disp_r
    valid = refine.consistency_from_padded(disp, padded_r, pad=d_halo,
                                           n_planes=max_disp,
                                           max_diff=max_diff)

    return _fill_inconsistent_tiled_w(disp, valid, n_tile_w)


def _fill_inconsistent_tiled_w(disp, valid, n_tile_w: int):
    """Background (min-side) occlusion fill with the scanline prefix scans
    stitched across ``tile_w`` ranks: each tile scans locally (NaN until
    its first valid pixel), then a [B, Hl] last-valid carry chains
    through n_tile_w - 1 ppermute rounds and replaces the NaN prefixes.
    Selections only — bit-identical to ops.refine.fill_inconsistent on
    the assembled image.  Shared by the LR check and the background
    speckle fill."""
    from ..ops import refine

    rank = lax.axis_index(TILE_W_AXIS)
    d_f = disp.astype(jnp.float32)

    def chained_fill(vals, ok, perm, seed_rank):
        out = refine.propagate_last_valid(vals, ok)     # NaN until 1st valid
        own_last = out[..., -1]
        any_valid = jnp.any(ok, axis=-1)
        carry = jnp.full_like(own_last, jnp.nan)
        for _ in range(n_tile_w - 1):
            outgoing = jnp.where(any_valid, own_last, carry)
            carry = lax.ppermute(outgoing, TILE_W_AXIS, perm)
            # ppermute zero-fills the ring end; 0.0 would read as a real
            # fill value, so re-seed "nothing yet" there.
            carry = jnp.where(rank == seed_rank,
                              jnp.full_like(carry, jnp.nan), carry)
        return jnp.where(jnp.isnan(out), carry[..., None], out)

    left_fill = chained_fill(
        d_f, valid, [(i, i + 1) for i in range(n_tile_w - 1)], 0)
    right_fill = chained_fill(
        d_f[..., ::-1], valid[..., ::-1],
        [(i + 1, i) for i in range(n_tile_w - 1)],
        n_tile_w - 1)[..., ::-1]

    fill = jnp.fmin(left_fill, right_fill)
    filled = jnp.where(valid, d_f, fill)
    return jnp.where(jnp.isnan(filled), d_f, filled)


def _median3x3_tiled(disp, n_tile: int, n_tile_w: int):
    """3x3 median under 2-D tiling: one halo row/column per neighbor in
    each axis (the W halos of the row-extended block carry the corners);
    ring ends replicate the local edge, matching the single-chip
    ``mode="edge"`` padding."""
    x = disp.astype(jnp.float32)
    top = halo.pull_from_prev(x, 1, 1, TILE_AXIS)
    bottom = halo.pull_from_next(x, 1, 1, TILE_AXIS)
    rh = lax.axis_index(TILE_AXIS)
    top = jnp.where(rh == 0, x[:, :1], top)
    bottom = jnp.where(rh == n_tile - 1, x[:, -1:], bottom)
    x = jnp.concatenate([top, x, bottom], axis=1)
    left_c = halo.pull_from_prev(x, 1, 2, TILE_W_AXIS)
    right_c = halo.pull_from_next(x, 1, 2, TILE_W_AXIS)
    rw = lax.axis_index(TILE_W_AXIS)
    left_c = jnp.where(rw == 0, x[:, :, :1], left_c)
    right_c = jnp.where(rw == n_tile_w - 1, x[:, :, -1:], right_c)
    x = jnp.concatenate([left_c, x, right_c], axis=2)
    hl, wl = disp.shape[1], disp.shape[2]
    planes = [x[:, dy:dy + hl, dx:dx + wl]
              for dy in range(3) for dx in range(3)]
    return jnp.sort(jnp.stack(planes, axis=-1),
                    axis=-1)[..., 4].astype(disp.dtype)


def _wmf_tiled(disp, guide, n_tile: int, n_tile_w: int, *, window: int,
               sigma: float, n_bins: int):
    """Guide-weighted median under 2-D tiling: window//2 halos of the
    disparity bins and the guide per axis, ring-end guide halos +inf
    (zero affinity = the single-chip out-of-image convention).
    Bit-identical to ops.refine.weighted_median_filter."""
    from ..ops import refine

    r = window // 2
    bins = jnp.clip(jnp.round(disp.astype(jnp.float32)),
                    0, n_bins - 1).astype(jnp.int32)
    g = guide.astype(jnp.float32)
    inf = jnp.float32(jnp.inf)

    def pad2d(x, ring_fill):
        rh = lax.axis_index(TILE_AXIS)
        top = halo.pull_from_prev(x, r, 1, TILE_AXIS)
        bottom = halo.pull_from_next(x, r, 1, TILE_AXIS)
        if ring_fill is not None:
            top = jnp.where(rh == 0, ring_fill, top)
            bottom = jnp.where(rh == n_tile - 1, ring_fill, bottom)
        x = jnp.concatenate([top, x, bottom], axis=1)
        rw = lax.axis_index(TILE_W_AXIS)
        left_c = halo.pull_from_prev(x, r, 2, TILE_W_AXIS)
        right_c = halo.pull_from_next(x, r, 2, TILE_W_AXIS)
        if ring_fill is not None:
            left_c = jnp.where(rw == 0, ring_fill, left_c)
            right_c = jnp.where(rw == n_tile_w - 1, ring_fill, right_c)
        return jnp.concatenate([left_c, x, right_c], axis=2)

    b_pad = pad2d(bins, None)                 # bins beyond image: weight 0
    g_pad = pad2d(g, inf)
    out = jax.vmap(functools.partial(refine._wmf_from_padded,
                                     window=window, sigma=sigma,
                                     n_bins=n_bins))(b_pad, g_pad, g)
    return out.astype(disp.dtype)


def _speckle_tiled(disp, n_tile: int, n_tile_w: int, *, window: int = 9,
                   max_diff: float = 1.0, min_frac: float = 0.25,
                   fill: str = "zero"):
    """Windowed-support speckle suppression under 2-D tiling: window//2
    disparity halos per axis with NaN ring ends (the single-chip
    out-of-image convention).  ``fill="zero"`` writes 0 for masked
    pixels; ``fill="background"`` extends the nearest supported
    disparity along the scanline via the cross-rank stitched scans
    (:func:`_fill_inconsistent_tiled_w`)."""
    from ..ops import refine

    r = window // 2
    d = disp.astype(jnp.float32)
    nan = jnp.float32(jnp.nan)
    top = halo.pull_from_prev(d, r, 1, TILE_AXIS)
    bottom = halo.pull_from_next(d, r, 1, TILE_AXIS)
    rh = lax.axis_index(TILE_AXIS)
    top = jnp.where(rh == 0, nan, top)
    bottom = jnp.where(rh == n_tile - 1, nan, bottom)
    x = jnp.concatenate([top, d, bottom], axis=1)
    left_c = halo.pull_from_prev(x, r, 2, TILE_W_AXIS)
    right_c = halo.pull_from_next(x, r, 2, TILE_W_AXIS)
    rw = lax.axis_index(TILE_W_AXIS)
    left_c = jnp.where(rw == 0, nan, left_c)
    right_c = jnp.where(rw == n_tile_w - 1, nan, right_c)
    padded = jnp.concatenate([left_c, x, right_c], axis=2)
    mask = jax.vmap(functools.partial(
        refine._windowed_support, max_diff=max_diff, window=window,
        min_frac=min_frac))(padded, d)
    if fill == "background":
        return _fill_inconsistent_tiled_w(disp, mask, n_tile_w)
    return jnp.where(mask, disp, jnp.zeros((), disp.dtype))


def make_tiled2d_estimate(mesh: Mesh, *, max_disparity: int,
                          cost: str = "ssd",
                          kernel_size: Optional[int] = None,
                          census_window: int = 5,
                          reducer: str = "wta",
                          aggregation: Optional[str] = "sgm",
                          penalty1: float = 0.1, penalty2: float = 0.2,
                          cvf_radius: int = 8, cvf_eps: float = 1e-4,
                          overlap: int = 48,
                          backend: str = "auto",
                          median: bool = False,
                          subpixel: bool = False,
                          lr_check: bool = False,
                          lr_mode: str = "volume",
                          lr_max_diff: int = 1,
                          weighted_median: bool = False,
                          wmf_sigma: float = 10.0,
                          wmf_window: int = 5,
                          min_confidence: Optional[float] = None,
                          speckle: bool = False,
                          speckle_fill: str = "zero") -> Callable:
    """Compile cost + aggregation + reduce over a 2-D tile mesh.

    ``aggregation``: "sgm" (8-path semiglobal on the overlap-extended
    tile — approximate, warm-up quality governed by ``overlap``), "cvf"
    (guided cost-volume filtering — EXACT under tiling, finite support
    pulled as 2*cvf_radius halos), or None (raw cost volume).

    Returns jitted ``fn(left, right) -> disparity`` over [B, H, W] stacks
    with B, H, W divisible by the batch/tile/tile_w axes respectively.

    ``median``/``subpixel``/``min_confidence``/``speckle`` mirror the
    row-sharded pipeline's post-processing (parallel/sharded.py) with
    2-D halos where a window crosses tiles.  ``lr_check`` supports
    ``lr_mode="volume"`` only (the re-indexed right disparity needs just
    a (D-1)-wide volume halo and the fill a tiny cross-rank carry chain
    — see ``_lr_check_tiled_w``; the mirror run's W flip crosses every
    tile and remains row-sharded-only).  ``speckle_fill`` supports both
    "zero" and "background" (the latter reuses the LR fill's cross-rank
    scan stitching).
    """
    # "ssd-texture" = texture sampler (identity over integer pixel centres
    # under nearest/unnormalized) into float32 SSD — same compute here,
    # where inputs arrive as arrays and the cost dtype is already float32.
    if cost not in ("ssd", "ssd-texture", "birchfield", "census", "sad",
                    "ncc"):
        raise ValueError(f"unknown cost {cost!r}")
    if reducer not in ("wta", "dynamic_programming"):
        raise ValueError(f"unknown reducer {reducer!r}")
    if aggregation not in (None, "sgm", "cvf"):
        raise ValueError(f"unknown aggregation {aggregation!r}")
    if speckle_fill not in ("zero", "background"):
        raise ValueError(f"unknown fill mode: {speckle_fill!r}")
    if lr_check and lr_mode != "volume":
        raise ValueError(
            f"2-D tiling supports lr_mode='volume' only (got {lr_mode!r}): "
            "the mirror run's W flip crosses every tile_w shard; use the "
            "row-sharded pipeline for lr_mode='mirror'")
    if kernel_size is None:
        kernel_size = 4 if cost == "birchfield" else 7
    if cost == "census":
        # kernel_size only sizes the image-row extension here; the census
        # window needs at least window//2 halo rows.
        kernel_size = max(kernel_size, census_window // 2)
    n_tile = mesh.shape[TILE_AXIS]
    n_tile_w = mesh.shape[TILE_W_AXIS]
    backend = resolve_backend(backend)

    p1, p2 = float(penalty1), float(penalty2)

    def aggregate(vol, img):
        return semiglobal_fn(backend)(vol, img, penalty1=p1, penalty2=p2)

    def local_fn(left, right):                   # [B_loc, Hl, Wl]
        left = left.astype(jnp.float32)
        right = right.astype(jnp.float32)
        batch, h_loc, w_loc = left.shape

        # Cost: gather image rows to full width (images are tiny against
        # the volume), add the H-halo rows for the window, compute, then
        # keep this tile's column range.
        k = kernel_size
        left_full = jax.lax.all_gather(left, TILE_W_AXIS, axis=2,
                                       tiled=True)
        right_full = jax.lax.all_gather(right, TILE_W_AXIS, axis=2,
                                        tiled=True)
        left_ext = _extend(left_full, k, 1, TILE_AXIS, n_tile)
        right_ext = _extend(right_full, k, 1, TILE_AXIS, n_tile)
        w0 = lax.axis_index(TILE_W_AXIS) * w_loc

        # The SSD row window is [r-k, r+k): k halo rows above, k-1 below
        # (ssd_cost_from_padded semantics — zero halos at the true image
        # top/bottom are the additive identity of the clipped window).
        # Birchfield's window is scanline-local: the halo rows just drop.
        # ZNCC's window count must exclude halo rows beyond the true image
        # (zero fill is the additive identity for its sums, not its count).
        row_valid = ~halo.out_of_image_mask(TILE_AXIS, n_tile, h_loc,
                                            k, k - 1)

        if cost == "ncc":
            # Bit-equal centering needs GLOBAL geometry (see _local_zncc
            # in sharded.py): per-row sums all-gathered over the
            # row-tile axis, every chip re-reducing the identical [H]
            # vector.
            from ..ops.cost import pairwise_sum_last
            h_glob = n_tile * h_loc
            w_glob = left_full.shape[2]
            rs_l = jax.lax.all_gather(pairwise_sum_last(left_full),
                                      TILE_AXIS, axis=1, tiled=True)
            rs_r = jax.lax.all_gather(pairwise_sum_last(right_full),
                                      TILE_AXIS, axis=1, tiled=True)
            ncc_mean_l = pairwise_sum_last(rs_l) / (h_glob * w_glob)
            ncc_mean_r = pairwise_sum_last(rs_r) / (h_glob * w_glob)
        else:
            ncc_mean_l = ncc_mean_r = jnp.zeros((batch,), jnp.float32)

        def cost_one_padded(le, re, ncc_ml, ncc_mr):
            if cost in ("ssd", "ssd-texture"):
                vol = ssd_cost_from_padded(
                    le[:-1], re[:-1], pad_before=k, pad_after=k - 1,
                    max_disparity=max_disparity, kernel_size=kernel_size)
            elif cost == "sad":
                vol = sad_cost_from_padded(
                    le[:-1], re[:-1], pad_before=k, pad_after=k - 1,
                    max_disparity=max_disparity, kernel_size=kernel_size)
            elif cost == "ncc":
                vol = zncc_cost_from_padded(
                    le[:-1], re[:-1], pad_before=k, pad_after=k - 1,
                    max_disparity=max_disparity, kernel_size=kernel_size,
                    row_valid=row_valid, left_mean=ncc_ml,
                    right_mean=ncc_mr)
            elif cost == "census":
                # Census needs window//2 halo rows; slice them out of
                # the k-row extension (zero fill at true image edges is
                # the transform's out-of-image convention) and crop after.
                h2 = census_window // 2
                lc = le[k - h2:le.shape[0] - (k - h2)]
                rc = re[k - h2:re.shape[0] - (k - h2)]
                vol = census_hamming_cost_volume.__wrapped__(
                    lc, rc, max_disparity=max_disparity,
                    window_size=census_window)[h2:-h2]
            else:
                vol = birchfield_cost_volume.__wrapped__(
                    le[k:le.shape[0] - k], re[k:re.shape[0] - k],
                    max_disparity=max_disparity, kernel_size=kernel_size)
            return lax.dynamic_slice_in_dim(vol, w0, w_loc, axis=1)

        vol = jax.vmap(cost_one_padded)(left_ext, right_ext,
                                        ncc_mean_l, ncc_mean_r)

        if aggregation == "sgm":
            # 8-neighborhood halo extension of the volume + image, then
            # the plain single-chip aggregation on the extended tile.
            ov_h = min(overlap, h_loc)
            ov_w = min(overlap, w_loc)
            ext = _extend(vol, ov_h, 1, TILE_AXIS, n_tile)
            ext = _extend(ext, ov_w, 2, TILE_W_AXIS, n_tile_w)
            img_e = _extend(left, ov_h, 1, TILE_AXIS, n_tile)
            img_e = _extend(img_e, ov_w, 2, TILE_W_AXIS, n_tile_w)

            agg = jax.vmap(aggregate)(ext, img_e)
            agg = agg[:, ov_h:ov_h + h_loc, ov_w:ov_w + w_loc]
        elif aggregation == "cvf":
            # Guided cost-volume filtering has finite support (both box
            # stages reach 2*radius), so unlike the SGM overlap warm-up
            # the 2-D halo extension here is EXACT, not approximate.
            # Out-of-image halo rows/columns (ppermute zero fill at the
            # mesh edges) are +inf-poisoned so the filter's validity
            # mask excludes them — matching the single-chip clipped
            # window counts bit-for-bit (same trick as _local_cvf under
            # row sharding).
            ov = 2 * cvf_radius
            if ov > h_loc or ov > w_loc:
                raise ValueError(
                    f"cvf radius {cvf_radius} needs {ov} halo rows/cols "
                    f"but tiles are {h_loc}x{w_loc}; use fewer tiles or "
                    f"a smaller radius")
            ext = _extend(vol, ov, 1, TILE_AXIS, n_tile)
            ext = _extend(ext, ov, 2, TILE_W_AXIS, n_tile_w)
            img_e = _extend(left, ov, 1, TILE_AXIS, n_tile)
            img_e = _extend(img_e, ov, 2, TILE_W_AXIS, n_tile_w)
            oob = (halo.out_of_image_mask(TILE_AXIS, n_tile,
                                          h_loc, ov)[:, None]
                   | halo.out_of_image_mask(TILE_W_AXIS, n_tile_w,
                                            w_loc, ov)[None, :])
            ext = jnp.where(oob[None, :, :, None],
                            jnp.asarray(jnp.inf, ext.dtype), ext)
            agg = jax.vmap(lambda v, g: guided_filter_aggregate(
                v, g, radius=cvf_radius, eps=cvf_eps))(ext, img_e)
            agg = agg[:, ov:ov + h_loc, ov:ov + w_loc]
        else:
            agg = vol
        if reducer == "dynamic_programming":
            disp = _dp_tiled_w(agg, n_tile_w)
        else:
            disp = jax.vmap(winner_takes_all.__wrapped__)(agg)
        if lr_check:
            disp = _lr_check_tiled_w(agg, disp, n_tile_w,
                                     max_diff=lr_max_diff)
        if weighted_median:
            disp = _wmf_tiled(disp, left, n_tile, n_tile_w,
                              window=wmf_window, sigma=wmf_sigma,
                              n_bins=max_disparity)
        if median:
            disp = _median3x3_tiled(disp, n_tile, n_tile_w)
        if subpixel:
            from ..ops import refine
            idx = jnp.clip(jnp.round(disp), 0,
                           max_disparity - 1).astype(jnp.int32)
            disp = jax.vmap(refine.subpixel_refine.__wrapped__)(agg, idx)
        if min_confidence is not None:
            from ..ops import refine
            conf = jax.vmap(refine.confidence_pkrn.__wrapped__)(agg)
            disp = jnp.where(conf >= min_confidence,
                             disp, jnp.zeros((), disp.dtype))
        if speckle:
            disp = _speckle_tiled(disp, n_tile, n_tile_w,
                                  fill=speckle_fill)
        return disp

    spec = P(BATCH_AXIS, TILE_AXIS, TILE_W_AXIS)
    mapped = shard_map(local_fn, mesh=mesh, in_specs=(spec, spec),
                      out_specs=spec, check_vma=False)
    sharding = NamedSharding(mesh, spec)

    n_batch = mesh.shape[BATCH_AXIS]

    def fn(left, right):
        left = jnp.asarray(left)
        right = jnp.asarray(right)
        b, h, w = left.shape
        if b % n_batch or h % n_tile or w % n_tile_w:
            raise ValueError(
                f"batch/height/width {left.shape} not divisible by mesh "
                f"axes {(n_batch, n_tile, n_tile_w)}")
        left = jax.device_put(left, sharding)
        right = jax.device_put(right, sharding)
        return mapped(left, right)

    return jax.jit(fn)
